from .packing import (  # noqa: F401
    NT4_TABLE,
    nt4_encode,
    seq4_pack,
    seq4_unpack,
    seq4_get_subseq,
)
