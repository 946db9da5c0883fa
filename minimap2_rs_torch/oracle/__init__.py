"""Bit-exact scalar/NumPy oracles for every algorithmic contract of the
reference (SURVEY.md section 7 step 1). These are the golden references the
device kernels are fuzzed against, and the guaranteed-parity host path."""

from .sketch import hash64, sketch_sequence, sketch_sequence_fast  # noqa: F401
from .index import OracleIndex, build_index  # noqa: F401
