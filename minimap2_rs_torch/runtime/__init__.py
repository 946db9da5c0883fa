from .host import native_available, native_backtrack, native_chain_dp, native_sketch  # noqa: F401
