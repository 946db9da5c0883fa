"""Multi-GPU mapping over torch.distributed: the mesh of ranks, the
hash-range-sharded index and the mapping steps."""
