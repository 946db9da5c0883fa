"""Device stages of the mapping pipeline in PyTorch (counterparts of
minimap2_rs_tpu.ops)."""
