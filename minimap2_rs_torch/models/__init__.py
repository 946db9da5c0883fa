"""End-to-end pipelines (counterparts of minimap2_rs_tpu.models)."""
