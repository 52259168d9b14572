"""Per-slice operators of the port (counterparts of evflow_tpu.ops)."""
