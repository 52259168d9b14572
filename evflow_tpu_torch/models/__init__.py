"""Models and pipelines of the port (counterparts of evflow_tpu.models)."""
