"""Host utilities of the port: PPM images, the diagnostic plots, PCD files
and the evaluation metrics (copies of evflow_tpu/utils), and its own
checkpoint (the JAX package's npz format) and profiling helpers."""
