"""Host utilities of the port (copies of evflow_tpu/utils): PPM images and
the diagnostic plots."""
