"""Work split over the ranks of a torch.distributed group (counterpart of
evflow_tpu/parallel): `batch`, the row-block batch clustering. The
spatio-temporal tiling (the JAX package's mesh, tiling and temporal
modules) is not ported yet."""
