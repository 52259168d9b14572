"""Work split over the ranks of a torch.distributed group (counterpart of
evflow_tpu/parallel): `batch`, the row-block batch clustering; `mesh`, the
rank meshes and their collectives; `tiling` and `temporal`, the
spatio-temporal layer (tiles over one axis, time windows over the other)."""
