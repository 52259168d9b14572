"""Per-slice operators of the port (counterparts of evflow_tpu.ops)."""

from .hash_dedup import DedupResult, dedup, dedup_batched, dedup_sorted, hash_coordinate
from .sae import init_sae, update_sae, last_time, render_time_surface
from .efast import CIRCLE3, CIRCLE4, detect_corners
from .nms import NMSResult, filter_corners
from .distance import (AssignResult, assign_to_centers, pairwise_sqdist,
                       pairwise_manhattan, radius_neighbor_counts, kth_neighbor_dist)
from .segment import (masked_segment_sum, segment_counts, segment_mean_points,
                      compact_by_segment, compact_by_segment_sorted)
