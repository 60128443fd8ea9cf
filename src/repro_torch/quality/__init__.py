"""Scalable layout-quality metrics: sampled stress, k-ring neighborhood
preservation (spatial side through the ``kernels/grid`` binning), edge-length
uniformity and a crossing proxy. See ``quality/metrics.py``."""
from repro_torch.quality.metrics import (
    bfs_hops,
    crossing_proxy,
    edge_length_cv,
    layout_quality,
    neighborhood_preservation,
    sampled_stress,
)

__all__ = [
    "bfs_hops",
    "crossing_proxy",
    "edge_length_cv",
    "layout_quality",
    "neighborhood_preservation",
    "sampled_stress",
]
