"""Graph substrate: generators, padding, degrees."""
from repro_torch.graph.generators import (
    erdos_renyi,
    grid_mesh,
    planted_partition,
    powerlaw_graph,
)
from repro_torch.graph.utils import degrees, mode_degree, pad_edges

__all__ = ["degrees", "erdos_renyi", "grid_mesh", "mode_degree", "pad_edges",
           "planted_partition", "powerlaw_graph"]
