"""Graph substrate: generators, padding, degrees, CSR, neighbor sampling."""
from repro_torch.graph.generators import (
    batched_molecules,
    erdos_renyi,
    grid_mesh,
    planted_partition,
    powerlaw_graph,
)
from repro_torch.graph.sampling import NeighborSampler, SampledSubgraph
from repro_torch.graph.utils import degrees, mode_degree, pad_edges, to_csr

__all__ = ["NeighborSampler", "SampledSubgraph", "batched_molecules", "degrees",
           "erdos_renyi", "grid_mesh", "mode_degree", "pad_edges", "planted_partition",
           "powerlaw_graph", "to_csr"]
