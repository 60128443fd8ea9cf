"""The paper's own workload as a dry-run cell: BigGraphVis at the scale of
its largest graphs (Table 1): soc-LiveJournal (4.0 M nodes, 34.7 M edges)
and web-BerkStan (0.69 M, 6.6 M), plus the supergraph layout at the
paper's supernode counts.

Two step kinds (``launch.steps.build_bgv_step``):
  * detect — one SCoDA streaming round in one block plus the CMS sizing
             sketch (kernel K8's keys-in entry on the card);
  * layout — one ForceAtlas2 iteration on the supergraph. The repulsion
             backend is ``BGVDryConfig.layout_repulsion``: "exact" (K2) for
             supergraph shapes, the default, or "grid" (K5–K7) when a cell
             lays out a full graph at paper scale.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, ShapeSpec, pad_to


@dataclass(frozen=True)
class BGVDryConfig:
    name: str = "biggraphvis"
    rounds_per_step: int = 1
    cms_rows: int = 4
    # FA2 repulsion backend of the layout cells: "exact" pairwise for
    # supergraph shapes, "grid"/"grid_pallas" for full-graph shapes.
    layout_repulsion: str = "exact"
    layout_grid_size: int = 64
    layout_grid_window: int = 32


def biggraphvis() -> ArchConfig:
    shapes = {
        "detect_livejournal": ShapeSpec(
            "detect_livejournal", "bgv_detect",
            n_nodes=pad_to(3_997_962, 512), n_edges=pad_to(34_681_189, 512),
            n_out=pad_to(34_500, 512),  # CMS cols (paper Table 1)
        ),
        "detect_berkstan": ShapeSpec(
            "detect_berkstan", "bgv_detect",
            n_nodes=pad_to(685_230, 512), n_edges=pad_to(6_649_470, 512),
            n_out=pad_to(6_500, 512),
        ),
        "layout_livejournal": ShapeSpec(
            "layout_livejournal", "bgv_layout",
            # paper Table 1: 248,188 supernodes / 566,160 superedges
            n_nodes=pad_to(248_188, 512), n_edges=pad_to(566_160, 512),
        ),
        "layout_berkstan": ShapeSpec(
            "layout_berkstan", "bgv_layout",
            n_nodes=pad_to(31_213, 512), n_edges=pad_to(57_382, 512),
        ),
    }
    return ArchConfig(name="biggraphvis", family="bgv", profile="gnn",
                      model=BGVDryConfig(), shapes=shapes)
