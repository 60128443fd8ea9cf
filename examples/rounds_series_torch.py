"""Paper Figs. 8/9 analogue on PyTorch/CUDA: the effect of hierarchical
detection rounds on the supergraph layout — writes rounds_<r>_torch.svg for
r in {1, 2, 3, 4} so the merging of communities is visible as in the
paper's series, with the port (``src/repro_torch``);
``examples/rounds_series.py`` is the reference package's version.

    PYTHONPATH=src python examples/rounds_series_torch.py               # on the GPU
    PYTHONPATH=src python examples/rounds_series_torch.py --device cpu  # plain versions
"""
import argparse
import os
import sys
from dataclasses import replace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch import biggraphvis, default_config
from repro_torch.core.coloring import write_svg
from repro_torch.graph import mode_degree, planted_partition


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the plain PyTorch versions)")
    ap.add_argument("--out", default=os.path.dirname(os.path.abspath(__file__)),
                    help="directory for the SVGs (default: beside this script)")
    args = ap.parse_args(argv)

    n = 2500
    edges, _ = planted_partition(n, 25, 0.2, 0.001, seed=7)
    delta = mode_degree(edges, n)
    base = default_config(n, len(edges), delta, rounds=4, iterations=50, s_cap=4096)
    for r in (1, 2, 3, 4):
        cfg = replace(base, scoda=replace(base.scoda, rounds=r))
        res = biggraphvis(edges, n, cfg, device=args.device)
        live = res.sizes > 0
        path = write_svg(os.path.join(args.out, f"rounds_{r}_torch.svg"),
                         res.positions[live],
                         np.sqrt(np.maximum(res.sizes[live], 1.0)),
                         res.groups[live], device=args.device)
        print(f"rounds={r}: SN={res.n_supernodes} SE={res.n_superedges} "
              f"M={res.modularity:.3f} -> {path}")


if __name__ == "__main__":
    main()
