"""Unit ``full_layout``: ``layout(edges, w, mass, n, FA2Config(...))`` over
the whole graph, every edge of weight ``edge_weight`` and every node of
mass degree + 1, with the edges on the device from set-up; the positions
come back to the host. Settings: the mix's ``iterations``, ``repulsion``,
``grid_size``, ``grid_window``, ``use_radii`` and the configuration's
``pipeline`` (start, type, forces).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bgvbench import outputs
from bgvbench.reference import fa2 as ref_fa2
from bgvbench.reference import prng as ref_prng


class Unit:
    kind = "full_layout"

    def __init__(self, program, config: dict, mix: dict, edges: np.ndarray, n: int,
                 seed: int, device):
        p = config["pipeline"]
        self.program, self.config, self.mix = program, config, mix
        self.n = int(n)
        self.edges_np, self.seed, self.device = edges, seed, device
        deg = np.bincount(edges.reshape(-1), minlength=self.n)[:self.n]
        self.mass_np = (deg + 1.0).astype(np.float32)
        self.edges = torch.as_tensor(edges, device=device)
        self.w = torch.full((len(edges),), float(mix["edge_weight"]), dtype=torch.float32,
                            device=device)
        self.mass = torch.as_tensor(self.mass_np, device=device)
        self.cfg = program.FA2Config(
            iterations=mix["iterations"], repulsion=mix["repulsion"],
            grid_size=mix["grid_size"], grid_window=mix["grid_window"],
            use_radii=mix["use_radii"], seed=outputs.layout_seed(seed), init=p["init"],
            dtype=p["dtype"], gravity=p["gravity"], repulsion_k=p["repulsion_k"],
            jitter_tolerance=p["jitter_tolerance"])
        self.last = None

    def shapes(self) -> dict:
        return {"n": self.n, "iterations": self.cfg.iterations,
                "grid_cells": self.cfg.grid_size ** 2}

    def run(self) -> dict:
        self.last = None
        t0 = time.perf_counter()
        pos, trace, iters = self.program.layout(self.edges, self.w, self.mass, self.n,
                                                self.cfg, device=self.device)
        pos_h = pos.float().cpu().numpy()
        trace_h = trace.double().cpu().numpy()
        self.last = (pos_h, trace_h, int(iters))
        return {"layout_s": time.perf_counter() - t0, "iterations": int(iters),
                "digest": outputs.digest(pos_h, trace_h)}

    warm = run

    def release(self):
        self.edges = self.w = self.mass = None

    def reference(self, device, dtype=torch.float32):
        p, mix = self.config["pipeline"], self.mix
        lay = ref_fa2.Layout(torch.as_tensor(self.edges_np, device=device),
                             torch.full((len(self.edges_np),), float(mix["edge_weight"]),
                                        device=device),
                             torch.as_tensor(self.mass_np, device=device), self.n,
                             iterations=mix["iterations"], kr=p["repulsion_k"],
                             kg=p["gravity"], tau=p["jitter_tolerance"],
                             repulsion=mix["repulsion"], use_radii=mix["use_radii"],
                             grid_size=mix["grid_size"], grid_window=mix["grid_window"],
                             dtype=dtype)
        p0 = ref_prng.uniform_f32(outputs.layout_seed(self.seed), (self.n, 2), -1000.0,
                                  1000.0, device)
        pos, trace = lay.run(p0)
        return pos.cpu().numpy(), trace.cpu().numpy()

    def compare(self, digests: list, ref, positions=None, trace=None) -> dict:
        pos, got_trace, iters = self.last
        pos = pos if positions is None else positions
        got_trace = got_trace if trace is None else trace
        ref_pos, ref_trace = ref
        out = {"units_differ": sum(d != digests[-1] for d in digests),
               "iterations": abs(iters - len(ref_trace))}
        out["trace_gap"] = outputs.trace_gap(got_trace, ref_trace, outputs.TRACE_ROWS)
        out["pos_gap"] = outputs.position_gap(pos, ref_pos)
        return out

    def check(self, digests: list, device) -> dict:
        return self.compare(digests, self.reference(device))

    def control(self, ref, device) -> dict:
        """The reference in bfloat16 from the same start: ``compare``
        keywords (positions and trace)."""
        pos, trace = self.reference(device, torch.bfloat16)
        return {"positions": pos, "trace": trace}
