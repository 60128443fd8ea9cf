"""Unit ``picture``: ``biggraphvis(edges_host, n, cfg, stream=StreamConfig(
chunk_size))`` then ``BGVResult.render()``; the edge list stays in host
memory and is streamed anew by every picture. Settings: the
configuration's ``pipeline`` (SCoDA, sketch, supergraph, layout, render,
stream).

``run()`` returns the record of one repetition (stage seconds and a
fingerprint of its outputs); ``check()`` holds the last repetition's
outputs against the reference (``reference/``) and returns every number
it can compare; the cell's ``limits/<cell>.json`` says which are judged.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bgvbench import outputs
from bgvbench.reference import fa2 as ref_fa2
from bgvbench.reference import prng as ref_prng
from bgvbench.reference import raster as ref_raster
from bgvbench.reference import scoda as ref_scoda
from bgvbench.reference import supergraph as ref_sg


class Unit:
    kind = "picture"

    def __init__(self, program, config: dict, mix: dict, edges: np.ndarray, n: int,
                 seed: int, device):
        p = config["pipeline"]
        self.program, self.config, self.mix = program, config, mix
        self.edges, self.device, self.seed = edges, device, seed
        self.n = int(n)
        self.delta = ref_sg.mode_degree(edges, self.n)
        base = program.default_config(self.n, len(edges), self.delta, rounds=p["rounds"],
                                      iterations=p["iterations"], init=p["init"])
        self.cfg = dataclasses.replace(
            base,
            scoda=dataclasses.replace(base.scoda, block_size=p["block_size"]),
            layout=dataclasses.replace(base.layout, seed=outputs.layout_seed(seed),
                                       dtype=p["dtype"], repulsion_k=p["repulsion_k"],
                                       gravity=p["gravity"],
                                       jitter_tolerance=p["jitter_tolerance"]),
            s_cap=min(self.n, p["s_cap"]),
            max_super_edges=min(4 * len(edges), p["max_super_edges"]))
        self.stream = program.StreamConfig(chunk_size=p["chunk_size"])
        self.render_cfg = program.RenderConfig(width=p["width"], height=p["height"])
        self.last = None

    def shapes(self) -> dict:
        if self.last is None:
            return {}
        res = self.last[0]
        return {"n": self.n,
                "s_layout": outputs.live_layout_size(res.n_supernodes, self.cfg.s_cap),
                "iterations": self.cfg.layout.iterations}

    def run(self) -> dict:
        self.last = None  # the previous picture's state goes before this one starts
        res = self.program.biggraphvis(self.edges, self.n, self.cfg, stream=self.stream,
                                       device=self.device)
        image, rstats = res.render(cfg=self.render_cfg)
        self.last = (res, image)
        t = res.timings
        return {"detect_s": t["scoda_s"], "supergraph_s": t["supergraph_s"],
                "layout_s": t["layout_s"], "render_s": t["render_s"],
                "compose_s": rstats.compose_s, "stream_wait_s": res.stream.copy_stall_s,
                "n_supernodes": int(res.n_supernodes),
                "digest": outputs.digest(res.labels, res.positions, res.sizes, image)}

    warm = run

    def release(self):
        """Keep the last picture's outputs on the host only."""
        if self.last is not None:
            res, image = self.last
            sg = res.supergraph
            self.last = ({"labels": res.labels, "positions": res.positions,
                          "sizes": res.sizes, "groups": res.groups,
                          "modularity": res.modularity,
                          "n_supernodes": int(res.n_supernodes),
                          "n_superedges": int(res.n_superedges),
                          "edges": sg.edges.cpu().numpy(),
                          "weights": sg.weights.cpu().numpy()}, image)

    def reference(self, device, dtype=torch.float32) -> dict:
        """The reference's own outputs for this graph and seed."""
        p, n = self.config["pipeline"], self.n
        e = torch.as_tensor(self.edges, device=device)
        delta = ref_sg.mode_degree(self.edges, n)
        labels, n_live = ref_sg.dense(
            ref_scoda.detect(e, n, delta, p["rounds"], p["block_size"]))
        s_cap = min(n, p["s_cap"])
        deg = ref_sg.degrees(e, n)
        cols = max(256, len(self.edges) // p["cms_edges_per_col"])
        sizes = ref_sg.cms_sizes(labels, deg, n_live, s_cap, p["cms_rows"], cols,
                                 p["cms_seed"])
        cap = min(4 * len(self.edges), p["max_super_edges"])
        chunk = -(-p["chunk_size"] // p["block_size"]) * p["block_size"]
        sa, sb, sw, count = ref_sg.superedges(e, labels, s_cap, cap, chunk)
        q = ref_sg.modularity(e, labels)
        groups = ref_sg.color_groups(sizes)
        del e, deg
        layout_in = (sizes, n_live, sa, sb, sw, count, s_cap, cap)
        pos, _ = self.reference_layout(*layout_in, device, dtype)
        return {"_layout_in": layout_in, "labels": labels.cpu().numpy(), "n_supernodes": n_live,
                "sizes": sizes.cpu().numpy(), "a": sa.cpu().numpy(),
                "b": sb.cpu().numpy(), "w": sw.cpu().numpy(), "n_superedges": count,
                "modularity": q, "groups": groups.cpu().numpy(),
                "positions": pos.cpu().numpy()}

    def reference_layout(self, sizes, n_live, sa, sb, sw, count, s_cap, cap, device,
                         dtype):
        p = self.config["pipeline"]
        s = outputs.live_layout_size(n_live, s_cap)
        e_l = min(1 << (max(count, 1) - 1).bit_length(), cap)
        live = torch.arange(s, device=device) < n_live
        mass = torch.where(live, sizes[:s].double().clamp(min=0) + 1.0, 0.0).float()
        edges = torch.stack([sa[:e_l].clamp(max=s), sb[:e_l].clamp(max=s)], 1)
        lay = ref_fa2.Layout(edges, sw[:e_l].float(), mass, s,
                             iterations=p["iterations"], kr=p["repulsion_k"],
                             kg=p["gravity"], tau=p["jitter_tolerance"],
                             repulsion="exact", use_radii=True, dtype=dtype)
        p0 = ref_prng.uniform_f32(outputs.layout_seed(self.seed), (s, 2), -1000.0, 1000.0,
                                  device)
        return lay.run(p0)

    def compare(self, digests: list, ref: dict, positions=None, modularity=None) -> dict:
        """Numbers of the last picture against the reference's outputs
        ``ref`` → {name: value}. ``positions`` and ``modularity`` stand in
        for the program's (the control)."""
        got, image = self.last
        pos = got["positions"] if positions is None else positions
        s_cap = len(got["sizes"])
        n_live = ref["n_supernodes"]
        out = {"units_differ": sum(d != digests[-1] for d in digests)}
        out["labels"] = int((got["labels"] != ref["labels"]).sum())
        e = got["edges"]
        sg_bad = (e[:, 0] != ref["a"]).sum() + (e[:, 1] != ref["b"]).sum() \
            + (got["weights"] != ref["w"]).sum()
        sg_bad += int(got["n_superedges"] != ref["n_superedges"])
        sg_bad += int(got["n_supernodes"] != n_live)
        out["supergraph"] = int(sg_bad)
        out["sizes"] = int((got["sizes"] != ref["sizes"]).sum())
        out["groups"] = int((got["groups"] != ref["groups"]).sum())
        out["modularity"] = abs(got["modularity"] - ref["modularity"])
        k = min(n_live, outputs.live_layout_size(n_live, s_cap))
        out["pos_gap"] = outputs.position_gap(pos[:k], ref["positions"][:k])
        a, b = ref["a"], ref["b"]
        live = (a < k) & (b < k)
        out["shape_gap"] = outputs.shape_gap(pos[:k], ref["positions"][:k], a[live], b[live],
                                     ref["w"][live])
        if modularity is not None:
            out["modularity"] = abs(modularity - ref["modularity"])
        want = ref_raster.picture(
            got["positions"], ref["sizes"], ref["groups"], ref["a"], ref["b"], ref["w"],
            width=image.shape[1], height=image.shape[0], device=self.device)
        out["image_px"] = int((want != image).any(axis=-1).sum())
        return out

    def check(self, digests: list, device) -> dict:
        return self.compare(digests, self.reference(device))

    def control(self, ref: dict, device) -> dict:
        """The reference's floating-point stages in bfloat16 from the same
        inputs, in the program's place: ``compare`` keywords (positions
        [s_cap, 2] and the modularity)."""
        pos, _ = self.reference_layout(*ref["_layout_in"], device, torch.bfloat16)
        out = np.zeros_like(self.last[0]["positions"])
        out[:pos.shape[0]] = pos.cpu().numpy()
        e = torch.as_tensor(self.edges, device=device)
        q = ref_sg.modularity(e, torch.as_tensor(ref["labels"], device=device),
                              torch.bfloat16)
        return {"positions": out, "modularity": q}
