"""Carry configuration, state and parameters from the reference package
into the port.

The BigGraphVis pipeline has no weights; what a run carries is
configuration and state. The model substrate has parameters:
``params_from_reference`` turns the reference's parameter tree, as numpy
arrays, into the port's nested dict of tensors, and
``opt_state_from_reference`` its AdamW state (either layout).
``config_from_reference`` turns any of the reference's ``ScodaConfig``,
``CMSConfig``, ``FA2Config``, ``BGVConfig``, ``StreamConfig``,
``RenderConfig`` or ``TileConfig`` into the port's, by duck typing on
attributes — it never imports the reference package (a ``StreamConfig``'s
``validation`` policy becomes the port's ``ValidationPolicy``, its ``mesh``
None: pass a ``launch.mesh.StreamMesh``). Fields the port has
no counterpart for (the reference's kernel ``backend`` knobs, its
benchmark-only timing flags) are dropped. ``state_from_numpy`` builds port tensors
from host arrays (the reference's state converted with ``np.asarray``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cms import CMSConfig
from repro_torch.core.forceatlas2 import FA2Config
from repro_torch.core.pipeline import BGVConfig
from repro_torch.core.scoda import ScodaConfig
from repro_torch.core.stream import StreamConfig
from repro_torch.core.supergraph import Supergraph
from repro_torch.render.raster import RenderConfig
from repro_torch.resilience.validate import ValidationPolicy
from repro_torch.serve.tiles import TileConfig

# Attribute that identifies each config class, checked in this order.
_KINDS = (
    ("scoda", BGVConfig),
    ("degree_threshold", ScodaConfig),
    ("repulsion_k", FA2Config),
    ("drill_iterations", TileConfig),
    ("supersample", RenderConfig),
    ("agg_backend", StreamConfig),
    ("rows", CMSConfig),
)


def config_from_reference(cfg):
    """The port's config equal, field for field, to a reference config."""
    for attr, cls in _KINDS:
        if hasattr(cfg, attr):
            break
    else:
        raise TypeError(f"not a known BigGraphVis config: {type(cfg).__name__}")
    kwargs = {}
    for f in dataclasses.fields(cls):
        if not hasattr(cfg, f.name):
            continue
        value = getattr(cfg, f.name)
        if cls is BGVConfig and f.name in ("scoda", "cms", "layout"):
            value = config_from_reference(value)
        if cls is StreamConfig and f.name == "mesh":
            value = None  # the reference's device mesh; the port takes a StreamMesh
        if cls is StreamConfig and f.name == "validation" and value is not None:
            value = ValidationPolicy(**{g.name: getattr(value, g.name)
                                        for g in dataclasses.fields(ValidationPolicy)})
        kwargs[f.name] = value
    return cls(**kwargs)


def state_from_numpy(kind: str, value, device="cpu"):
    """Port state from host arrays.

    ``kind``: ``"scoda"`` — ``(com, deg)`` int32 [n+1]; ``"agg"`` —
    ``(a, b, w, n)`` aggregation state; ``"supergraph"`` — any object with
    the ``Supergraph`` fields; ``"pos0"`` — [n, 2] float32 positions.
    """
    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    if kind == "scoda":
        com, deg = value
        return t(com, torch.int32), t(deg, torch.int32)
    if kind == "agg":
        a, b, w, n = value
        return t(a, torch.int32), t(b, torch.int32), t(w, torch.float32), t(n, torch.int32)
    if kind == "supergraph":
        return Supergraph(
            edges=t(value.edges, torch.int32),
            weights=t(value.weights, torch.float32),
            sizes=t(value.sizes, torch.float32),
            n_supernodes=t(value.n_supernodes, torch.int32),
            n_superedges=t(value.n_superedges, torch.int32),
            labels=t(value.labels, torch.int32),
        )
    if kind == "pos0":
        return t(value, torch.float32)
    raise ValueError(f"unknown state kind {kind!r}: scoda, agg, supergraph, pos0")


def params_from_reference(tree, device="cpu"):
    """The port's parameters from the reference's parameter tree (nested
    dicts of arrays; each leaf is read with ``np.asarray``). bfloat16 leaves
    keep their bits."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    x = np.asarray(tree)
    if x.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(x).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(x), device=device)


def opt_state_from_reference(tree, device="cpu"):
    """The port's AdamW state (``repro_torch.train.optimizer``) from the
    reference's, as numpy arrays: ``{"count", "mv"}`` with each parameter's
    ``{"m", "v"}`` either float32 arrays (``state_bits=32``) or the 8-bit
    layout (m as int8 ``q`` and float32 ``s``, v factored into ``r`` and
    ``c`` for parameters of rank ≥ 2). Dtypes are kept, so the state
    restores bit for bit."""
    if set(tree) != {"count", "mv"}:
        raise ValueError(f"not an AdamW state: keys {sorted(tree)}, expected count and mv")

    def one(node):
        if isinstance(node, dict) and set(node) == {"m", "v"}:
            return {k: params_from_reference(node[k], device) for k in ("m", "v")}
        if isinstance(node, dict):
            return {k: one(v) for k, v in node.items()}
        raise ValueError("AdamW state: a parameter's entry must be a dict of m and v")

    count = torch.as_tensor(np.array(tree["count"]), dtype=torch.int32, device=device)
    return {"count": count, "mv": one(tree["mv"])}
