"""Minimal parameter system with logical sharding axes (t5x/MaxText style).

A model is a function ``config → {name: ParamSpec}`` (nested dicts
allowed). Each ``ParamSpec`` carries *logical* axis names ("embed",
"heads", "expert", "vocab", ...), kept for the sharding rules of a later
multi-device slice; parameters are plain nested dicts of tensors.

Random weights are the reference's for the same key, bit for bit: the
leaves in its flattening order (sorted keys), one subkey each from
``prng.split`` (``zeros`` and ``ones`` leaves take theirs too), each a
float32 ``prng.normal`` draw times its scale, cast to the leaf's dtype
last. Weights that were not drawn from a key (a checkpoint, another run of
the reference) cross over through ``convert.params_from_reference``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical_axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones | scaled (fan-in)
    dtype: Any = torch.float32
    init_scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"shape {self.shape} and axes {self.logical_axes} differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn, tree):
    """``fn`` on every leaf of a nested dict, keys kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _init_one(key: tuple[int, int], spec: ParamSpec, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "scaled":  # fan-in scaled normal
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    else:
        scale = spec.init_scale
    x = prng.normal(key, spec.shape, device=device)
    # the draw times the scale rounded to float32: one float32 product
    x.mul_(torch.tensor(scale, dtype=torch.float32, device=device))
    return x.to(spec.dtype)


def init_params(key: tuple[int, int], specs, device=None) -> Any:
    """Materialise a spec tree on ``device`` (the card unless the caller
    asks for the CPU) from ``key`` (``prng.key(seed)``): the reference's
    ``init_params(PRNGKey(seed), specs)``."""
    device = resolve_device(device)
    keys = iter(prng.split(key, len(tree_leaves(specs))))

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(tree[k]) for k in sorted(tree)}
        return _init_one(next(keys), tree, device)

    return fill(specs)


def abstract_params(specs) -> Any:
    """``meta`` tensors of each parameter's shape and dtype (no storage)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


def logical_axes(specs) -> Any:
    return tree_map(lambda s: s.logical_axes, specs)


def cast_floats(tree, dtype):
    """Floating leaves cast to ``dtype`` (a leaf already of it is kept as
    is); integer leaves untouched."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))
