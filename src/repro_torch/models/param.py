"""Minimal parameter system with logical sharding axes (t5x/MaxText style).

A model is a function ``config → {name: ParamSpec}`` (nested dicts
allowed). Each ``ParamSpec`` carries *logical* axis names ("embed",
"heads", "expert", "vocab", ...), kept for the sharding rules of a later
multi-device slice; parameters are plain nested dicts of tensors.

Random weights come from an explicit ``torch.Generator``, one leaf after
the other in sorted key order. They are not the reference's numbers (it
draws from its own generator); a test that compares the two packages
carries the reference's parameters over (``convert.params_from_reference``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch


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


def _init_one(gen: torch.Generator, spec: ParamSpec) -> torch.Tensor:
    dev = gen.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=dev)
    if spec.init == "scaled":  # fan-in scaled normal
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        return (x * (1.0 / math.sqrt(max(fan_in, 1)))).to(spec.dtype)
    return (x * spec.init_scale).to(spec.dtype)


def init_params(generator: torch.Generator, specs) -> Any:
    """Materialise a spec tree on the generator's device, leaves drawn one
    after the other in sorted key order."""
    out = {}

    def fill(tree, dst):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                dst[k] = {}
                fill(v, dst[k])
            else:
                dst[k] = _init_one(generator, v)

    fill(specs, out)
    return out


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
