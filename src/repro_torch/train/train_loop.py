"""Train-step factories (loss → gradient → AdamW) shared by every family,
with microbatch gradient accumulation, optional gradient compression and a
step-time watchdog for straggler detection: the reference's
``train/train_loop.py``.

Gradients come from ``torch.autograd.grad`` over the parameter leaves
(sorted key order). The step sets ``requires_grad`` on the leaves for its
own duration (a restored checkpoint's leaves have none) and updates them
in place (``optimizer.apply_updates``).

On a ``ModelMesh`` (``make_train_step(..., mesh=placement)``, the
``sharding.params.Placement`` the loss was bound to) each rank's loss is its
share of the global loss and its gradients are its blocks' parts. A leaf
that is not split over the batch axes is summed over them (each rank's
part comes from its rows: the mean of equal shards, taken exactly as a
sum of the shares); a leaf split over them arrives summed through its
gather's backward (ZeRO-3), and the tensor-parallel axis needs nothing
(Megatron's f and g leave every rank of it the whole gradient of its
block). ``compress_grads`` applies the int8 round trip to the *reduced*
gradient, which is what the reference's numbers are: the wire payload of
the all-reduce here is float32, not int8. The loss reported is the global
one, the sum of the shares. Microbatch i is the same global rows on any
mesh (``_microbatches``), each rank holding its block of them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.models.param import tree_leaves
from repro_torch.train import optimizer as opt
from repro_torch.train.compression import compress_decompress


@dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = field(default_factory=opt.AdamWConfig)
    microbatch: int = 0  # 0 = no accumulation; else split the batch dim
    compress_grads: bool = False  # int8 gradient compression (no error feedback)


def _unflatten(like, leaves):
    """A tree shaped like ``like`` (nested dicts) from its sorted-order leaves."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def _reduce_grads(grads, place) -> list:
    """Every gradient summed over the batch axes that do not split its leaf
    (those that do were summed by the gather's backward)."""
    from repro_torch.sharding.collectives import all_reduce_axes
    from repro_torch.sharding.rules import spec_axes

    mesh = place.mesh
    out = []
    for g, spec in zip(grads, tree_leaves(place.specs), strict=True):
        axes = tuple(a for a in mesh.live_axes(place.batch_axes) if a not in spec_axes(spec))
        out.append(all_reduce_axes(g.contiguous(), mesh, axes) if axes else g)
    return out


def _compress(grads, place) -> list:
    if place is None:
        return [compress_decompress(g) for g in grads]
    from repro_torch.sharding.rules import entry_axes

    return [compress_decompress(g, place.mesh, place.mesh.live_axes(entry_axes(s[-1])) if s else ())
            for g, s in zip(grads, tree_leaves(place.specs))]


def _microbatches(batch: dict, n: int, place):
    """``part(i)``: microbatch i of ``n``, the reference's split of the
    *global* batch (``x.reshape(n, B // n, ...)``): global rows ``[i·B/n,
    (i+1)·B/n)``. With a placement each rank holds its block of those rows
    along the batch axes: the inputs split over the batch axes are gathered
    whole once (tokens and masks: small), and every microbatch is cut from
    them. Splitting each rank's own rows instead would group other rows
    into each microbatch, and a microbatch's masked mean and its MoE
    routing depend on which rows share it (fault F3).

    Where ``B/n`` rows do not split evenly over the D batch shards (fault
    G1), rank j takes rows ``[j·c, (j+1)·c)`` of the microbatch cut at
    ``B/n``, c = ceil(B/n / D), as XLA pads an uneven shard: a share may be
    short or empty. The losses weight each rank by its rows already (a
    rank's masked sum over the global mask count). A model that routes
    tokens to experts raises there: its capacity and load-balance term are
    per token shard, and the reference's ``shard_map`` refuses such shards
    too."""
    if place is None or not place.mesh.live_axes(place.batch_axes):
        def part(i):
            return {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                    for k, v in batch.items()}
        return part

    from repro_torch.sharding.collectives import all_gather_axes, block_range
    from repro_torch.sharding.rules import entry_axes

    mesh = place.mesh
    d = mesh.extent(place.batch_axes)
    split, uneven = set(), False
    for k, v in batch.items():
        spec = place.batch_specs.get(k, ())
        axes = mesh.live_axes(entry_axes(spec[0])) if len(spec) else ()
        rows = v.shape[0] * (d if axes else 1)
        if rows % n:
            raise NotImplementedError(
                f"microbatching: input {k!r} has {rows} rows, which do not split into "
                f"{n} microbatches (the reference reshapes the global batch to (n, B/n, ...))")
        if axes:
            split.add(k)
            uneven |= bool(rows // n % d)
    if uneven and _routes_tokens(place.specs):
        raise NotImplementedError(
            f"microbatching: {n} microbatches of the global batch do not split evenly over "
            f"{d} batch shards, and an expert layer's capacity and load balance are per "
            "token shard (the reference's shard_map refuses uneven token shards)")
    whole = {k: all_gather_axes(v, mesh, place.batch_axes, 0) if k in split else v
             for k, v in batch.items()}
    j = mesh.index(place.batch_axes)

    def part(i):
        out = {}
        for k, v in whole.items():
            b = v.shape[0] // n
            if k in split:
                lo, hi = block_range(b, d, j)
                out[k] = v[i * b + lo:i * b + hi]
            else:
                out[k] = v[i * b:(i + 1) * b]
        return out

    return part


def _routes_tokens(specs) -> bool:
    """True when the parameter tree holds an expert router."""
    if isinstance(specs, dict):
        return "router" in specs or any(_routes_tokens(v) for v in specs.values())
    return False


def make_train_step(loss_fn: Callable, tcfg: TrainConfig, mesh=None):
    """``loss_fn(params, batch)`` → scalar. Returns ``train_step(params,
    state, batch)`` → ``(params, state, metrics)``, metrics ``loss`` and
    ``grad_norm`` (0-d float32 tensors). ``mesh``: None, or the
    ``Placement`` the loss was bound to (the module docstring)."""
    place = mesh

    def grads_of(params, leaves, batch):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), grads

    def train_step(params, state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            if tcfg.microbatch and tcfg.microbatch > 1:
                n = tcfg.microbatch
                part = _microbatches(batch, n, place)

                # Accumulate in the parameter dtype, from zeros, and the
                # loss in float32, as the reference's scan does.
                loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
                grads = [torch.zeros_like(p, requires_grad=False) for p in leaves]
                for i in range(n):
                    li, gi = grads_of(params, leaves, part(i))
                    loss = loss + li
                    grads = [a + g for a, g in zip(grads, gi)]
                    del gi
                loss = loss / n
                grads = [g / n for g in grads]
            else:
                loss, grads = grads_of(params, leaves, batch)
        finally:
            for p in leaves:
                p.requires_grad_(False)

        if place is not None:
            from repro_torch.sharding.collectives import all_reduce_axes

            grads = _reduce_grads(grads, place)
            loss = all_reduce_axes(loss.clone(), place.mesh, place.batch_axes)
        if tcfg.compress_grads:
            grads = _compress(grads, place)
        params, state, metrics = opt.apply_updates(
            params, _unflatten(params, grads), state, tcfg.adamw,
            *((place.mesh, place.specs) if place is not None else ()))
        metrics["loss"] = loss
        return params, state, metrics

    return train_step


class StepWatchdog:
    """Host-side straggler detector: flags steps slower than ``threshold ×``
    the running median of the earlier ones, after ``warmup`` steps."""

    def __init__(self, threshold: float = 3.0, warmup: int = 3):
        self.threshold = threshold
        self.warmup = warmup
        self.durations: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        dt = time.perf_counter() - self._t0
        self.durations.append(dt)
        if len(self.durations) <= self.warmup:
            return False
        med = sorted(self.durations[:-1])[len(self.durations[:-1]) // 2]
        return dt > self.threshold * med
