"""Blocks of sharded tensors: what each rank of a ``ModelMesh`` holds.

A tensor of global ``shape`` under spec ``P`` is cut, along every dim whose
entry names mesh axes, into as many equal blocks as the product of their
extents; rank r holds block ``mesh.index(entry)`` of each such dim, the
entry's first axis major. That is the block the reference's
``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives its device
of the same linear index (``tests/test_torch_model_mesh.py``).

* ``local_block`` — the slices of one rank;
* ``shard_tree`` — a rank's blocks of a nested dict of full tensors;
* ``gather_tree`` — the full tensors back from every rank's blocks;
* ``Placement`` — what a model path needs to run on its blocks: the mesh,
  each parameter's spec and the axes the batch was split on.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.sharding.collectives import all_gather_axes
from repro_torch.sharding.rules import _map2, entry_axes


def _extent(mesh, entry) -> int:
    out = 1
    for a in entry_axes(entry):
        if a in mesh.shape:
            out *= mesh.shape[a]
    return out


def local_block(shape, spec, mesh, coords: dict) -> tuple:
    """The slices (one a dim) of the block of a ``shape`` tensor under
    ``spec`` that the rank at ``coords`` holds. A spec shorter than the
    shape leaves the trailing dims whole."""
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        k = _extent(mesh, entry)
        if k == 1:
            out.append(slice(None))
            continue
        if n % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide over {entry!r} ({k})")
        j = 0
        for a in entry_axes(entry):
            if a in mesh.shape:
                j = j * mesh.shape[a] + coords[a]
        size = n // k
        out.append(slice(j * size, (j + 1) * size))
    return tuple(out)


def _spec_of(s):
    return getattr(s, "spec", s)


def shard_tree(tree, specs_tree, mesh):
    """This rank's blocks (contiguous copies, on ``mesh.device``) of every
    full tensor of ``tree``; ``specs_tree`` holds a spec (or a
    ``NamedSharding``) per leaf."""
    def one(x, s):
        blk = x[local_block(x.shape, _spec_of(s), mesh, mesh.coords)]
        return blk.to(mesh.device).contiguous().clone()

    return _map2(one, tree, specs_tree)


def gather_tree(tree, specs_tree, mesh):
    """The full tensors from every rank's blocks (every rank gets them), on
    ``mesh.device``."""
    def one(x, s):
        x = x.detach()
        for dim, entry in enumerate(_spec_of(s)):
            if _extent(mesh, entry) > 1:
                x = all_gather_axes(x, mesh, entry_axes(entry), dim)
        return x

    return _map2(one, tree, specs_tree)


@dataclass(frozen=True)
class Placement:
    """A model path on a mesh: ``specs`` (each parameter's spec, as
    ``params``), ``batch_axes`` (the mesh axes the batch was split over;
    the per-rank losses sum over them), ``batch_specs`` (each batch
    input's spec) and ``seq_axis`` (None, or "model": the residual stream's
    sequence dim split over it between blocks — sequence parallelism; the
    step builders set it by the reference's rule, not the user). A weight
    dim sharded over ``tp_axis`` (the profiles' "model") is used as a
    tensor-parallel shard; a dim sharded over any other axes is gathered
    before use."""

    mesh: object
    specs: dict
    batch_axes: tuple = ()
    batch_specs: dict = field(default_factory=dict)
    seq_axis: str | None = None
    tp_axis = "model"

    @property
    def sp(self) -> bool:
        """Is the sequence split (``seq_axis`` set, of extent > 1)?"""
        return self.seq_axis is not None and self.mesh.extent(self.seq_axis) > 1

    def tp(self, spec, dim: int) -> bool:
        """Is dim ``dim`` of a weight of ``spec`` a tensor-parallel shard?"""
        e = spec[dim] if dim < len(spec) else None
        return entry_axes(e) == (self.tp_axis,) and self.mesh.extent(self.tp_axis) > 1

    def use(self, w, spec, whole: bool = False):
        """``w``'s block made whole along its non-tensor-parallel dims (ZeRO
        gathers; with ``whole`` along every dim); the tensor-parallel dims
        stay this rank's shards. The gradient comes back to the block,
        summed over the gathered axes that the batch was split on."""
        from repro_torch.sharding.collectives import gather_param

        gathered = {d: entry_axes(e) for d, e in enumerate(spec)
                    if e is not None and (whole or entry_axes(e) != (self.tp_axis,))
                    and self.mesh.extent(entry_axes(e)) > 1}
        if not gathered:
            return w
        red = tuple(a for e in gathered.values() for a in e if a in self.batch_axes)
        return gather_param(w, self.mesh, gathered, red)
