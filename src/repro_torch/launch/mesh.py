"""The multi-device meshes on ``torch.distributed``: the streaming
engine's one-axis ``StreamMesh`` and the model paths' named ``ModelMesh``.

The reference builds a one-axis ``"data"`` mesh over the local devices and
runs its sharded passes as ``shard_map`` bodies under one controller. The
port runs one process per rank instead (SPMD, several controllers): every
rank calls the same entry point on the same inputs, holds its share of
each chunk, and gets back the same replicated result.

``StreamMesh`` is that rank's view: its process group, ``rank``, ``size``
and ``device``. ``make_stream_mesh`` uses an initialised process group, or
initialises one from the ``torch.distributed.run`` environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``). A process started any other way is a mesh of one.

Backends. NCCL needs a card of its own for every rank: it refuses two ranks
on one device. ``backend=None`` picks NCCL when every local rank owns a
card and raises when ranks outnumber cards; ``backend="gloo"`` asks for
gloo explicitly, which stages CUDA tensors through the host and so lets
several ranks share one card (torch 2.11's gloo takes CUDA tensors in
``all_gather`` and in ``all_reduce`` with SUM, MAX and MIN:
``tools/collective_probe.py``). On the CPU (``device="cpu"``) the backend
is gloo.

``ModelMesh`` is a rank's view of a named mesh (``("data", "model")``,
``("pod", "data", "model")``): the axes and their extents, its coordinates
(ranks laid out row-major over the axes, the first axis major, in the
order of the reference's ``make_mesh`` devices) and one process group for
every set of axes, holding the ranks that differ only along those axes
(``groups[axes]``; ``collectives`` reduces and gathers over them).
``make_model_mesh`` builds it over the process group, ``make_host_mesh`` is
the (1, 1) mesh of one process, ``make_production_mesh`` the (16, 16) or
(2, 16, 16) one. Over a fake process group (backend "fake", the dry run's:
one real process standing for one rank of the world) a mesh takes any
device, a card or not.

``spawn_local`` runs a function on ``world`` ranks of this host with
``torch.multiprocessing`` and a ``file://`` store (no TCP port), under a
time limit, so a rank that hangs in a collective fails the call instead of
waiting forever.
"""
from __future__ import annotations

import datetime
import os
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# Collectives that wait longer than this raise (gloo honours it).
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class StreamMesh:
    """One rank's view of a one-axis mesh of ``size`` ranks.

    ``group`` is the process group (None for a mesh of one), ``device``
    where this rank's tensors live, ``backend`` the group's backend ("gloo"
    or "nccl"; "" for a mesh of one)."""

    rank: int
    size: int
    device: torch.device
    backend: str = ""
    group: object = None


def _env_int(name: str, default: int | None = None) -> int | None:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def _mesh_device(device, local_rank: int) -> torch.device:
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None:
        return resolve_device(device)
    resolve_device(None)  # raises without CUDA
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _pick_backend(backend, device: torch.device, local_world: int) -> str:
    if device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only gloo runs there")
        return "gloo"
    if backend == "gloo":
        return "gloo"
    cards = torch.cuda.device_count()
    if backend in (None, "nccl"):
        if local_world > cards:
            raise RuntimeError(
                f"make_stream_mesh: {local_world} ranks on this host share "
                f"{cards} CUDA card(s), and NCCL refuses two ranks on one card; "
                "pass backend='gloo' to run them on a shared card"
            )
        return "nccl"
    raise ValueError(f"unknown backend {backend!r}: expected 'gloo' or 'nccl'")


def make_stream_mesh(devices: int | None = None, backend: str | None = None,
                     device=None) -> StreamMesh:
    """This rank's ``StreamMesh`` over every rank of the process group.

    ``devices`` states the rank count the caller expects and raises if the
    group differs (the launcher, not this call, sets it). ``device=None``
    means ``cuda:{LOCAL_RANK % device_count}`` and raises without CUDA;
    ``device="cpu"`` runs the plain versions under gloo. ``backend`` is
    None (NCCL, which needs a card for every local rank), "nccl" or
    "gloo" (ranks may share a card). A process with no process group and
    no launcher environment is a mesh of one."""
    if not dist.is_initialized() and _env_int("WORLD_SIZE", 1) > 1:
        local_world = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE"))
        dev = _mesh_device(device, _env_int("LOCAL_RANK", 0))
        dist.init_process_group(_pick_backend(backend, dev, local_world),
                                init_method="env://", timeout=COLLECTIVE_TIMEOUT)
    if not dist.is_initialized():
        if devices not in (None, 1):
            raise ValueError(f"make_stream_mesh: {devices} ranks asked for, "
                             "but this process runs alone")
        return StreamMesh(0, 1, _mesh_device(device, 0))
    rank, size = dist.get_rank(), dist.get_world_size()
    if devices is not None and devices != size:
        raise ValueError(f"make_stream_mesh: {devices} ranks asked for, the "
                         f"process group has {size}")
    if dist.get_backend() == "fake":
        # A dry run's fake world (``torch.testing``'s fake process group):
        # no rank exists but this one, and no card is needed; its tensors
        # are fake, on the device asked for (default CUDA).
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        return StreamMesh(rank, size, dev, "fake", dist.group.WORLD)
    local_world = _env_int("LOCAL_WORLD_SIZE", size)
    dev = _mesh_device(device, _env_int("LOCAL_RANK", rank))
    have = dist.get_backend()
    want = _pick_backend(backend, dev, local_world)
    if have != want:
        raise RuntimeError(f"make_stream_mesh: the process group runs {have}, "
                           f"this mesh needs {want}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return StreamMesh(rank, size, dev, have, dist.group.WORLD)


def _spawned(rank, fn, world, backend, device, init_file, args):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world))
    # The ranks share the host's cores (torch.distributed.run gives each
    # rank one thread); busy pools starve the collectives' threads.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        dev = _mesh_device(device, rank)
        dist.init_process_group(_pick_backend(backend, dev, world),
                                init_method=f"file://{init_file}", rank=rank,
                                world_size=world, timeout=COLLECTIVE_TIMEOUT)
        mesh = make_stream_mesh(world, backend=backend, device=device)
        try:
            fn(mesh, *args)
        except SystemExit as e:  # a clean exit (a launcher preempted) is a return
            if e.code not in (0, None):
                raise
        # Ranks that finished leave together: one that took its group down
        # while a peer still held it could abort at exit.
        dist.barrier()
    except Exception:
        traceback.print_exc()
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_local(fn, world: int, *, backend: str | None = None, device=None,
                init_file: str, args: tuple = (), timeout: float = 600.0) -> None:
    """Run ``fn(mesh, *args)`` on ``world`` ranks of this host and wait.

    Each rank is a fresh process (``spawn``: it imports ``fn``'s module, so
    keep that module free of heavy imports), joined through the
    ``file://{init_file}`` store; ``init_file`` must not exist yet and must
    be on a filesystem every rank sees. ``backend``/``device`` are
    ``make_stream_mesh``'s. Raises if a rank fails, or kills every rank and
    raises ``TimeoutError`` after ``timeout`` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_spawned, args=(fn, world, backend, device,
                                             os.fspath(init_file), tuple(args)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawn_local: {world} ranks still running "
                                   f"after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


# ------------------------------------------------------------- named meshes


@dataclass(frozen=True)
class ModelMesh:
    """One rank's view of a named mesh.

    ``shape`` maps each axis name to its extent (in axis order), ``coords``
    each to this rank's index along it; ``rank`` is the linear index,
    row-major over ``axis_names``. ``groups`` maps a tuple of axis names (in
    axis order, each of extent > 1) to the process group of the ranks that
    share this rank's coordinates on every other axis; a set whose extent
    is 1 has no group. ``size``, ``group`` (every rank) and ``backend`` let
    a ``ModelMesh`` stand where a ``StreamMesh`` is taken."""

    axis_names: tuple
    shape: dict
    rank: int
    coords: dict
    device: torch.device
    groups: dict
    backend: str = ""

    @property
    def size(self) -> int:
        return _prod(self.shape.values())

    @property
    def group(self):
        return self.groups.get(self.live_axes(self.axis_names))

    def live_axes(self, axes) -> tuple:
        """``axes`` (a name or names) in mesh order, keeping those on this
        mesh of extent > 1."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        return tuple(a for a in self.axis_names if a in axes and self.shape[a] > 1)

    def extent(self, axes) -> int:
        return _prod(self.shape[a] for a in self.live_axes(axes))

    def index(self, axes) -> int:
        """This rank's block index along ``axes``, row-major in the order
        given (the order of a spec entry)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        i = 0
        for a in axes:
            if a in self.shape:
                i = i * self.shape[a] + self.coords[a]
        return i


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def _axis_sets(names: tuple, sizes: tuple) -> list[tuple]:
    """Every non-empty set of the axes of extent > 1, in a fixed order."""
    live = [a for a, s in zip(names, sizes) if s > 1]
    out = []
    for bits in range(1, 1 << len(live)):
        out.append(tuple(a for i, a in enumerate(live) if bits >> i & 1))
    return out


def mesh_coords(rank: int, names: tuple, sizes: tuple) -> dict:
    """The coordinates of linear rank ``rank``, row-major over the axes."""
    coords = {}
    for a, s in zip(reversed(names), reversed(sizes)):
        coords[a] = rank % s
        rank //= s
    return {a: coords[a] for a in names}


def _groups(rank: int, names: tuple, sizes: tuple, world: int) -> dict:
    """Every rank creates every group, in the same order (``new_group`` is
    collective); each keeps the groups it belongs to."""
    mine = mesh_coords(rank, names, sizes)
    out = {}
    for axes in _axis_sets(names, sizes):
        others = [a for a in names if a not in axes]
        buckets: dict = {}
        for r in range(world):
            c = mesh_coords(r, names, sizes)
            buckets.setdefault(tuple(c[a] for a in others), []).append(r)
        for key in sorted(buckets):
            g = dist.new_group(buckets[key])
            if key == tuple(mine[a] for a in others):
                out[axes] = g
    return out


def make_model_mesh(shape, axes, *, backend: str | None = None, device=None) -> ModelMesh:
    """This rank's ``ModelMesh`` of extents ``shape`` over axes ``axes``.

    Uses an initialised process group, or initialises one from the
    ``torch.distributed.run`` environment, as ``make_stream_mesh`` does
    (``backend``/``device`` are its); a process with neither is a world of
    one. Raises unless the product of ``shape`` is the world size."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"make_model_mesh: shape {shape} and axes {axes} do not pair up")
    want = _prod(shape)
    if not dist.is_initialized() and want == 1 and _env_int("WORLD_SIZE", 1) == 1:
        return ModelMesh(axes, dict(zip(axes, shape)), 0, {a: 0 for a in axes},
                         _mesh_device(device, 0), {})
    stream = make_stream_mesh(backend=backend, device=device)
    if stream.size != want:
        raise ValueError(f"make_model_mesh: a {'x'.join(map(str, shape))} mesh needs {want} "
                         f"ranks, the process group has {stream.size}")
    groups = _groups(stream.rank, axes, shape, stream.size) if stream.size > 1 else {}
    return ModelMesh(axes, dict(zip(axes, shape)), stream.rank,
                     mesh_coords(stream.rank, axes, shape), stream.device, groups,
                     stream.backend)


def make_host_mesh(device=None) -> ModelMesh:
    """The (1, 1) ``("data", "model")`` mesh of one process: the sharded
    step functions on one device."""
    return make_model_mesh((1, 1), ("data", "model"), device=device)


def make_production_mesh(multi_pod: bool = False, *, backend: str | None = None,
                         device=None) -> ModelMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``: 256 or 512 ranks, one a card."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else _env_int("WORLD_SIZE", 1)
    if world != _prod(shape):
        raise ValueError(f"make_production_mesh: the {'x'.join(map(str, shape))} mesh needs "
                         f"{_prod(shape)} ranks, this world has {world}")
    return make_model_mesh(shape, axes, backend=backend, device=device)
