"""Mesh registry: named, validated rank meshes on ``torch.distributed``.

The JAX package's registry (``repro.launch.mesh``) with the same names,
shapes and axes:

  * ``debug``       — 2x2 (data, model), CPU integration tests.
  * ``single-host`` — 4x2 (data, model), one 8-accelerator host.
  * ``pod``         — 16x16 (data, model), one pod slice.
  * ``multi-pod``   — 2x16x16 (pod, data, model).
  * ``debug-time`` / ``single-host-time`` / ``pod-time`` — the same with a
    ``time`` axis the solve window of one request shards over.

The JAX package runs one controller over many devices; the port runs one
process per rank (multi-controller SPMD): every rank runs the same
program and the mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`
whose axis groups carry explicit collectives (``repro_torch.comm``).
:func:`init_distributed` starts the process group — NCCL on the card, gloo
on the CPU, never one in place of the other — and ``make_mesh`` validates a
spec against its world size and builds the mesh over the first ranks (or
the ``ranks=`` given, where the JAX package takes ``devices=``).  Building
a mesh is collective over the default group: every rank calls it, in the
same order, whether or not it is one of the mesh's ranks.  Importing this
module touches no process group.

:func:`fake_mesh` builds a registry mesh (``pod``, ``multi-pod``) in a
world without cards: torch's ``fake`` backend, in which this process is
rank 0 and every collective returns at once, moving nothing.  The
dry-run counts rank 0's program on ``meta`` tensors there; nothing else
uses it, and a process holds one default group, so it runs in a process
of its own.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import tempfile
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike

#: seconds a collective may wait for its peers before it fails: a rank
#: that took another branch raises instead of hanging the others
DEFAULT_TIMEOUT_S = 300.0

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device: DeviceLike) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU, and nothing else:
    a CUDA run never falls back to gloo."""
    dtype = torch.device(device).type
    if dtype not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r} "
                         f"(cuda -> nccl, cpu -> gloo)")
    return BACKENDS[dtype]


def init_distributed(device: DeviceLike, *, world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     init_method: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Start the default process group for ``device`` (once; a second call
    checks the backend and returns).  Returns the backend name.

    world_size / rank: default ``$WORLD_SIZE`` / ``$RANK`` (set by
      ``torchrun``), else a world of one.
    init_method: default ``env://`` under ``torchrun`` (``$MASTER_ADDR``),
      else a ``file://`` rendezvous in a fresh temporary directory (a
      world of one).  Parallel test workers pass their own ``file://``
      path instead of racing for a TCP port.
    timeout_s: the collective timeout, so a divergence fails.

    On ``cuda`` it selects ``$LOCAL_RANK``'s card and initializes NCCL; if
    that fails it raises (no retry on gloo)."""
    backend = backend_for(device)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(
                f"process group already initialized with {have!r}; "
                f"device {device!r} needs {backend!r}")
        return have
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(env.get("RANK", 0))
    if init_method is None:
        if "MASTER_ADDR" in env:
            init_method = "env://"
        elif world_size == 1:
            rdv = tempfile.mkdtemp(prefix="repro_torch_rdv_")
            init_method = f"file://{rdv}/store"
        else:
            raise ValueError(
                f"world_size={world_size} needs an init_method (file://... "
                f"or env://); launch with torchrun --nproc-per-node "
                f"{world_size}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed('cuda') needs a CUDA device "
                               "(NCCL); pass device='cpu' for gloo")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return backend


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A named mesh topology (validated lazily, at build time)."""
    name: str
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    description: str = ""

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    @property
    def num_devices(self) -> int:
        return int(np.prod(self.shape))

    def with_sizes(self, *, data_parallel: Optional[int] = None,
                   model_parallel: Optional[int] = None,
                   time_parallel: Optional[int] = None) -> "MeshSpec":
        """Override the data/model/time axis sizes (None keeps the default)."""
        sizes = dict(zip(self.axes, self.shape))
        if data_parallel:
            if "data" not in sizes:
                raise ValueError(f"mesh '{self.name}' has no 'data' axis")
            sizes["data"] = data_parallel
        if model_parallel:
            if "model" not in sizes:
                raise ValueError(f"mesh '{self.name}' has no 'model' axis")
            sizes["model"] = model_parallel
        if time_parallel:
            if "time" not in sizes:
                raise ValueError(
                    f"mesh '{self.name}' has no 'time' axis; pick a "
                    f"*-time mesh ({', '.join(time_mesh_names())}) to "
                    f"shard solve windows")
            sizes["time"] = time_parallel
        return dataclasses.replace(
            self, shape=tuple(sizes[a] for a in self.axes))

    def check(self, ranks: Optional[Sequence[int]] = None,
              world_size: Optional[int] = None) -> list:
        """The mesh's ranks, validated: ``ranks`` (an explicit override,
        at least as many as the mesh needs, increasing) or the first
        ranks of a world of ``world_size`` (default: the default group's)."""
        n = self.num_devices
        layout = dict(zip(self.axes, self.shape))
        if ranks is not None:
            ranks = [int(r) for r in ranks]
            if len(ranks) < n:
                raise ValueError(
                    f"mesh '{self.name}' {layout} needs {n} ranks but only "
                    f"{len(ranks)} were given")
            ranks = ranks[:n]
            if ranks != sorted(set(ranks)):
                raise ValueError(f"mesh ranks must increase: {ranks}")
            return ranks
        if world_size is None:
            world_size = dist.get_world_size() if dist.is_initialized() \
                else 1
        if world_size < n:
            raise ValueError(
                f"mesh '{self.name}' {layout} needs {n} ranks but "
                f"the world size is {world_size}; pick a smaller registered "
                f"mesh ({', '.join(mesh_names())}), override "
                f"--data-parallel/--model-parallel"
                f"{'/--time-parallel' if 'time' in self.axes else ''}, or "
                f"launch {n} ranks with torchrun --nproc-per-node {n} "
                f"(python -m torch.distributed.run)")
        return list(range(n))

    def build(self, *, ranks: Optional[Sequence[int]] = None,
              device_type: str = "cuda"):
        """Validate against the world and build the ``DeviceMesh`` (a
        collective over the default group: every rank calls it)."""
        from torch.distributed.device_mesh import DeviceMesh

        ranks = self.check(ranks)
        if not dist.is_initialized():
            raise RuntimeError(
                "building a mesh needs a process group; call "
                "repro_torch.launch.mesh.init_distributed(device) first")
        mesh = torch.tensor(ranks, dtype=torch.int).reshape(self.shape)
        return DeviceMesh(device_type, mesh, mesh_dim_names=self.axes)


_REGISTRY: Dict[str, MeshSpec] = {}


def register_mesh(spec: MeshSpec) -> MeshSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_mesh_spec(name: str) -> MeshSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown mesh {name!r}; registered: "
                       f"{mesh_names()}") from None


def mesh_names():
    return sorted(_REGISTRY)


def time_mesh_names():
    """Registered meshes carrying a 'time' axis (window sharding)."""
    return sorted(n for n, s in _REGISTRY.items() if "time" in s.axes)


def make_mesh(name: str = "debug", *, data_parallel: Optional[int] = None,
              model_parallel: Optional[int] = None,
              time_parallel: Optional[int] = None,
              ranks: Optional[Sequence[int]] = None,
              device_type: str = "cuda"):
    """Resolve a registered mesh by name, apply axis-size overrides,
    validate against the world size, and build it."""
    spec = get_mesh_spec(name).with_sizes(
        data_parallel=data_parallel, model_parallel=model_parallel,
        time_parallel=time_parallel)
    return spec.build(ranks=ranks, device_type=device_type)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


_GROUPS: Dict = {}


def axes_group(mesh, axes: Tuple[str, ...]):
    """The process group spanning ``axes`` of ``mesh`` that holds this rank
    (None on a rank outside the mesh).  One axis is the mesh's own group;
    several are made with ``new_group`` once per (mesh, axes) — collective
    over the default group, so every rank asks for the same (mesh, axes)
    in the same order (``Placement`` does so at construction)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0]) if mesh.get_coordinate() is not None \
            else None
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        grid = mesh.mesh.numpy()
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(grid.ndim) if i not in keep]
        blocks = np.transpose(grid, rest + keep).reshape(
            -1, int(np.prod([grid.shape[i] for i in keep])))
        me = dist.get_rank()
        mine = None
        for block in blocks:
            group = dist.new_group(sorted(int(r) for r in block))
            if me in block:
                mine = group
        _GROUPS[key] = (mesh, mine)     # the mesh is kept alive with its id
    return _GROUPS[key][1]


def model_subgroup(mesh, share: int, axis: str = "model"):
    """The process group of the ``share`` consecutive ``axis`` coordinates
    that hold this rank (its other coordinates fixed): the ranks that
    share one RG-LRU gate block.  Made with ``new_group`` once per (mesh,
    share) for every block of every ``axis`` group — collective over the
    default group, so every rank asks in the same order (each layer's
    forward does, in layer order)."""
    key = (id(mesh), "sub", axis, share)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        grid = np.moveaxis(mesh.mesh.numpy(), names.index(axis), -1)
        rows = grid.reshape(-1, grid.shape[-1])
        me = dist.get_rank()
        mine = None
        for row in rows:
            for lo in range(0, len(row), share):
                ranks = sorted(int(r) for r in row[lo:lo + share])
                group = dist.new_group(ranks)
                if me in ranks:
                    mine = group
        _GROUPS[key] = (mesh, mine)
    return _GROUPS[key][1]


@contextlib.contextmanager
def fake_mesh(name: str, **sizes):
    """The registry mesh ``name`` (with ``with_sizes`` overrides) over a
    ``fake`` world of as many ranks, this process its rank 0: shapes,
    groups and collectives without cards or data (``meta`` tensors pass
    through ``repro_torch.comm`` and are counted).  Refuses to start
    beside another default group; destroys its own on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    spec = get_mesh_spec(name).with_sizes(**sizes)
    if dist.is_initialized():
        raise RuntimeError(
            f"fake_mesh({name!r}) needs a process without a process group "
            f"(one has {dist.get_backend()!r}); run the dry-run in its "
            f"own process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=spec.num_devices)
    try:
        yield spec.build(device_type="cpu")
    finally:
        dist.destroy_process_group()
        _GROUPS.clear()


register_mesh(MeshSpec("debug", (2, 2), ("data", "model"),
                       "CPU integration tests (gloo ranks)"))
register_mesh(MeshSpec("single-host", (4, 2), ("data", "model"),
                       "one 8-accelerator host"))
register_mesh(MeshSpec("pod", (16, 16), ("data", "model"),
                       "one pod slice"))
register_mesh(MeshSpec("multi-pod", (2, 16, 16), ("pod", "data", "model"),
                       "two pod slices, FSDP over (pod, data)"))

# time-axis geometries: the solve window of ONE request shards over `time`
# (see repro_torch.sampling.Placement.window_spec)
register_mesh(MeshSpec("debug-time", (2, 2, 2), ("data", "time", "model"),
                       "CPU integration tests with window sharding "
                       "(8 gloo ranks)"))
register_mesh(MeshSpec("single-host-time", (2, 2, 2),
                       ("data", "time", "model"),
                       "one 8-accelerator host, windows split two ways"))
register_mesh(MeshSpec("pod-time", (8, 2, 16), ("data", "time", "model"),
                       "one pod slice with window sharding"))
