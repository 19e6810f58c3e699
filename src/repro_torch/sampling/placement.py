"""Device placement as a first-class engine concern, on ``torch.distributed``.

A :class:`Placement` pins down everything about WHERE a sampling engine
runs: the rank mesh (a ``DeviceMesh`` from ``repro_torch.launch.mesh``),
which mesh axes the request (lane) dimension shards over, which axis the
denoiser would shard over, and which axis one request's solve window
shards over.  The JAX package's ``repro.sampling.Placement`` with the same
validation, geometry and reporting; its shardings become what each rank
holds:

  * request axis -> ``data_axis``: each data rank holds and solves
    ``slots / data_shards`` contiguous lanes (:meth:`lanes`,
    :meth:`place_batch`), and the engine all-gathers per-lane results
    over the data group;
  * solve window -> ``time_axis``: each time rank evaluates its block of
    the window's rows (``ParaTAAConfig.time_axis``; :meth:`window_spec` /
    :meth:`window_rows` give the row plan) and one all-gather restores the
    window;
  * denoiser -> ``model_axis``: given a ``ParamSpec`` tree,
    :meth:`shard_params` gives each rank its blocks of the parameters by
    their logical axes (``models.shardctx.ShardedParams``: heads, mlp and
    the adaLN columns over ``model``, embed rows over the data axes), and
    the DiT runs tensor-parallel on them; without one it broadcasts the
    whole tree and the denoiser runs replicated over ``model``.

``Placement.host()`` is the no-mesh placement: every method is an
identity, and an engine built with it is the single-device engine.  A
placement on a mesh never runs the host path: an engine on it holds its
data shard's lanes and issues the collectives, also on a mesh of one
rank.  Constructing a mesh placement makes its process groups, a
collective over the default group: every rank constructs the same
placements in the same order.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch import comm

AxisName = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """Mesh + lane/window layout + donation flag for a sampling engine.

    mesh:       ``torch.distributed.device_mesh.DeviceMesh``, or None for
                the single-device/host placement.
    data_axis:  mesh axis (or tuple of axes) the request dimension shards
                over.
    model_axis: mesh axis the denoiser shards over when the engine is given
                its ``ParamSpec`` tree (see the module docstring).
    time_axis:  mesh axis the solve WINDOW of one request shards over
                (None = window replicated within a data shard).
    donate:     accepted for the JAX package's flag; eager PyTorch has no
                buffers to donate to a compiled program, so it changes
                nothing.
    """
    mesh: Optional[object] = None
    data_axis: AxisName = "data"
    model_axis: str = "model"
    time_axis: Optional[str] = None
    donate: bool = False

    def __post_init__(self):
        if self.mesh is None:
            return
        names = set(self.mesh.mesh_dim_names)
        missing = [a for a in self.data_axes if a not in names]
        if missing:
            raise ValueError(
                f"data_axis {missing} not in mesh axes {sorted(names)}")
        if self.model_axis not in names:
            raise ValueError(
                f"model_axis {self.model_axis!r} not in mesh axes "
                f"{sorted(names)}")
        if self.time_axis is not None:
            if self.time_axis not in names:
                raise ValueError(
                    f"time_axis {self.time_axis!r} not in mesh axes "
                    f"{sorted(names)}")
            claimed = set(self.data_axes) | {self.model_axis}
            if self.time_axis in claimed:
                raise ValueError(
                    f"time_axis {self.time_axis!r} already claimed by "
                    f"data/model ({sorted(claimed)})")
        # the process groups this placement's collectives use, made now
        # (collectively, on every rank) rather than at first use
        from repro_torch.launch.mesh import axes_group

        object.__setattr__(self, "_data_group",
                           axes_group(self.mesh, self.data_axes))
        object.__setattr__(self, "_mesh_group",
                           axes_group(self.mesh, tuple(
                               self.mesh.mesh_dim_names)))
        # the FSDP group of sharded parameters (pdefs' "embed" over
        # (pod, data)), likewise made on every rank
        fsdp = tuple(a for a in ("pod", "data") if a in names)
        if len(fsdp) > 1:
            axes_group(self.mesh, fsdp)

    # -- constructors --------------------------------------------------------

    @classmethod
    def host(cls) -> "Placement":
        """The no-mesh placement: every method is an identity."""
        return cls(mesh=None)

    @classmethod
    def for_mesh(cls, mesh, *, donate: bool = False) -> "Placement":
        """Canonical placement for a registry mesh: the request axis spans
        every data-parallel dimension — ``("pod", "data")`` on multi-pod
        meshes, plain ``"data"`` otherwise — and a ``time`` mesh axis, when
        present, shards the solve window within each request."""
        names = mesh.mesh_dim_names
        data_axis = ("pod", "data") if "pod" in names else "data"
        time_axis = "time" if "time" in names else None
        return cls(mesh=mesh, data_axis=data_axis, time_axis=time_axis,
                   donate=donate)

    # -- topology ------------------------------------------------------------

    @property
    def is_sharded(self) -> bool:
        return self.mesh is not None

    @property
    def is_member(self) -> bool:
        """Whether this rank is one of the mesh's (always, off-mesh)."""
        return not self.is_sharded or self.mesh.get_coordinate() is not None

    @property
    def data_axes(self) -> Tuple[str, ...]:
        if isinstance(self.data_axis, str):
            return (self.data_axis,)
        return tuple(self.data_axis)

    def _axis_sizes(self) -> dict:
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))

    @property
    def data_shards(self) -> int:
        """Number of shards the request axis is split into."""
        if not self.is_sharded:
            return 1
        sizes = self._axis_sizes()
        n = 1
        for a in self.data_axes:
            n *= sizes[a]
        return n

    @property
    def model_shards(self) -> int:
        if not self.is_sharded:
            return 1
        return self._axis_sizes().get(self.model_axis, 1)

    @property
    def time_shards(self) -> int:
        """Number of shards one request's solve window splits into."""
        if not self.is_sharded or self.time_axis is None:
            return 1
        return self._axis_sizes().get(self.time_axis, 1)

    @property
    def num_devices(self) -> int:
        return int(self.mesh.mesh.numel()) if self.is_sharded else 1

    @property
    def ranks(self) -> list:
        """The mesh's global ranks, in layout order ([0] off-mesh)."""
        return self.mesh.mesh.flatten().tolist() if self.is_sharded else [0]

    @property
    def data_index(self) -> int:
        """This rank's coordinate along the (flattened) data axes."""
        if not self.is_sharded:
            return 0
        sizes = self._axis_sizes()
        index = 0
        for a in self.data_axes:
            index = index * sizes[a] + self.mesh.get_local_rank(a)
        return index

    @property
    def data_group(self):
        """Process group of this rank's data shards (None off-mesh)."""
        return getattr(self, "_data_group", None)

    @property
    def mesh_group(self):
        """Process group of all the mesh's ranks (None off-mesh)."""
        return getattr(self, "_mesh_group", None)

    # -- layout --------------------------------------------------------------

    def batch_spec(self, ndim: int) -> tuple:
        """The JAX package's PartitionSpec entries putting the leading
        (request) axis on data, as a tuple."""
        ax = self.data_axis if isinstance(self.data_axis, str) \
            else tuple(self.data_axis)
        return (ax,) + (None,) * (ndim - 1)

    def window_spec(self, shape, dim: int = 1) -> tuple:
        """The leading (request) axis over data AND dimension ``dim`` (the
        trajectory-row / window axis) over time, as PartitionSpec entries;
        the time entry is dropped when ``shape[dim]`` does not divide
        ``time_shards`` (T+1-row arrays keep the plain batch spec, as the
        solver's ``window_shard`` no-op does)."""
        spec = list(self.batch_spec(len(shape)))
        t = self.time_shards
        if self.time_axis is not None and t > 1 and len(shape) > dim \
                and shape[dim] % t == 0:
            spec[dim] = self.time_axis
        return tuple(spec)

    def window_rows(self, rows: int) -> Tuple[int, int]:
        """[start, stop) of the rows of a ``rows``-row window this rank
        evaluates: its time coordinate's block, or every row when the axis
        is off or does not divide ``rows``."""
        t = self.time_shards
        if t <= 1 or rows % t or not self.is_member:
            return 0, rows
        n = rows // t
        k = self.mesh.get_local_rank(self.time_axis)
        return k * n, (k + 1) * n

    def lanes(self, slots: int) -> Tuple[int, int]:
        """[start, stop) of the request slots this rank's data shard holds
        (``slots`` a multiple of ``data_shards``)."""
        d = self.data_shards
        if slots % d:
            raise ValueError(f"{slots} request slots do not divide over "
                             f"{d} data shards")
        n = slots // d
        k = self.data_index
        return k * n, (k + 1) * n

    # -- batch geometry ------------------------------------------------------

    def round_batch(self, n: int) -> int:
        """Smallest request-slot count >= n divisible by data_shards."""
        d = self.data_shards
        return max(-(-n // d), 1) * d

    def slot_utilization(self, n_real: int, slots: int) -> float:
        return n_real / max(slots, 1)

    def axis_utilization(self, n_real: int, slots: int,
                         window: int) -> dict:
        """Per-mesh-axis utilization of the request grid.

        data: fraction of request slots holding real work.
        time: fraction of each window shard holding real rows — 1.0 when the
              window divides time_shards (or the axis is off), 1 / t when a
              non-divisible window falls back to replicated rows (shards
              then redo the full window).
        """
        t = self.time_shards
        if t > 1 and window % t == 0:
            time_util = 1.0
        else:
            time_util = 1.0 / t
        return {"data": self.slot_utilization(n_real, slots),
                "time": time_util}

    # -- data movement -------------------------------------------------------

    def place_batch(self, *arrays):
        """This rank's request slots of each packed (slots, ...) array."""
        if not self.is_sharded:
            return arrays
        out = []
        for a in arrays:
            lo, hi = self.lanes(a.shape[0])
            out.append(a[lo:hi])
        return tuple(out)

    def place_window(self, *arrays, dim: int = 1):
        """This rank's slots of each packed (slots, rows, ...) trajectory
        array, and its block of rows along ``dim`` where the time axis
        divides them (``place_batch`` otherwise)."""
        if not self.is_sharded:
            return arrays
        out = []
        for a in self.place_batch(*arrays):
            if self.window_spec(a.shape, dim)[dim] is not None:
                lo, hi = self.window_rows(a.shape[dim])
                a = a.narrow(dim, lo, hi - lo)
            out.append(a)
        return tuple(out)

    def gather_lanes(self, x: torch.Tensor) -> torch.Tensor:
        """Every data shard's lanes of ``x`` (leading lane axis), in slot
        order: one all-gather over the data group (identity off-mesh)."""
        if not self.is_sharded:
            return x
        return comm.all_gather_cat(x, self.data_group, 0)

    def shard_params(self, params, param_defs=None, device=None):
        """Place denoiser params on the mesh (identity off-mesh and on a
        rank outside it).  Every tensor is first broadcast from the mesh's
        first rank.  No defs: that replicated tree, in place.  A
        ``ParamSpec`` tree: this rank's blocks of it, by its logical axes
        (``pdefs.resolve_spec`` -> ``pdefs.local_block``: TP over
        ``model``, FSDP over the data axes, the reference's rules), as a
        :class:`~repro_torch.models.shardctx.ShardedParams` the DiT runs
        tensor-parallel on.  ``device``: where the blocks live, when the
        tree is held elsewhere (the host); each leaf is copied, broadcast
        and sliced in turn, so the device holds the blocks and one whole
        leaf at a time."""
        if not self.is_sharded or not self.is_member:
            return params
        src = self.ranks[0]

        def bcast(x):
            if isinstance(x, torch.Tensor):
                comm.broadcast_(x.data, src, self.mesh_group)
            elif isinstance(x, dict):
                for v in x.values():
                    bcast(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    bcast(v)
            return x

        if param_defs is None:
            with torch.no_grad():
                return bcast(params)
        from repro_torch.models.shardctx import ShardedParams

        def place(x):
            with torch.no_grad():
                return bcast(x if device is None else x.to(device))

        return ShardedParams.build(params, param_defs, self.mesh,
                                   self.model_axis, place=place)

    # -- activation context ---------------------------------------------------

    @contextlib.contextmanager
    def activations(self):
        """Ambient-mesh context for running the engine's solves: the
        window's ``time`` collectives resolve against the mesh, and the
        denoiser-internal "batch" axis stands down (the engine owns it)."""
        if not self.is_sharded:
            yield None
            return
        from repro_torch.models.shardctx import serving_mesh

        with serving_mesh(self.mesh) as m:
            yield m

    # -- reporting -----------------------------------------------------------

    def describe(self, denoiser_sharded: Optional[bool] = None) -> str:
        """The layout in words (the JAX package's text).  With
        ``denoiser_sharded`` it also says whether the denoiser is split
        over the model axis (an engine given ``param_defs``) or runs
        replicated over it."""
        if not self.is_sharded:
            return "host (no mesh, 1 program replica)"
        sizes = self._axis_sizes()
        axes = " x ".join(f"{a}={int(n)}" for a, n in sizes.items())
        window = "" if self.time_axis is None else \
            f", windows over {self.time_axis}"
        how = {None: "", True: "TP-sharded ", False: "replicated "}[
            denoiser_sharded]
        return (f"mesh[{axes}] ({self.num_devices} devices; requests over "
                f"{'/'.join(self.data_axes)}, denoiser {how}over "
                f"{self.model_axis}{window})")
