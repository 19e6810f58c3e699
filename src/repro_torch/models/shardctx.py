"""Activation-sharding context: the ambient mesh, its logical-axis rules,
and the ParaTAA window's shard/gather pair.

The JAX package expresses activation layouts as sharding constraints that
GSPMD turns into collectives (``repro.models.shardctx``).  The port runs one
process per rank and computes eagerly, so a layout is what a rank holds
and a collective is an explicit call.  What carries over:

  * the ambient mesh (``use_mesh``, ``serving_mesh``, ``current_mesh``,
    ``batch_axes``) and the logical-axis rules (``ACT_RULES``,
    ``_resolve``, with the JAX package's divisibility fallbacks), which
    ``resolve_spec`` reads as the per-dimension mesh axes of an activation;
  * ``window_constrain``'s contract as two explicit operations:
    :func:`window_shard` keeps this rank's rows of the window and
    :func:`window_gather` all-gathers them back over the axis's group —
    exact data movement, so the sharded solve equals the unsharded one bit
    for bit.  Both are no-ops with no mesh, a ``None`` axis, an axis the
    mesh lacks, or rows that the axis size does not divide (the JAX
    package's fallbacks);
  * ``constrain`` keeps its signature and is a no-op: a layout is what
    each rank holds, and the engine owns the request axis (under
    ``serving_mesh`` the JAX package's constraint resolves "batch" to
    replicated too, and the DiT's only constraint is
    ``constrain(x, "batch", None, None)``);
  * the DiT's tensor parallelism, which GSPMD derives in the JAX package
    from the parameters' shardings, is explicit here: a
    :class:`ShardedParams` carries a rank's blocks of the parameter tree
    (``pdefs.local_block``: heads, mlp and the adaLN columns over
    ``model``, the embed rows over the data axes) with the process groups
    they are blocks over.  ``dit_apply`` given one runs the Megatron
    forward: it all-gathers the embed rows of a block's leaves just before
    the block, in one flat all-gather (``gather``: exact; nothing moves
    over data axes of one rank), all-gathers the adaLN columns
    (``model_cat``) and sums the row-parallel partials (``model_sum``)
    over ``model``.  Given a plain tree it runs every head on every rank.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import comm
from repro_torch.models.pdefs import entry_axes

_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)
# override for the "batch" logical axis (e.g. serving: batch over ALL axes)
_BATCH_AXES = contextvars.ContextVar("repro_torch_batch_axes", default=None)


@contextlib.contextmanager
def batch_axes(axes):
    tok = _BATCH_AXES.set(tuple(axes))
    try:
        yield
    finally:
        _BATCH_AXES.reset(tok)


# logical activation axes -> mesh axes (with divisibility fallback)
ACT_RULES = {
    "batch": "fsdp",   # ("pod","data") multi-pod, ("data",) single-pod
    "seq": "model",    # context parallel (hidden-TP archs / long context)
    "heads": "model",
    "embed": None,
    "window": "fsdp",  # ParaTAA window-of-timesteps axis
}


@contextlib.contextmanager
def use_mesh(mesh):
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def current_mesh():
    return _MESH.get()


@contextlib.contextmanager
def serving_mesh(mesh):
    """Engine-serving activation context (see
    ``repro_torch.sampling.Placement``): the ambient mesh for the window's
    ``time`` collectives, with the "batch" logical axis resolved to
    replicated (the engine owns the request axis)."""
    with use_mesh(mesh) as m, batch_axes(()):
        yield m


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _resolve(logical: Optional[str], dim: int, mesh):
    if logical is None:
        return None
    sizes = _sizes(mesh)
    if logical == "batch" and _BATCH_AXES.get() is not None:
        axes = tuple(a for a in _BATCH_AXES.get() if a in sizes)
        total = 1
        for a in axes:
            total *= sizes[a]
        if axes and dim % total == 0:
            return axes if len(axes) > 1 else axes[0]
        return None
    target = ACT_RULES.get(logical)
    if target is None:
        return None
    if target == "fsdp":
        axes = tuple(a for a in ("pod", "data") if a in sizes)
        total = 1
        for a in axes:
            total *= sizes[a]
        if axes and dim % total == 0:
            return axes if len(axes) > 1 else axes[0]
        if "data" in sizes and dim % sizes["data"] == 0:
            return "data"
        return None
    if target in sizes and dim % sizes[target] == 0:
        return target
    return None


def resolve_spec(shape, *logical_axes) -> Tuple:
    """The mesh axes each dimension of an activation of ``shape`` resolves
    to against the ambient mesh (all None without one): the JAX package's
    ``PartitionSpec`` entries, as a tuple."""
    mesh = _MESH.get()
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    if mesh is None:
        return (None,) * len(shape)
    return tuple(_resolve(ax, d, mesh) for ax, d in zip(logical_axes, shape))


def constrain(x, *logical_axes):
    """A no-op that keeps the JAX package's call sites: the port's layouts
    are what each rank holds (see the module docstring)."""
    assert len(logical_axes) == x.dim(), (logical_axes, x.shape)
    return x


def _window_axis(axis: Optional[str], rows: int):
    """(mesh, size) when ``rows`` rows shard over mesh axis ``axis``, else
    None (the JAX package's no-op cases)."""
    mesh = _MESH.get()
    if mesh is None or axis is None:
        return None
    sizes = _sizes(mesh)
    if axis not in sizes or rows % sizes[axis] != 0:
        return None
    return mesh, sizes[axis]


def window_shard(x: torch.Tensor, axis: Optional[str],
                 dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s rows along ``dim`` over mesh
    axis ``axis`` (its coordinate's block of ``x.shape[dim] / size``), or
    ``x`` itself in the no-op cases."""
    hit = _window_axis(axis, x.shape[dim])
    if hit is None:
        return x
    mesh, size = hit
    n = x.shape[dim] // size
    return x.narrow(dim, mesh.get_local_rank(axis) * n, n)


def window_gather(x_local: torch.Tensor, axis: Optional[str], dim: int,
                  rows: int) -> torch.Tensor:
    """Inverse of :func:`window_shard` for a window of ``rows`` rows:
    every rank's block, all-gathered over ``axis``'s group and concatenated
    along ``dim`` in coordinate order (``x_local`` itself in the no-op
    cases, where it already holds every row)."""
    hit = _window_axis(axis, rows)
    if hit is None:
        return x_local
    mesh, _ = hit
    return comm.all_gather_cat(x_local, mesh.get_group(axis), dim)


@dataclasses.dataclass(eq=False)
class ShardedParams:
    """A rank's blocks of a parameter tree on a mesh, and what a forward
    needs to compute with them (see the module docstring).

    local:      the tree of this rank's blocks (plain tensors, each the
                contiguous slice of ``pdefs.local_block``)
    specs:      '/'-joined leaf path -> its PartitionSpec entries
    mesh:       the ``DeviceMesh``
    model_axis: the tensor-parallel axis; every other sharded axis is
                FSDP, gathered before use
    groups:     a spec entry's axes -> their process group
    """
    local: object
    specs: Dict[str, Tuple]
    mesh: object
    model_axis: str = "model"
    groups: Dict[Tuple[str, ...], object] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def build(cls, params, defs, mesh, model_axis: str = "model",
              place=None) -> "ShardedParams":
        """Slice ``params`` (the full tree, the same on every rank) into
        this rank's blocks by ``defs``' logical axes, one leaf at a time
        (``place(leaf)``, when given, first makes the leaf whole on the
        rank: so only one whole leaf is live at once).  Multi-axis groups
        come from ``launch.mesh.axes_group`` (made once per mesh; every
        mesh rank builds the same carrier)."""
        from repro_torch.launch.mesh import axes_group
        from repro_torch.models import pdefs
        from repro_torch.tree import leaves, path_name, unflatten

        specs, blocks = {}, []
        for x, (path, spec) in zip(leaves(params), pdefs.walk(defs)):
            entries = pdefs.resolve_spec(spec, mesh)
            specs[path_name(path)] = entries
            blocks.append(pdefs.local_block(
                x if place is None else place(x), entries, mesh))
        groups = {}
        for entries in specs.values():
            for entry in entries:
                axes = entry_axes(entry)
                if axes and axes not in groups:
                    groups[axes] = axes_group(mesh, axes)
        return cls(unflatten(params, blocks), specs, mesh, model_axis,
                   groups)

    def __getitem__(self, key):
        return self.local[key]

    def _entries(self, path: str, ndim: int) -> Tuple:
        """The spec entries of ``path``'s last ``ndim`` dims (a stacked
        leaf's layer slice drops its leading entry)."""
        entries = self.specs[path]
        return entries[len(entries) - ndim:]

    def sharded(self, path: str) -> bool:
        """Whether ``path``'s leaf is split over the model axis (False
        where its size does not divide: the block is whole, and the
        forward must not reduce over model)."""
        return any(self.model_axis in entry_axes(e) for e in self.specs[path])

    def gather(self, blocks: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """``blocks`` (leaf path -> a block of its leaf, or of one layer of
        it) with the dim each splits over axes other than model (its
        ``embed`` dim, the only one the rules put there) all-gathered
        back, in coordinate order (ZeRO-3: exact data movement).  The
        blocks split over the same axes move in one flat all-gather; axes
        of one rank move nothing."""
        todo: Dict[Tuple[str, ...], list] = {}
        for path, x in blocks.items():
            for dim, entry in enumerate(self._entries(path, x.dim())):
                axes = entry_axes(entry)
                if axes and self.model_axis not in axes \
                        and comm.group_size(self.groups[axes]) > 1:
                    todo.setdefault(axes, []).append((path, dim))
        out = dict(blocks)
        for axes, items in todo.items():
            group = self.groups[axes]
            n = comm.group_size(group)
            flat = comm.all_gather_cat(torch.cat(
                [blocks[p].reshape(-1) for p, _ in items]), group, 0
            ).view(n, -1)
            start = 0
            for path, dim in items:
                x = blocks[path]
                part = flat[:, start:start + x.numel()].reshape(n, *x.shape)
                out[path] = part.movedim(0, dim).flatten(dim, dim + 1)
                start += x.numel()
        return out

    @property
    def model_group(self):
        return self.groups.get((self.model_axis,))

    def model_cat(self, path: str, x: torch.Tensor,
                  dim: int = -1) -> torch.Tensor:
        """The columns of a column-parallel product by ``path``'s leaf,
        all-gathered over model (``x`` itself where the leaf is whole)."""
        if not self.sharded(path):
            return x
        return comm.all_gather_cat(x, self.model_group, dim % x.dim())

    def model_sum(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """The partial sums of a row-parallel product by ``path``'s leaf,
        added over model in place (``x``, a product no one else reads, is
        returned as it is where the leaf is whole)."""
        if not self.sharded(path):
            return x
        return comm.all_reduce_sum_(x, self.model_group)
