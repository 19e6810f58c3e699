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
  * ``constrain`` keeps its signature and is a no-op: the port's models
    compute their activations replicated over ``model`` and the engine
    owns the request axis (under ``serving_mesh`` the JAX package's
    constraint resolves "batch" to replicated too, and the DiT's only
    constraint is ``constrain(x, "batch", None, None)``).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch

from repro_torch import comm

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
