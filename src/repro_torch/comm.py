"""The port's collectives, counted where they are issued.

Every collective of the port goes through one of these wrappers, so a run
can say how many it issued and how many bytes each kind moved: the JAX
package reads the same numbers out of partitioned HLO
(``roofline/analysis.py::parse_collective_bytes``); eager PyTorch has no
HLO, so the call sites count instead.  ``counts[kind]`` is the number of
calls and ``nbytes[kind]`` the operand bytes a rank contributed (the local
shard of an all-gather, the reduced tensor of an all-reduce, the
broadcast tensor; a broadcast control object counts no bytes), under the
HLO's names (a reduce-scatter counts the whole tensor it reduces).
``group_bytes[(kind, ranks)]`` splits the same bytes by the
global ranks of the group they crossed, which is what prices a collective
on the links its ranks span (``roofline.analysis.link_bytes``).

Each call is a plain ``torch.distributed`` call on a process group: NCCL
on the card, gloo on the CPU.  An all-gather is exact data movement (no
arithmetic), which is what keeps a sharded solve bit for bit equal to the
unsharded one.

The tensor-parallel backward needs each collective's adjoint, and the same
forward collective needs different ones at different call sites (what the
downstream gradient is: a rank's partial, or the whole gradient on every
rank).  So the differentiable forms below name their backward, and count
it (``torch.distributed.nn.functional`` has one fixed backward per
collective: its all-reduce's all-reduces the gradient, which multiplies a
row-parallel output's gradient by the group size):

==========================  ==========================  ==================
forward                     downstream gradient         backward
==========================  ==========================  ==================
:func:`gather_partial`      each rank's partial         reduce-scatter
:func:`gather_replicated`   whole on every rank         the rank's block
:func:`sum_replicated`      whole on every rank         identity
:func:`partial_grads`       each rank's partial         all-reduce
:func:`sum_partial`         each rank's partial         all-reduce
:func:`scatter_sum`         the rank's rows             all-gather
==========================  ==========================  ==================

(:func:`partial_grads` is Megatron's *f*: a replicated activation entering
split leaves; its forward moves nothing.)  Without grad each is its plain
collective, in place where that form was.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "broadcast")

#: dtypes that cross the wire as same-size integers (gloo takes no bool)
_WIRE = {torch.bool: torch.uint8}

counts = {k: 0 for k in KINDS}
nbytes = {k: 0 for k in KINDS}
group_bytes: Dict[Tuple[str, Tuple[int, ...]], int] = {}


def reset() -> None:
    """Zero the counts (before a run whose collectives are read)."""
    for k in KINDS:
        counts[k] = 0
        nbytes[k] = 0
    group_bytes.clear()


def _count(kind: str, t: torch.Tensor, group) -> None:
    n = t.numel() * t.element_size()
    counts[kind] += 1
    nbytes[kind] += n
    key = (kind, tuple(dist.get_process_group_ranks(
        group if group is not None else dist.group.WORLD)))
    group_bytes[key] = group_bytes.get(key, 0) + n


def group_size(group) -> int:
    return dist.get_world_size(group)


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in group
    rank order (= the mesh coordinate's order: group ranks are sorted
    global ranks, and a mesh lays its ranks out in increasing order).
    bool moves as its bytes (gloo takes no bool)."""
    x = x.contiguous()
    _count("all-gather", x, group)
    wire = x.view(_WIRE.get(x.dtype, x.dtype))
    parts: List[torch.Tensor] = [torch.empty_like(wire)
                                 for _ in range(group_size(group))]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts, dim=dim).view(x.dtype)


def all_reduce_min(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise minimum of ``x`` over ``group`` (a new tensor)."""
    out = x.clone()
    _count("all-reduce", out, group)
    dist.all_reduce(out, op=dist.ReduceOp.MIN, group=group)
    return out


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum of ``x`` over ``group`` (a new tensor)."""
    out = x.clone()
    _count("all-reduce", out, group)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise sum of ``x`` over ``group`` (a new tensor)."""
    out = x.clone()
    _count("all-reduce", out, group)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_reduce_sum` in place: ``x`` (which no one else reads)
    overwritten with the sum, without the copy."""
    _count("all-reduce", x, group)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over ``group``, of which this rank keeps its block
    along ``dim`` (the group-rank-th of ``group_size`` equal blocks).
    gloo has no reduce-scatter: there it is an all-reduce of which the
    block is kept (the same sums), counted as the one reduce-scatter the
    program asks for."""
    n = group_size(group)
    _count("reduce-scatter", x, group)
    size = x.shape[dim] // n
    me = group_rank(group)
    if dist.get_backend(group) == "gloo":
        full = x.contiguous().clone()
        dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
        return full.narrow(dim, me * size, size)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((size,) + src.shape[1:], dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def group_rank(group) -> int:
    """This rank's index in ``group`` (its block of a split dim)."""
    return dist.get_group_rank(group, dist.get_rank()) if group is not None \
        else dist.get_rank()


# --- differentiable forms (the module docstring's table) ---------------------


def _grad_on(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, group_rank(ctx.group) * ctx.size,
                        ctx.size), None, None


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PartialGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _SumPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, ctx.dim), None, None


def gather_partial(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """:func:`all_gather_cat` whose downstream gradient is each rank's
    partial: the backward reduce-scatters it (an FSDP gather, the rows of
    a sequence split entering split leaves, context-parallel keys)."""
    if _grad_on(x):
        return _GatherPartial.apply(x, group, dim)
    return all_gather_cat(x, group, dim)


def gather_replicated(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """:func:`all_gather_cat` whose downstream gradient is the whole one on
    every rank: the backward keeps the rank's block (no collective)."""
    if _grad_on(x):
        return _GatherReplicated.apply(x, group, dim)
    return all_gather_cat(x, group, dim)


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of partials over ``group``, used alike on every rank: the
    backward passes the gradient through.  In place without grad."""
    if _grad_on(x):
        return _SumReplicated.apply(x, group)
    return all_reduce_sum_(x, group)


def partial_grads(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself (replicated) entering a rank's split computation: the
    backward all-reduces the partial gradients (nothing moves forward)."""
    if _grad_on(x):
        return _PartialGrads.apply(x, group)
    return x


def sum_partial(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of partials over ``group`` that each rank then uses for its
    own block (a norm's sum of squares over split channels): the backward
    all-reduces the partial gradients.  In place without grad."""
    if _grad_on(x):
        return _SumPartial.apply(x, group)
    return all_reduce_sum_(x, group)


def scatter_sum(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """:func:`reduce_scatter` whose backward all-gathers the rows'
    gradients."""
    if _grad_on(x):
        return _ScatterSum.apply(x, group, dim)
    return reduce_scatter(x, group, dim)


def broadcast_(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``x`` overwritten in place with global rank ``src``'s."""
    _count("broadcast", x, group)
    dist.broadcast(x, src=src, group=group)
    return x


def broadcast_object(obj, src: int = 0, group=None):
    """Rank ``src``'s ``obj`` on every rank of ``group`` (the default group
    when None): a control message, counted as a broadcast without bytes
    (its pickle is not step traffic)."""
    buf = [obj if dist.get_rank() == src else None]
    dist.broadcast_object_list(buf, src=src, group=group)
    counts["broadcast"] += 1
    return buf[0]


def world() -> int:
    """World size of the default group (1 when none is initialized)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0
