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
    over ``model``.  Given a plain tree it runs every head on every rank;
  * the LM backbones' tensor parallelism (``models.backbone`` given a
    ``ShardedParams`` of ``build_defs``, and a :class:`ShardedCache`): a
    rank holds what the reference's specs give it, and each layer reads
    its layout through a :class:`LayerTP` — which leaves are split over
    ``model``, the residual's rows over ``model`` (Megatron sequence
    parallelism: all-gathered into a sublayer, its row-parallel partials
    reduce-scattered out) or whole (partials all-reduced), and the split
    of each of its cache leaves (``launch.steps.cache_partition``, the
    reference's ``_cache_spec_for``);
  * the backward of both, which GSPMD derives: each collective above is
    one of ``comm``'s differentiable forms, chosen by what its call site's
    downstream gradient is (``comm``'s table).  A sublayer whose leaves
    are split over ``model`` (or whose rows come gathered from a split)
    computes on each rank's partial gradient, so the leaves it holds
    whole get partial gradients too (``backbone.partial_leaves`` names
    them from the specs); :meth:`ShardedParams.sync_grads` all-reduces
    those over ``model`` and the leaves replicated over the data axes over
    data, and :meth:`ShardedParams.norm_counted` says which
    blocks a rank counts in the mesh's global gradient norm (each element
    once).
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
                x if place is None else place(x), entries, mesh,
                spec.layout))
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

    def sub(self, key: str) -> "ShardedParams":
        """The carrier of the subtree at ``key`` (its paths without the
        ``key/`` prefix), on the same mesh and groups."""
        pre = f"{key}/"
        return dataclasses.replace(
            self, local=self.local[key],
            specs={p[len(pre):]: e for p, e in self.specs.items()
                   if p.startswith(pre)})

    @property
    def model_size(self) -> int:
        return int(_sizes(self.mesh).get(self.model_axis, 1))

    @property
    def model_rank(self) -> int:
        return self.mesh.get_local_rank(self.model_axis) \
            if self.model_axis in self.mesh.mesh_dim_names else 0

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
        blocks of one dtype split over the same axes move in one flat
        all-gather; axes of one rank move nothing."""
        todo: Dict[Tuple, list] = {}
        for path, x in blocks.items():
            for dim, entry in enumerate(self._entries(path, x.dim())):
                axes = entry_axes(entry)
                if axes and self.model_axis not in axes \
                        and comm.group_size(self.groups[axes]) > 1:
                    todo.setdefault((axes, x.dtype), []).append((path, dim))
        out = dict(blocks)
        for (axes, _), items in todo.items():
            group = self.groups[axes]
            n = comm.group_size(group)
            # each data rank's gradient of the whole leaf is its rows'
            # partial: the backward reduce-scatters them into its block
            flat = comm.gather_partial(torch.cat(
                [blocks[p].reshape(-1) for p, _ in items]), group, 0
            ).view(n, -1)
            start = 0
            for path, dim in items:
                x = blocks[path]
                part = flat[:, start:start + x.numel()].reshape(n, *x.shape)
                out[path] = part.movedim(0, dim).flatten(dim, dim + 1)
                start += x.numel()
        return out

    def gather_tree(self, prefix: str, tree):
        """A subtree of blocks (``tree``, leaf paths under ``prefix``), a
        layer's for instance, with its data-axis splits all-gathered in
        one flat all-gather (:meth:`gather`)."""
        from repro_torch.tree import flatten_with_paths, path_name, unflatten

        items = [(prefix + path_name(p), x)
                 for p, x in flatten_with_paths(tree)]
        full = self.gather(dict(items))
        return unflatten(tree, [full[k] for k, _ in items])

    @property
    def model_group(self):
        if (self.model_axis,) not in self.groups \
                and self.model_axis in self.mesh.mesh_dim_names:
            self.groups[(self.model_axis,)] = self.mesh.get_group(
                self.model_axis)
        return self.groups.get((self.model_axis,))

    def data_group(self):
        """The process group over the mesh's data axes (``pod``, ``data``)
        that holds this rank, or None without them."""
        from repro_torch.launch.mesh import axes_group

        axes = tuple(a for a in ("pod", "data")
                     if a in self.mesh.mesh_dim_names)
        if not axes:
            return None
        if axes not in self.groups:
            self.groups[axes] = axes_group(self.mesh, axes)
        return self.groups[axes]

    def model_cat(self, path: str, x: torch.Tensor,
                  dim: int = -1) -> torch.Tensor:
        """The columns of a column-parallel product by ``path``'s leaf,
        all-gathered over model (``x`` itself where the leaf is whole),
        used alike on every rank: the backward keeps the rank's
        columns."""
        if not self.sharded(path):
            return x
        return comm.gather_replicated(x, self.model_group, dim % x.dim())

    def model_sum(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """The partial sums of a row-parallel product by ``path``'s leaf,
        added over model (in place without grad: ``x`` is a product no one
        else reads; ``x`` as it is where the leaf is whole)."""
        if not self.sharded(path):
            return x
        return comm.sum_replicated(x, self.model_group)

    def model_in(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """A replicated ``x`` entering a product by ``path``'s leaf split
        over model: the backward all-reduces its partial gradients
        (Megatron's *f*; ``x`` itself where the leaf is whole)."""
        if not self.sharded(path):
            return x
        return comm.partial_grads(x, self.model_group)

    # --- the gradient sync and the global norm --------------------------------

    def _axes(self) -> Dict[str, int]:
        """The model and data axes of more than one rank (a train step
        splits nothing else)."""
        return {a: int(n) for a, n in _sizes(self.mesh).items()
                if int(n) > 1 and a in (self.model_axis, "pod", "data")}

    def _split_axes(self, path: str) -> set:
        return {a for e in self.specs[path] for a in entry_axes(e)}

    def sync_grads(self, grads, partial=()) -> None:
        """Completes a rank's gradients of its blocks (``grads`` in
        ``leaves(self.local)`` order), in place: the leaves replicated over
        data axes of more than one rank all-reduced over those axes, and
        the leaves whose paths are in ``partial`` (held whole over
        ``model``, each rank's gradient a partial:
        ``backbone.partial_leaves``) all-reduced over ``model`` (of more
        than one rank) — one flat all-reduce per (axes, dtype).
        (The FSDP-split leaves were reduce-scattered by their gather's
        backward; the model-split ones are whole.)"""
        from repro_torch.launch.mesh import axes_group

        axes = self._axes()
        todo: Dict[Tuple, list] = {}
        for i, path in enumerate(self.specs):
            split = self._split_axes(path)
            over = tuple(a for a in ("pod", "data")
                         if a in axes and a not in split)
            if over:
                todo.setdefault((over, grads[i].dtype), []).append(i)
            if self.model_axis in axes and path in partial:
                todo.setdefault(((self.model_axis,), grads[i].dtype),
                                []).append(i)
        for (over, _), idx in todo.items():
            group = self.model_group if over == (self.model_axis,) else \
                axes_group(self.mesh, over)
            flat = comm.all_reduce_sum_(
                torch.cat([grads[i].reshape(-1) for i in idx]), group)
            start = 0
            for i in idx:
                n = grads[i].numel()
                grads[i].copy_(flat[start:start + n].view_as(grads[i]))
                start += n

    def norm_counted(self) -> list:
        """Per leaf (``leaves(self.local)`` order), whether this rank's
        block counts in the mesh's gradient norm: split blocks by every
        rank of their groups, a block replicated over an axis by the rank
        at coordinate 0 of it — every element once over the mesh."""
        axes = self._axes()
        zero = {a: self.mesh.get_local_rank(a) == 0 for a in axes}
        return [all(zero[a] for a in axes if a not in self._split_axes(p))
                for p in self.specs]

    def norm_groups(self) -> list:
        """The groups the squared norm's partial sums are all-reduced over:
        ``model`` and the data axes, those of more than one rank."""
        axes = self._axes()
        out = [self.model_group] if self.model_axis in axes else []
        if any(a in axes for a in ("pod", "data")):
            out.append(self.data_group())
        return out


@dataclasses.dataclass(eq=False)
class ShardedCache:
    """A rank's blocks of a decode cache on a mesh: ``local`` the tree of
    blocks (each leaf's contiguous slice of the dims its PartitionSpec
    entries split), ``specs`` leaf path -> those entries (from
    ``launch.steps.cache_partition``, the reference's ``_cache_spec_for``:
    the batch over the data axes, KV heads over ``model`` where they
    divide, else the cache's slots — the context-parallel fallback —
    mamba2's heads and channels and the RG-LRU's channels over
    ``model``)."""
    local: object
    specs: Dict[str, Tuple]
    mesh: object

    def __getitem__(self, key):
        return self.local[key]

    @classmethod
    def zeros(cls, whole, partition, mesh, device) -> "ShardedCache":
        """Zeros on ``device`` in the blocks that ``partition`` ((path,
        entries) of every leaf of ``whole``, a cache of global shapes,
        e.g. on ``meta``) gives this rank."""
        from repro_torch.models.pdefs import entry_size
        from repro_torch.tree import flatten_with_paths, path_name, unflatten

        specs, blocks = {}, []
        for (path, x), (ppath, entries) in zip(flatten_with_paths(whole),
                                               partition):
            assert tuple(path) == tuple(ppath), (path, ppath)
            shape = [n // entry_size(e, mesh) for n, e in
                     zip(x.shape, entries)]
            specs[path_name(path)] = tuple(entries)
            blocks.append(torch.zeros(shape, dtype=x.dtype, device=device))
        return cls(unflatten(whole, blocks), specs, mesh)

    def gather(self):
        """The whole cache on every rank: each split dim of each block
        all-gathered over its axes (exact; for checks and tests)."""
        from repro_torch.launch.mesh import axes_group
        from repro_torch.tree import flatten_with_paths, path_name, unflatten

        out = []
        for path, x in flatten_with_paths(self.local):
            for dim, entry in enumerate(self.specs[path_name(path)]):
                axes = entry_axes(entry)
                if axes:
                    x = comm.all_gather_cat(x, axes_group(self.mesh, axes),
                                            dim)
            out.append(x)
        return unflatten(self.local, out)


def remat_tp(remat: bool, fn, *args, **kw):
    """``fn(*args, **kw)``, recomputed in the backward pass when
    ``remat``: every op again, collectives included (no early stop), so
    every rank makes the same collective calls in the same order."""
    if not remat:
        return fn(*args, **kw)
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

    with set_checkpoint_early_stop(False):
        return checkpoint(fn, *args, **kw, use_reentrant=False)


class _ShareGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, parts):
        ctx.parts = parts
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.parts, None


@dataclasses.dataclass(eq=False)
class LayerTP:
    """One layer's tensor-parallel view: its leaves' paths in ``params``
    (``prefix`` + a leaf's name in the layer), the PartitionSpec entries of
    its cache leaves (the layer's own dims), and whether the residual's
    rows are split over ``model`` (``seq_split``: ``seq_len`` rows in all,
    this rank's contiguous block of them).  A sublayer whose leaves are
    split over ``model`` takes the rows in through :meth:`rows_in` and
    gives its partials back through :meth:`rows_out`."""
    params: ShardedParams
    prefix: str = ""
    cache: Dict[str, Tuple] = dataclasses.field(default_factory=dict)
    seq_split: bool = False
    seq_len: int = 0

    def sharded(self, name: str) -> bool:
        return self.params.sharded(self.prefix + name)

    @property
    def size(self) -> int:
        return self.params.model_size

    @property
    def rank(self) -> int:
        return self.params.model_rank

    @property
    def group(self):
        return self.params.model_group

    @property
    def row0(self) -> int:
        """The first global row this rank holds (0 without a split)."""
        return self.rank * (self.seq_len // self.size) if self.seq_split \
            else 0

    def rows_in(self, x: torch.Tensor, name: Optional[str] = None
                ) -> torch.Tensor:
        """Every row of the residual ``x`` (B, S/m, ...) as the input of
        the sublayer that leaf ``name`` decides (e.g. ``attn/wq``):
        all-gathered over ``model`` under a split, else ``x``.  Where the
        rows are split or ``name`` is split over ``model`` the sublayer
        computes on each rank's partial gradient: the gather's backward
        reduce-scatters it, an unsplit ``x``'s all-reduces it (the
        sublayer's whole leaves get partial gradients:
        ``backbone.partial_leaves``).  A sublayer of whole leaves on whole
        rows (``name`` None or whole, no split) is the same on every rank,
        and nothing changes."""
        if not self.seq_split and (name is None or not self.sharded(name)):
            return x
        if not self.seq_split:
            return comm.partial_grads(x, self.group)
        return comm.gather_partial(x, self.group, 1)

    def share_grad(self, y: torch.Tensor) -> torch.Tensor:
        """``y``, the same on every rank, leaving a sublayer that computes
        on each rank's partial gradient: the backward hands each rank
        1/``size`` of its whole gradient (no collective)."""
        if self.size == 1 or not (torch.is_grad_enabled()
                                  and y.requires_grad):
            return y
        return _ShareGrad.apply(y, self.size)

    def rows_whole(self, x: torch.Tensor) -> torch.Tensor:
        """Every row of the residual ``x`` for a use that is the same on
        every rank (its gradient whole on each): the gather's backward
        keeps the rank's rows."""
        if not self.seq_split:
            return x
        return comm.gather_replicated(x, self.group, 1)

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole-row ``x`` under a split."""
        if not self.seq_split:
            return x
        n = self.seq_len // self.size
        return x.narrow(1, self.rank * n, n)

    def rows_out(self, name: str, y: torch.Tensor) -> torch.Tensor:
        """A sublayer's output in the residual's layout: the row-parallel
        partials of leaf ``name`` reduce-scattered over the rows under a
        split (the backward all-gathers the rows' gradients), else
        all-reduced (in place without grad); a product by a whole leaf is
        complete (its own rows kept under a split)."""
        if not self.sharded(name):
            return self.own_rows(y)
        if self.seq_split:
            return comm.scatter_sum(y, self.group, 1)
        return comm.sum_replicated(y, self.group)

    def sum(self, y: torch.Tensor) -> torch.Tensor:
        """Partials over ``model`` added (whole rows; in place without
        grad)."""
        return comm.sum_replicated(y, self.group)

    def cache_split(self, name: str, dim: int) -> Tuple[int, int]:
        """(parts, index) of the split of cache leaf ``name``'s dim ``dim``
        over ``model`` ((1, 0) where it is whole)."""
        from repro_torch.models.pdefs import entry_index, entry_size

        entries = self.cache.get(name)
        if not entries or not entry_axes(entries[dim]):
            return 1, 0
        entry = entries[dim]
        return entry_size(entry, self.params.mesh), \
            entry_index(entry, self.params.mesh)
