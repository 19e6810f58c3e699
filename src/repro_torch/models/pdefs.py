"""Parameter definitions: one tree of ``ParamSpec`` leaves gives a model's
shapes, inits, per-leaf dtypes and logical axes (the JAX package's
``repro.models.pdefs``).  Its MaxText-style rules map the logical axes
onto a rank mesh with the same divisibility fallback (``resolve_specs``,
the reference's PartitionSpec entries as tuples).  A rank's block of a
leaf is its coordinate's contiguous slice of every sharded dim, as a
``NamedSharding`` lays it out (:func:`local_block`: the tensor-parallel
DiT's parameters, ``Placement.shard_params``), and
:func:`dtensor_placements` turns a spec into the ``Shard``/``Replicate``
placements of a ``DeviceMesh`` (``steps.input_specs(mesh=)``).

A params tree is nested dicts and lists laid out as the reference's, so
its leaves have the reference's paths (dict keys, and list indices as
ints): a JAX tree of numpy arrays converts leaf for leaf
(:func:`params_from_numpy`), and checkpoints cross between the packages.
"""
from __future__ import annotations

from typing import Callable, Iterator, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import path_name


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    init: str         # normal | zeros | ones | lecun (the JAX package's inits)
    fan_in: int = 0   # lecun: the size of the dimensions the weight contracts
    scale: Optional[float] = None   # normal: stddev (None = 0.02)
    #: this leaf's dtype whatever the tree's (the reference's ``ParamDef.
    #: dtype``: the SSM decays, the RG-LRU's ``lam`` and the MoE router
    #: stay float32 in a bf16 model)
    dtype: Optional[torch.dtype] = None
    #: logical axis names, one a dim (``LOGICAL_RULES`` maps them onto a
    #: mesh); () = every dim replicated
    axes: Tuple[Optional[str], ...] = ()
    #: how a rank's block is cut (:func:`local_block`): "slice", the
    #: spec's contiguous slice of every sharded dim; "block_diag", for a
    #: (nb, bs, bs) block-diagonal weight whose last dim the spec splits
    #: (the RG-LRU gates), the columns of the rank's contiguous channels
    layout: str = "slice"


def map_defs(fn: Callable, defs, path: Tuple = ()):
    """``fn(path, spec)`` at every leaf of a defs tree, in the tree's
    structure; visited in path order (dict keys sorted, as JAX orders
    them, list items by index)."""
    if isinstance(defs, ParamSpec):
        return fn(path, defs)
    if isinstance(defs, dict):
        return {k: map_defs(fn, defs[k], path + (k,)) for k in sorted(defs)}
    return [map_defs(fn, sub, path + (i,)) for i, sub in enumerate(defs)]


def walk(defs, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, ParamSpec]]:
    """(path, spec) over a defs tree in path order."""
    if isinstance(defs, ParamSpec):
        yield prefix, defs
        return
    items = sorted(defs.items()) if isinstance(defs, dict) else \
        enumerate(defs)
    for key, node in items:
        yield from walk(node, prefix + (key,))


# Logical axis -> mesh axis (or tuple of mesh axes for FSDP over pod+data).
# "fsdp" resolves to ("pod", "data") on the multi-pod mesh, ("data",) single.
LOGICAL_RULES = {
    "vocab": "model",
    "embed": "fsdp",
    "heads": "model",
    "kv_heads": "model",
    "qdim": "model",   # flattened q feature dim (hidden TP strategy)
    "kvdim": "model",
    "mlp": "model",
    "expert": "model",
    "inner": "model",  # mamba2 d_inner / rg-lru width
    "ssm_heads": "model",
    "layers": None,
    "conv": None,
    "norm": None,
    "cond": "model",   # DiT adaLN output dim (6*d)
}


def _mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))


def resolve_axis(logical: Optional[str], dim: int, mesh):
    """A logical axis -> mesh axis (or axes) when ``dim`` divides its size,
    else None (replicated)."""
    if logical is None:
        return None
    target = LOGICAL_RULES.get(logical)
    if target is None:
        return None
    sizes = _mesh_axis_sizes(mesh)
    if target == "fsdp":
        fsdp_axes = tuple(a for a in ("pod", "data") if a in sizes)
        total = int(np.prod([sizes[a] for a in fsdp_axes]))
        if fsdp_axes and dim % total == 0:
            return fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
        # fall back to data-only fsdp if pod*data does not divide
        if "data" in sizes and dim % sizes["data"] == 0:
            return "data"
        return None
    if target in sizes and dim % sizes[target] == 0:
        return target
    return None


def resolve_spec(spec: ParamSpec, mesh) -> Tuple:
    """The mesh axes of each dim of ``spec`` (PartitionSpec entries)."""
    axes = spec.axes or (None,) * len(spec.shape)
    return tuple(resolve_axis(ax, dim, mesh)
                 for ax, dim in zip(axes, spec.shape))


def resolve_specs(defs, mesh):
    return map_defs(lambda _, spec: resolve_spec(spec, mesh), defs)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one PartitionSpec entry (None, a name, or a tuple
    of names), major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def entry_size(entry, mesh) -> int:
    """How many blocks an entry splits its dim into."""
    sizes = _mesh_axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in entry_axes(entry)], dtype=np.int64))


def entry_index(entry, mesh) -> int:
    """This rank's block along an entry: its coordinates on the entry's
    axes, flattened major first (the order of a ``NamedSharding``'s
    blocks, and of the sorted ranks of the axes' process group)."""
    sizes = _mesh_axis_sizes(mesh)
    index = 0
    for axis in entry_axes(entry):
        index = index * sizes[axis] + mesh.get_local_rank(axis)
    return index


def gate_blocks(nb: int, bs: int, parts: int, index: int
                ) -> Tuple[int, int, int, int]:
    """(first block, blocks, first column, columns) of a (nb, bs, bs)
    block-diagonal weight that the channel block ``index`` of ``parts``
    contiguous channel blocks of nb·bs reads: whole blocks where ``parts``
    divides ``nb``, else the columns of one block that ``parts / nb`` ranks
    share (``parts`` a multiple of ``nb`` dividing nb·bs).  Its size,
    nb·bs·bs / parts, is the spec's block (which splits every block's
    columns ``parts`` ways)."""
    if nb % parts == 0:
        k = nb // parts
        return index * k, k, 0, bs
    if parts % nb == 0 and bs % (parts // nb) == 0:
        share = parts // nb
        cols = bs // share
        return index // share, 1, (index % share) * cols, cols
    raise ValueError(f"{parts} channel blocks do not tile {nb} gate blocks "
                     f"of {bs}")


def local_block(x: torch.Tensor, entries: Tuple, mesh,
                layout: str = "slice") -> torch.Tensor:
    """This rank's block of ``x`` under PartitionSpec ``entries``: along
    each sharded dim, the contiguous slice at its :func:`entry_index`; for
    ``layout`` "block_diag" the last dim's entry instead selects the
    columns of the rank's channels (:func:`gate_blocks`).  A copy when it
    is smaller than ``x`` (so the whole can be freed), ``x`` itself when
    every entry is replicated."""
    out = x
    if layout == "block_diag" and entry_axes(entries[-1]):
        nb, bs = x.shape[-3], x.shape[-1]
        b0, nblk, c0, cols = gate_blocks(nb, bs, entry_size(entries[-1], mesh),
                                         entry_index(entries[-1], mesh))
        out = out.narrow(-3, b0, nblk).narrow(-1, c0, cols)
        entries = entries[:-1] + (None,)
    for dim, entry in enumerate(entries):
        if entry_axes(entry):
            size = out.shape[dim] // entry_size(entry, mesh)
            out = out.narrow(dim, entry_index(entry, mesh) * size, size)
    return out.clone() if out.numel() < x.numel() else x


def dtensor_placements(spec: Tuple, mesh) -> list:
    """PartitionSpec entries -> one ``Shard(dim)`` / ``Replicate()`` per
    mesh dim (a mesh dim no tensor dim names is replicated)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.mesh_dim_names]
    for dim, entry in enumerate(spec):
        for axis in entry_axes(entry):
            out[mesh.mesh_dim_names.index(axis)] = Shard(dim)
    return out


def stack_defs(defs, n: int):
    """Prepend a stacked layer axis of size ``n`` to every spec."""
    return map_defs(lambda _, spec: spec._replace(
        shape=(n,) + spec.shape, axes=("layers",) + spec.axes), defs)


def param_count(defs) -> int:
    return int(sum(np.prod(spec.shape) for _, spec in walk(defs)))


def get_path(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def leaf_dtype(spec: ParamSpec, dtype: torch.dtype) -> torch.dtype:
    """The dtype a leaf takes in a tree of ``dtype``."""
    return spec.dtype or dtype


def params_from_numpy(defs, tree, device: DeviceLike = None,
                      dtype=torch.float32, what: str = "param"):
    """Nested dicts/lists of numpy arrays (the JAX layout) -> the same of
    tensors on ``device`` (None = cuda), each leaf in ``dtype`` unless its
    spec names its own.  Every leaf of ``defs`` must be in ``tree`` with
    its shape; raises on a missing leaf or a wrong shape."""
    dev = resolve_device(device)

    def leaf(path, spec):
        arr = np.asarray(get_path(tree, path))
        if tuple(arr.shape) != spec.shape:
            raise ValueError(f"{what} {path_name(path)}: shape "
                             f"{tuple(arr.shape)} != {spec.shape}")
        if arr.dtype.name == "bfloat16":     # ml_dtypes bf16 from JAX
            arr = arr.astype(np.float32)
        if not (arr.flags.writeable and arr.flags.c_contiguous):
            arr = np.array(arr)              # torch wants a writable buffer
        return torch.from_numpy(arr).to(device=dev,
                                        dtype=leaf_dtype(spec, dtype))
    return map_defs(leaf, defs)


def cast_params_(defs, params, dtype: torch.dtype) -> None:
    """Casts ``params`` in place: each leaf to ``dtype`` but those whose
    spec names their own dtype, one leaf at a time, the old leaf dropped
    from its container as its copy is made (a 60 GB float32 tree becomes
    bf16 in 80 GB of device memory)."""
    for path, spec in walk(defs):
        parent = get_path(params, path[:-1])
        parent[path[-1]] = parent[path[-1]].to(leaf_dtype(spec, dtype))


def _std(path, spec: ParamSpec, zero_scales: Mapping[str, float]) -> float:
    if spec.init == "zeros":
        return zero_scales.get(path[-1], 0.0)
    if spec.init == "lecun":
        return 1.0 / np.sqrt(spec.fan_in)
    return 0.02 if spec.scale is None else spec.scale


def init_numpy(defs, seed: int,
               zero_scales: Optional[Mapping[str, float]] = None):
    """Random weights from ``np.random.default_rng(seed)``, float32, drawn
    leaf by leaf in path order: lecun = N(0, 1/fan_in) over the dimensions
    each weight contracts, normal = N(0, scale^2), zeros and ones constant.
    A zeros leaf named in ``zero_scales`` (by its last key) with a scale >
    0 is drawn N(0, scale^2) instead.

    (The JAX initializer takes fan_in as the second-to-last dimension, the
    head count for wq/wk/wv, which saturates the softmax of a random
    model; the port's random weights do not copy that.)"""
    rng = np.random.default_rng(seed)
    zero_scales = zero_scales or {}

    def leaf(path, spec):
        std = _std(path, spec, zero_scales)
        if spec.init == "ones":
            return np.ones(spec.shape, np.float32)
        if std > 0:
            arr = rng.standard_normal(spec.shape, dtype=np.float32)
            arr *= np.float32(std)
            return arr
        return np.zeros(spec.shape, np.float32)
    return map_defs(leaf, defs)


def init_on_device(defs, seed: int, device: DeviceLike = None,
                   dtype=torch.float32):
    """Random weights drawn on ``device`` (None = cuda) from a seeded
    ``torch.Generator`` there, leaf by leaf in path order, each in its
    leaf dtype: the distributions of :func:`init_numpy` (not its values),
    without a float32 copy of the tree on the host — for models too large
    for the numpy path."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def leaf(path, spec):
        dt = leaf_dtype(spec, dtype)
        std = _std(path, spec, {})
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        if std > 0:
            return torch.empty(spec.shape, dtype=dt, device=dev).normal_(
                0.0, std, generator=gen)
        return torch.zeros(spec.shape, dtype=dt, device=dev)
    return map_defs(leaf, defs)
