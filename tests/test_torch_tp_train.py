"""The tensor-parallel train step on gloo ranks, against the unsharded port's
train step and the JAX package's GSPMD train step.

``launch.steps.make_train_step`` on a rank's ``ShardedParams`` (forward,
backward, grad_accum, the gradient sync, the mesh's global-norm clip and
AdamW on the rank's blocks; the batch the rank's rows of each global
microbatch, ``steps.local_batch``) runs 2 steps with grad_accum 2 at each
arch's ``reduced()`` size at 2 layers (a hybrid: one period and a
tail), float32, from one numpy init (the constant and
adaLN-zero leaves moved off their inits, so that every block's gradient
is live), each package its own copy:

* the DiT on (data, model) = (2, 2), (1, 2), (2, 1) and (1, 4); qwen3
  (heads), qwen2-vl (hidden: context parallel), qwen2-72b
  (seq_parallel), mamba2, recurrentgemma (one period and a tail) and
  qwen2-moe on (2, 2) and (1, 2).  Losses and ``grad_norm`` within 1e-5
  relative of the unsharded port's step on the global batch, each rank's
  blocks within 1e-5 of each leaf's largest entry (5e-5 for the adaLN
  leaves, as ``tests/test_torch_train.py`` holds them against the
  reference); qwen2-moe against the mean of the per-shard losses of each
  microbatch, since its aux loss is each data shard's.  The collectives a
  step (``comm``, backward included) equal ``dit.tp_train_collectives`` /
  ``backbone.tp_train_collectives``;
* the DiT, qwen3, mamba2 and qwen2-moe on (2, 2) against the reference's
  jitted ``make_train_step`` on a ``devices=`` (2, 2) mesh (a subprocess
  with 4 forced host devices, Auto axes), by the same rule;
* a world of one in this process, mesh (1, 1): the DiT's and qwen3's TP
  step bit for bit the host step ((2, 1) is not: the mean of two
  half-batch means rounds otherwise than the whole batch's).

The ranks (``python -m tests.test_torch_tp_train CASE ...``, one group of
4 through ``tests.test_torch_spawn.spawn``) import torch and the port
only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_helpers import one_torch_thread  # noqa: F401
from tests.test_torch_spawn import _init, _main, spawn
from tests.test_torch_tp_lm import _flat, _perturb, _tokens, _tree

ARCHS = ["dit-xl", "qwen3-0.6b", "qwen2-vl-2b", "qwen2-72b", "mamba2-1.3b",
         "recurrentgemma-2b", "qwen2-moe-a2.7b"]
#: (data, model) meshes of every arch; the DiT's also (2, 1) and (1, 4)
MESHES = [(2, 2), (1, 2)]
DIT_MESHES = MESHES + [(2, 1), (1, 4)]
#: the archs also held to the reference's GSPMD train step at (2, 2)
REF_ARCHS = ["dit-xl", "qwen3-0.6b", "mamba2-1.3b", "qwen2-moe-a2.7b"]
STEPS, GA = 2, 2
B_DIT, NT = 8, 16                  # DiT batch and latent tokens
B_LM, S = 4, 16                    # LM batch and tokens
SEED = 11
ADA_SCALE = 0.05
#: the adaLN leaves, held at 5e-5 (tests/test_torch_train.py)
ADA = ("ada", "final_ada")


def _layers(cfg) -> int:
    """The depth of a reduced config here: 2 layers, a hybrid's one period
    group and a tail layer."""
    return cfg.rglru_ratio + 1 if cfg.is_hybrid else 2


def _cfg(name: str):
    from repro_torch.configs.registry import get_arch

    cfg = get_arch(name).reduced()
    return dataclasses.replace(cfg, num_layers=_layers(cfg))


def _defs(cfg):
    from repro_torch.diffusion import dit
    from repro_torch.models import backbone as bb

    return dit.dit_defs(cfg) if cfg.is_diffusion else bb.build_defs(cfg)


def _meshes(name: str):
    return DIT_MESHES if name == "dit-xl" else MESHES


def _weights(name: str, i: int) -> dict:
    from repro_torch.diffusion.convert import dit_init_numpy
    from repro_torch.models.convert import backbone_init_numpy

    cfg = _cfg(name)
    if cfg.is_diffusion:
        return dit_init_numpy(cfg, SEED, ada_scale=ADA_SCALE)
    return _perturb(backbone_init_numpy(cfg, SEED + i), SEED + 10 + i)


def _batches(name: str, i: int) -> list:
    """STEPS global batches of numpy arrays."""
    cfg = _cfg(name)
    rng = np.random.default_rng(SEED + 20 + i)
    out = []
    for k in range(STEPS):
        if cfg.is_diffusion:
            out.append({
                "latents": rng.standard_normal(
                    (B_DIT, NT, cfg.latent_dim)).astype(np.float32),
                "noise": rng.standard_normal(
                    (B_DIT, NT, cfg.latent_dim)).astype(np.float32),
                "t": rng.integers(0, 1000, B_DIT).astype(np.int32),
                "labels": rng.integers(0, cfg.num_classes,
                                       B_DIT).astype(np.int32)})
        else:
            out.append({"inputs": _tokens(cfg, B_LM, S, SEED + 30 + 7 * i
                                          + k),
                        "labels": rng.integers(0, cfg.vocab_size,
                                               (B_LM, S)).astype(np.int32)})
    return out


def _rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def _leaf_errs(got: dict, want: dict) -> dict:
    """leaf path -> max |got - want| over the leaf's largest |want|."""
    return {k: float(np.abs(np.asarray(got[k], np.float64)
                            - np.asarray(want[k], np.float64)).max()
                     / max(np.abs(want[k]).max(), 1e-30)) for k in want}


def _ok_params(errs: dict) -> bool:
    return all(e < (5e-5 if k.split("/")[-1] in ADA else 1e-5)
               for k, e in errs.items())


# --- rank side ------------------------------------------------------------------


def _params(cfg, tree):
    import copy

    import torch

    from repro_torch.models.pdefs import params_from_numpy

    return params_from_numpy(_defs(cfg), copy.deepcopy(tree), "cpu",
                             torch.float32)


def _torch_batch(batch: dict) -> dict:
    import torch

    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _host_moe_grads(cfg, data: int):
    """The host's (loss, grads) of a batch whose loss is each microbatch's
    mean over its ``data`` shards of the shard's ``lm_loss`` (the MoE aux
    loss is a shard's), accumulated as ``steps.make_grads_fn`` does."""
    import torch

    from repro_torch.launch import steps as St
    from repro_torch.models import backbone as bb
    from repro_torch.tree import leaves, unflatten

    def grads_of(params, batch):
        flat = leaves(params)
        rows = next(iter(batch.values())).shape[0]
        mb = rows // GA
        n = mb // data
        for p in flat:
            p.requires_grad_(True)
        loss, sums = None, None
        for m in range(GA):
            l = sum(bb.lm_loss(params, cfg, {
                k: v[m * mb + r * n:m * mb + (r + 1) * n]
                for k, v in batch.items()}) for r in range(data)) / data
            g = torch.autograd.grad(l, flat, allow_unused=True,
                                    materialize_grads=True)
            with torch.no_grad():
                loss = l.detach() if loss is None else loss + l.detach()
                sums = St.accumulate_grads(sums, g)
        for p in flat:
            p.requires_grad_(False)
        for acc in sums:
            acc.mul_(1.0 / GA)
        return loss * (1.0 / GA), unflatten(params, sums)
    return grads_of


@contextlib.contextmanager
def _first_grads(out: list):
    """Records in ``out`` a copy of the grads the first AdamW update of a
    train step takes (``steps.adamw_update``, which ``make_train_step``
    and :func:`_host_moe_step` call)."""
    from repro_torch.launch import steps as St
    from repro_torch.tree import map_tree

    real = St.adamw_update

    def update(grads, *args, **kw):
        if not out:
            out.append(map_tree(lambda g: g.clone(), grads))
        return real(grads, *args, **kw)
    St.adamw_update = update
    try:
        yield out
    finally:
        St.adamw_update = real


def _host_moe_step(cfg, data: int):
    """The host step of :func:`_host_moe_grads`' loss."""
    from repro_torch.launch import steps as St
    from repro_torch.optim import AdamWConfig, lr_schedule

    opt_cfg = AdamWConfig()
    grads_of = _host_moe_grads(cfg, data)

    def step(params, opt, batch, i):
        loss, grads = grads_of(params, batch)
        lr = lr_schedule(i, base_lr=opt_cfg.lr, total_steps=10_000)
        params, opt, metrics = St.adamw_update(grads, opt, params, opt_cfg,
                                               lr)
        return params, opt, {"loss": loss, **metrics}
    return step


def _host_run(cfg, tree, batches, data: int):
    """The unsharded port's STEPS train steps on the global batches:
    (params, losses, grad norms, the first step's grads)."""
    import torch

    from repro_torch.launch import steps as St
    from repro_torch.optim import adamw_init

    params = _params(cfg, tree)
    opt = adamw_init(params)
    step = _host_moe_step(cfg, data) if cfg.is_moe else \
        St.make_train_step(cfg, grad_accum=GA)
    losses, norms = [], []
    with _first_grads([]) as grads:
        for i, b in enumerate(batches):
            params, opt, m = step(params, opt, _torch_batch(b),
                                  torch.tensor(i, dtype=torch.int32))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return params, losses, norms, grads[0]


def _tp_run(cfg, tree, batches, mesh):
    """The TP train step on this rank's blocks: (ShardedParams, losses,
    grad norms, collectives a step, the first step's synced grads of the
    blocks)."""
    import torch

    from repro_torch import comm
    from repro_torch.launch import steps as St
    from repro_torch.models.shardctx import ShardedParams
    from repro_torch.optim import adamw_init

    tp = ShardedParams.build(_params(cfg, tree), _defs(cfg), mesh)
    opt = adamw_init(tp.local)
    step = St.make_train_step(cfg, grad_accum=GA)
    losses, norms, counts = [], [], []
    with _first_grads([]) as grads:
        for i, b in enumerate(batches):
            comm.reset()
            tp, opt, m = step(tp, opt,
                              St.local_batch(_torch_batch(b), mesh, GA),
                              torch.tensor(i, dtype=torch.int32))
            counts.append({k: comm.counts[k] for k in
                           ("all-gather", "all-reduce", "reduce-scatter")})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return tp, losses, norms, counts, grads[0]


def _case_train(rank: int, world: int, workdir: Path) -> dict:
    """Every (arch, mesh) case on this rank, one group of 4; the ranks of
    a (2, 2) case of :data:`REF_ARCHS` also save their blocks."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import pdefs
    from repro_torch.tree import flatten_with_paths, path_name

    _init(rank, world, workdir)
    inputs = dict(np.load(workdir / "inputs.npz"))
    out, arrays, host = {}, {}, {}
    for name in ARCHS:
        cfg = _cfg(name)
        defs = _defs(cfg)
        tree = _tree(inputs, f"w/{name}", defs)
        batches = [{k[len(f"b/{name}/{i}/"):]: v for k, v in inputs.items()
                    if k.startswith(f"b/{name}/{i}/")}
                   for i in range(STEPS)]
        for data, model in _meshes(name):
            mesh = make_mesh("debug", data_parallel=data,
                             model_parallel=model,
                             ranks=range(data * model), device_type="cpu")
            if mesh.get_coordinate() is None:
                continue
            key = (name, data if cfg.is_moe else 0)
            if key not in host:
                host[key] = _host_run(cfg, tree, batches, data)
            hp, hl, hn, hg = host[key]
            tp, tl, tn, counts, tg = _tp_run(cfg, tree, batches, mesh)
            layouts = {path_name(p): s.layout for p, s in pdefs.walk(defs)}

            def block_errs(blocks, wholes):
                """The rank's block of each leaf against its whole leaf's
                largest entry."""
                out = {}
                for (path, block), (_, whole) in zip(
                        flatten_with_paths(blocks),
                        flatten_with_paths(wholes)):
                    k = path_name(path)
                    want = pdefs.local_block(whole, tp.specs[k], mesh,
                                             layouts[k])
                    out[k] = float((block.double() - want.double()).abs()
                                   .max() / max(float(whole.abs().max()),
                                                1e-30))
                return out
            got = {path_name(p): x.numpy()
                   for p, x in flatten_with_paths(tp.local)}
            errs, gerrs = block_errs(tp.local, hp), block_errs(tg, hg)
            out[f"{name}/{data}x{model}"] = {
                "loss": [_rel(a, b) for a, b in zip(tl, hl)],
                "grad_norm": [_rel(a, b) for a, b in zip(tn, hn)],
                "params": errs, "grads": gerrs, "counts": counts,
                "losses": tl, "norms": tn,
                "coord": mesh.get_coordinate(),
                "specs": {k: [list(pdefs.entry_axes(e)) for e in v]
                          for k, v in tp.specs.items()}}
            if (data, model) == (2, 2) and name in REF_ARCHS:
                for k, v in got.items():
                    arrays[f"{name}/{k}"] = v
    np.savez(workdir / f"port{rank}.npz", **arrays)
    return out


CASES = {"train": _case_train}


# --- parent side (jax lives here) --------------------------------------------------


REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import contextlib, dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import get_arch
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh
from repro.models import backbone as jb, pdefs as jpdefs
from repro.diffusion import dit as jdit
from repro.models.shardctx import use_mesh
from repro.optim import adamw_init

out_path, in_path, steps, ga = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    int(sys.argv[4])
inputs = dict(np.load(in_path))
# the devices= path: a plain Mesh with Auto axes
mesh = make_mesh("debug", data_parallel=2, model_parallel=2,
                 devices=jax.devices())
make_loss_fn = jsteps.make_loss_fn


def shard_mean_loss(cfg):
    # each microbatch's mean over its 2 data shards of the shard's loss
    def loss_fn(params, batch):
        n = next(iter(batch.values())).shape[0] // 2
        return sum(jb.lm_loss(params, cfg, {k: v[r * n:(r + 1) * n]
                                            for k, v in batch.items()})
                   for r in range(2)) / 2
    return loss_fn


def load(name, cfg, on_mesh):
    defs = jdit.dit_defs(cfg) if cfg.is_diffusion else jb.build_defs(cfg)
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        defs, is_leaf=jpdefs.is_def)
    leaves, keys = [], []
    for path, d in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        arr = jnp.asarray(np.array(inputs[f"w/{name}/{key}"]), jnp.float32)
        if on_mesh:
            spec = P(*jpdefs.resolve_spec(d, mesh))
            arr = jax.device_put(arr, NamedSharding(mesh, spec))
        leaves.append(arr)
        keys.append(key)
    return jax.tree_util.tree_unflatten(treedef, leaves), keys


def batch_of(name, i, on_mesh):
    pre = f"b/{name}/{i}/"
    batch = {k[len(pre):]: jnp.asarray(v) for k, v in inputs.items()
             if k.startswith(pre)}
    if on_mesh:
        batch = {k: jax.device_put(v, NamedSharding(
            mesh, P("data", *([None] * (v.ndim - 1)))))
            for k, v in batch.items()}
    return batch


def run(name, cfg, on_mesh):
    params, keys = load(name, cfg, on_mesh)
    opt = adamw_init(params)
    jsteps.make_loss_fn = make_loss_fn if on_mesh else shard_mean_loss
    step = jax.jit(jsteps.make_train_step(cfg, grad_accum=ga))
    losses, norms = [], []
    with use_mesh(mesh) if on_mesh else contextlib.nullcontext():
        for i in range(steps):
            params, opt, m = step(params, opt, batch_of(name, i, on_mesh),
                                  jnp.int32(i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out = {"loss": np.asarray(losses), "grad_norm": np.asarray(norms)}
    for key, leaf in zip(keys, jax.tree_util.tree_leaves(params)):
        out[f"p/{key}"] = np.asarray(leaf, np.float32)
    return out


out = {}
for name in sys.argv[5].split(","):
    cfg = dataclasses.replace(get_arch(name).reduced(), num_layers=2)
    if not cfg.is_moe:
        out.update({f"{name}/{k}": v for k, v in run(name, cfg, True).items()})
        continue
    # the first step's loss on the mesh (the mean of its microbatches'),
    # and the step of the same loss jitted without a mesh
    params, _ = load(name, cfg, True)
    loss = jax.jit(lambda p, b: jb.lm_loss(p, cfg, b))
    batch = batch_of(name, 0, True)
    mb = next(iter(batch.values())).shape[0] // ga
    with use_mesh(mesh):
        out[f"{name}/loss"] = np.asarray([sum(float(loss(params, {
            k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}))
            for i in range(ga)) / ga])
    out.update({f"{name}/local/{k}": v
                for k, v in run(name, cfg, False).items()})
np.savez(out_path, **out)
"""


def _assemble(port: dict, outs: list, name: str) -> dict:
    """The whole leaves of ``name``'s (2, 2) run from the 4 ranks' blocks
    (each split dim's block at the rank's coordinates on its axes)."""
    key = f"{name}/2x2"
    recs = [(r, o[key]) for r, o in enumerate(outs) if key in o]
    axes = ("data", "model")
    whole = {}
    for leaf, entries in recs[0][1]["specs"].items():
        blocks = [(rec["coord"], port[r][f"{name}/{leaf}"])
                  for r, rec in recs]
        shape = list(blocks[0][1].shape)
        for dim, ax in enumerate(entries):
            shape[dim] *= int(np.prod([2 for _ in ax]))
        out = np.zeros(shape, np.float32)
        for coord, block in blocks:
            idx = []
            for dim, ax in enumerate(entries):
                i = 0
                for a in ax:
                    i = i * 2 + coord[axes.index(a)]
                n = block.shape[dim]
                idx.append(slice(i * n, (i + 1) * n))
            out[tuple(idx)] = block
        whole[leaf] = out
    return whole


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """One group of 4 gloo ranks runs every case (``_case_train``) while
    the reference's GSPMD train steps run on a (2, 2) ``devices=`` mesh in
    a subprocess; returns (each rank's results, each rank's saved blocks,
    the reference's arrays)."""
    from tests.test_torch_placement import _run_reference, _wait

    work = tmp_path_factory.mktemp("tp_train")
    arrays = {}
    for i, name in enumerate(ARCHS):
        arrays.update(_flat(_weights(name, i), f"w/{name}"))
        for k, b in enumerate(_batches(name, i)):
            arrays.update({f"b/{name}/{k}/{key}": v for key, v in b.items()})
    np.savez(work / "inputs.npz", **arrays)
    ref = _run_reference(REF_SCRIPT, work / "ref.npz", work / "inputs.npz",
                         STEPS, GA, ",".join(REF_ARCHS))
    try:
        outs = spawn("train", 4, work, timeout=600,
                     module="tests.test_torch_tp_train")
    finally:
        _wait(ref, timeout=600)
    port = [dict(np.load(work / f"port{r}.npz")) for r in range(4)]
    return outs, port, dict(np.load(work / "ref.npz"))


def _recs(outs, name: str):
    for out in outs:
        for key, rec in out.items():
            if key.split("/")[0] == name:
                yield key, rec


@pytest.mark.parametrize("name", ARCHS)
def test_tp_train_step_matches_the_unsharded_port(train_runs, name):
    """Every mesh: 2 steps' losses and grad norms within 1e-5 relative of
    the unsharded port's train step, and the rank's blocks of every leaf
    within 1e-5 of the leaf's largest entry (5e-5 for the adaLN leaves);
    the first batch's synced gradients of every block within 1e-5 of its
    leaf's largest gradient entry (Adam's first steps move an element by
    about the sign of its gradient, so the params alone would not see a
    gradient's scale)."""
    seen = set()
    for key, rec in _recs(train_runs[0], name):
        seen.add(key.split("/")[1])
        assert max(rec["grads"].values()) < 1e-5, (key, {
            k: e for k, e in rec["grads"].items() if e >= 1e-5})
        assert max(rec["loss"]) < 1e-5, (key, rec["loss"])
        assert max(rec["grad_norm"]) < 1e-5, (key, rec["grad_norm"])
        assert _ok_params(rec["params"]), (key, {
            k: e for k, e in rec["params"].items() if e >= 1e-5})
    assert seen == {f"{d}x{m}" for d, m in _meshes(name)}


@pytest.mark.parametrize("name", ARCHS)
def test_tp_train_collectives_equal_the_formula(train_runs, name):
    """Each step's collectives, counted by ``comm`` with the backward's,
    equal ``dit.tp_train_collectives`` / ``backbone.tp_train_collectives``
    (their docstrings are the formula)."""
    from repro_torch.diffusion import dit
    from repro_torch.models import backbone as bb

    cfg = _cfg(name)
    for key, rec in _recs(train_runs[0], name):
        data, model = map(int, key.split("/")[1].split("x"))
        want = dit.tp_train_collectives(cfg, model, data, GA) \
            if cfg.is_diffusion else \
            bb.tp_train_collectives(cfg, model, data, S, GA)
        assert all(c == want for c in rec["counts"]), (key, rec["counts"],
                                                       want)


@pytest.mark.parametrize("name", REF_ARCHS)
def test_tp_train_step_matches_the_reference_gspmd_step(train_runs, name):
    """(2, 2): the port's TP losses and grad norms within 1e-5 relative of
    the reference's jitted train step on a ``devices=`` (2, 2) mesh, and
    its blocks, assembled, within 1e-5 of each leaf's largest entry (5e-5
    for the adaLN leaves).  qwen2-moe: the reference's expert-parallel MoE
    (its ``shard_map``) on that mesh gives the loss but not its gradient
    (a known gap of the reference: its sharded gradient differs from the
    jitted gradient of the same per-shard loss without a mesh), so the
    port's first loss is held to the reference's loss on the mesh and the
    whole step to the reference's step of the same loss jitted without a
    mesh."""
    outs, port, ref = train_runs
    rec = next(rec for key, rec in _recs(outs, name) if key.endswith("2x2"))
    whole = _assemble(port, outs, name)
    if name == "qwen2-moe-a2.7b":
        assert _rel(rec["losses"][0], ref[f"{name}/loss"][0]) < 1e-5, \
            (rec["losses"], ref[f"{name}/loss"])
        name = f"{name}/local"
    for a, b in zip(rec["losses"], ref[f"{name}/loss"]):
        assert _rel(a, b) < 1e-5, (rec["losses"], ref[f"{name}/loss"])
    for a, b in zip(rec["norms"], ref[f"{name}/grad_norm"]):
        assert _rel(a, b) < 1e-5, (rec["norms"], ref[f"{name}/grad_norm"])
    want = {k: ref[f"{name}/p/{k}"] for k in whole}
    errs = _leaf_errs(whole, want)
    assert _ok_params(errs), {k: e for k, e in errs.items() if e >= 1e-5}


@pytest.mark.usefixtures("one_torch_thread")
def test_tp_train_step_at_one_rank_is_the_host_step(tmp_path):
    """A world of one gloo rank in this process, mesh (1, 1): the DiT's and
    qwen3's TP train step (2 steps, grad_accum 2) give the host step's
    losses, grad norms and params bit for bit, and its collectives equal
    the formula."""
    import torch
    import torch.distributed as dist

    from repro_torch.diffusion import dit
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import backbone as bb
    from repro_torch.tree import leaves

    tmesh.init_distributed("cpu", world_size=1, rank=0,
                           init_method=f"file://{tmp_path}/rendezvous",
                           timeout_s=60)
    try:
        mesh = tmesh.make_mesh("debug", data_parallel=1, model_parallel=1,
                               device_type="cpu")
        for i, name in enumerate(["dit-xl", "qwen3-0.6b"]):
            cfg = _cfg(name)
            tree, batches = _weights(name, i), _batches(name, i)
            hp, hl, hn, _ = _host_run(cfg, tree, batches, 1)
            tp, tl, tn, counts, _ = _tp_run(cfg, tree, batches, mesh)
            assert tl == hl and tn == hn, (name, tl, hl, tn, hn)
            assert all(torch.equal(a, b) for a, b in
                       zip(leaves(tp.local), leaves(hp))), name
            want = dit.tp_train_collectives(cfg, 1, 1, GA) \
                if cfg.is_diffusion else \
                bb.tp_train_collectives(cfg, 1, 1, S, GA)
            assert all(c == want for c in counts), (name, counts, want)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1:], CASES)
