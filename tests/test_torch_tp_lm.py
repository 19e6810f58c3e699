"""The LM backbones tensor- and sequence-parallel on gloo ranks, against the
unsharded port and the JAX package's GSPMD forward.

Weights are drawn once with numpy (``backbone_init_numpy``, the constant
leaves moved off their inits) and each package gets its own copy.  At each
arch's ``reduced()`` size, float32:

* ``prefill`` (72 tokens: past the 64-token window of recurrentgemma,
  whose MQA cache is split over slots, so its ring wraps) and 4
  ``decode_step``s on a rank's ``ShardedParams`` and ``ShardedCache``
  (``launch.steps.local_cache``) on ``debug`` meshes of (data, model) =
  (2, 1), (1, 2), (2, 2) and (1, 4): the logits and every cache leaf
  gathered back within 1e-5 relative of the unsharded port and of the
  reference's GSPMD-sharded prefill/decode (a subprocess with 4 forced
  host devices on a ``devices=`` mesh, Auto axes); bit for bit at model
  1; collectives per call equal ``backbone.tp_collectives``.  The archs: qwen3
  (heads; at model 4 its 2 KV heads do not divide and the cache splits
  over slots), qwen3 with an int8 cache, qwen2-vl (hidden: context
  parallel, M-RoPE), qwen2-72b (seq_parallel), mamba2, recurrentgemma
  (RG-LRU, local MQA attention, softcap; also a batch of 1 on data 2 and
  a gate-block variant whose ranks share gate blocks) and qwen2-moe.
* ``forward`` and ``lm_loss`` (no grad) on the rank's blocks.
* ``SamplingEngine(param_defs=wrapper_defs(...))`` on ``debug`` (data 2
  x model 2) with qwen3 and mamba2 as eps_theta: ``run_batch`` within
  1e-4 relative of the host port, iters and nfe equal.

The ranks (``python -m tests.test_torch_tp_lm CASE ...``, one group of 4
through ``tests.test_torch_spawn.spawn``) import torch and the port only.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_spawn import _init, _main, spawn

#: arch (or variant) -> (registry arch, config changes)
ARCHS = {
    "qwen3-0.6b": ("qwen3-0.6b", {}),
    "qwen3-0.6b+int8": ("qwen3-0.6b", {"kv_quant": True}),
    "qwen2-vl-2b": ("qwen2-vl-2b", {}),
    "qwen2-72b": ("qwen2-72b", {}),
    "mamba2-1.3b": ("mamba2-1.3b", {}),
    "recurrentgemma-2b": ("recurrentgemma-2b", {}),
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}),
}
#: (data, model) meshes every arch runs on; (2, 1) is held bit for bit
MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]
#: extra (arch, mesh, batch, gate blocks) cases: a batch of 1 that data 2
#: does not divide, and RG-LRU gate blocks shared by 2 ranks of model 4
EXTRA = [("recurrentgemma-2b", (2, 2), 1, None),
         ("recurrentgemma-2b", (1, 4), 2, 2)]
B, S, STEPS = 2, 72, 4            # batch, prefill tokens, decode steps
SEED = 5
#: the wrapper engine: solver steps, latent tokens and dim, requests
T, NT, LATENT = 10, 8, 8
WRAP_ARCHS = ["qwen3-0.6b", "mamba2-1.3b"]
#: decode tolerance where it is not 1e-5: the int8 cache's rounding ties
DECODE_TOL = {"qwen3-0.6b+int8": 1e-3}
#: leaves initialized to zeros or ones, moved off their inits
CONSTANT_INITS = ("bq", "bk", "bv", "scale", "A_log", "dt_bias", "D", "b_a",
                  "b_i")


def _cfg(name: str):
    from repro_torch.configs.registry import get_arch

    arch, changes = ARCHS[name]
    return dataclasses.replace(get_arch(arch).reduced(), **changes)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _perturb(tree, seed: int):
    rng = np.random.default_rng(seed)

    def walk(node):
        items = sorted(node.items()) if isinstance(node, dict) else \
            enumerate(node)
        for key, sub in items:
            if isinstance(sub, (dict, list)):
                walk(sub)
            elif key in CONSTANT_INITS:
                node[key] = sub + (0.1 * rng.standard_normal(
                    sub.shape)).astype(np.float32)
    walk(tree)
    return tree


def _flat(tree, prefix: str) -> dict:
    from repro_torch.tree import flatten_with_paths, path_name

    return {f"{prefix}/{path_name(p)}": a
            for p, a in flatten_with_paths(tree)}


def _tree(inputs: dict, prefix: str, defs):
    """The numpy tree of ``defs`` from ``inputs``' ``prefix/<path>``
    entries."""
    from repro_torch.models.pdefs import map_defs
    from repro_torch.tree import path_name

    return map_defs(lambda path, _: inputs[f"{prefix}/{path_name(path)}"],
                    defs)


def _tokens(cfg, b: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "embed":
        return (rng.standard_normal((b, s, cfg.d_model)) * 0.3).astype(
            np.float32)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# --- rank side ------------------------------------------------------------------


def _gate_blocks(nb):
    """Context: the RG-LRU's gate block count set to ``nb`` (None: as
    is)."""
    import contextlib

    from repro_torch.models import rglru

    @contextlib.contextmanager
    def ctx():
        old = rglru.NUM_GATE_BLOCKS
        if nb:
            rglru.NUM_GATE_BLOCKS = nb
        try:
            yield
        finally:
            rglru.NUM_GATE_BLOCKS = old
    return ctx()


def _lm_run(params, cfg, x, cache):
    """prefill(x[:, :S]) (every row's logits), then the rest decoded one
    token at a time: (prefill logits, decode logits, the collectives of
    the prefill and of each decode)."""
    import torch

    from repro_torch import comm
    from repro_torch.models import backbone as bb

    kinds = ("all-gather", "all-reduce", "reduce-scatter")
    with torch.no_grad():
        comm.reset()
        plog, _ = bb.prefill(params, cfg, x[:, :S], cache, last_only=False)
        counts = [{k: comm.counts[k] for k in kinds}]
        outs = []
        for t in range(S, x.shape[1]):
            comm.reset()
            d, _ = bb.decode_step(params, cfg, x[:, t:t + 1], cache)
            counts.append({k: comm.counts[k] for k in kinds})
            outs.append(d)
    return plog, torch.cat(outs, 1), counts


def _lm_part(rank: int, inputs: dict) -> dict:
    """Every (arch, mesh) case on this rank: the TP prefill/decode against
    the unsharded port on the same rows; rank 0 of a (2, 2) mesh also
    returns its results for the parent's comparison with the
    reference."""
    import torch

    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import backbone as bb
    from repro_torch.models import pdefs
    from repro_torch.models.convert import backbone_params_from_numpy
    from repro_torch.models.shardctx import ShardedParams
    from repro_torch.tree import flatten_with_paths, path_name

    cases = [(a, m, B, None) for a in ARCHS for m in MESHES] + EXTRA
    out, arrays = {}, {}
    for name, (data, model), b, nb in cases:
        mesh = make_mesh("debug", data_parallel=data, model_parallel=model,
                         ranks=range(data * model), device_type="cpu")
        if mesh.get_coordinate() is None:
            continue
        key = f"{name}/{data}x{model}/b{b}" + (f"/nb{nb}" if nb else "")
        with _gate_blocks(nb):
            cfg = _cfg(name)
            defs = bb.build_defs(cfg)
            tree = _tree(inputs, f"w/{name}" + (f"/nb{nb}" if nb else ""),
                         defs)
            params = backbone_params_from_numpy(tree, cfg, "cpu",
                                                torch.float32)
            x = torch.from_numpy(inputs[f"x/{name}"][:b])
            if x.dtype == torch.int32:
                x = x.long()
            ba = pdefs.resolve_axis("embed", b, mesh)
            rows = b // data if ba else b
            lo = mesh.get_local_rank("data") * rows if ba else 0
            xl = x[lo:lo + rows]
            host_cache = bb.init_cache(cfg, rows, S + STEPS, torch.float32,
                                      "cpu")
            want = _lm_run(params, cfg, xl, host_cache)
            tp = ShardedParams.build(params, defs, mesh)
            cache = St.local_cache(cfg, b, S + STEPS, mesh, torch.float32,
                                   "cpu")
            got = _lm_run(tp, cfg, xl, cache)
            whole = cache.gather()
            cache_rel = {}
            for (path, a), (_, w) in zip(flatten_with_paths(whole),
                                         flatten_with_paths(host_cache)):
                if path[-1] == "index":
                    cache_rel[path_name(path)] = float(torch.equal(a, w))
                else:
                    # the gathered batch dim (after a stack dim) holds
                    # every data shard's rows
                    stacked = not cfg.is_hybrid or "periods" in path
                    a = a.narrow(int(stacked), lo, rows)
                    if a.dtype == torch.int8:   # [max, mean] level diff
                        diff = (a.int() - w.int()).abs().double()
                        cache_rel[path_name(path)] = [
                            float(diff.max()), float(diff.mean())]
                    else:
                        cache_rel[path_name(path)] = _rel(a, w)
            with torch.no_grad():
                fwd_t, _ = bb.forward(tp, cfg, xl)
                fwd_h, _ = bb.forward(params, cfg, xl)
                labels = torch.from_numpy(inputs[f"labels/{name}"][:b])
                batch = {"inputs": xl, "labels": labels[lo:lo + rows]}
                loss_t = float(bb.lm_loss(tp, cfg, batch))
                # the mean over the data shards of each shard's loss (the
                # MoE's aux loss is each shard's, averaged, as the
                # reference's shard_map takes it)
                shards = range(0, b, rows)
                loss_h = float(sum(bb.lm_loss(params, cfg, {
                    "inputs": x[k:k + rows], "labels": labels[k:k + rows]})
                    for k in shards)) / len(shards)
            rec = {
                "prefill": _rel(got[0], want[0]),
                "decode": _rel(got[1], want[1]),
                "bitwise": bool(torch.equal(got[0], want[0])
                                and torch.equal(got[1], want[1])),
                "counts": got[2], "cache": cache_rel,
                "forward": _rel(fwd_t, fwd_h),
                "forward_bitwise": bool(torch.equal(fwd_t, fwd_h)),
                "loss": abs(loss_t - loss_h) / abs(loss_h),
                "rows": [lo, rows]}
            out[key] = rec
            if (data, model) == (2, 2) and b == B and nb is None \
                    and mesh.get_local_rank("model") == 0:
                arrays[f"{name}/{lo}/prefill"] = got[0].numpy()
                arrays[f"{name}/{lo}/decode"] = got[1].numpy()
                for path, a in flatten_with_paths(whole):
                    arrays[f"{name}/cache/{path_name(path)}"] = a.numpy()
    return out, arrays


def _wrapper_part(inputs: dict) -> dict:
    """The wrapper engine with ``param_defs`` on debug (data 2 x model 2)
    against the host placement, for each of :data:`WRAP_ARCHS`."""
    import torch

    from repro_torch.core import ddim_coeffs
    from repro_torch.diffusion import dit
    from repro_torch.diffusion.convert import wrapper_params_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sampling import (Placement, SampleRequest,
                                      SamplingEngine, get_sampler)

    mesh = make_mesh("debug", data_parallel=2, model_parallel=2,
                     device_type="cpu")
    plc = Placement.for_mesh(mesh)
    out = {}
    reqs = [SampleRequest(label=0, seed=60 + i) for i in range(4)]
    for name in WRAP_ARCHS:
        cfg = _cfg(name)
        defs = dit.wrapper_defs(cfg, LATENT)
        params = wrapper_params_from_numpy(
            _tree(inputs, f"wrap/{name}", defs), cfg, LATENT, "cpu")

        def eps(p, x, taus, y):
            return dit.wrapper_apply(p, cfg, x, taus)

        def engine(placement, defs_=None):
            return SamplingEngine(
                eps, params, ddim_coeffs(T), get_sampler("taa"),
                sample_shape=(NT, LATENT), device="cpu",
                placement=placement, param_defs=defs_)

        with torch.inference_mode():
            want = engine(None).run_batch(reqs, batch_size=4)
            eng = engine(plc, defs)
            got = eng.run_batch(reqs, batch_size=4)
        out[name] = {
            "sharded": eng.denoiser_sharded,
            "rel": max(_rel(a.trajectory, b.trajectory)
                       for a, b in zip(got, want)),
            "iters": [[r.iters, r.nfe] for r in got],
            "want_iters": [[r.iters, r.nfe] for r in want]}
    return out


def _case_lm(rank: int, world: int, workdir: Path) -> dict:
    """Every multi-rank check of this file in one group of 4 gloo ranks."""
    _init(rank, world, workdir)
    inputs = dict(np.load(workdir / "inputs.npz"))
    lm, arrays = _lm_part(rank, inputs)
    np.savez(workdir / f"port{rank}.npz", **arrays)
    return {"lm": lm, "wrapper": _wrapper_part(inputs)}


CASES = {"lm": _case_lm}


# --- parent side (jax lives here) --------------------------------------------------


REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import get_arch
from repro.launch.mesh import make_mesh
from repro.launch.steps import _cache_spec_for
from repro.models import backbone as jb, pdefs as jpdefs
from repro.models.shardctx import use_mesh

out_path, in_path, S, steps = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    int(sys.argv[4])
inputs = dict(np.load(in_path))
archs = [(n, a, dict(kv_quant=n.endswith("+int8")))
         for n, a in (x.split("=") for x in sys.argv[5].split(","))]
# the devices= path: a plain Mesh with Auto axes
mesh = make_mesh("debug", data_parallel=2, model_parallel=2,
                 devices=jax.devices())
arrays = {}
for name, arch, changes in archs:
    cfg = dataclasses.replace(get_arch(arch).reduced(), **changes)
    defs = jb.build_defs(cfg)
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        defs, is_leaf=jpdefs.is_def)
    leaves = []
    for path, d in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        arr = jnp.asarray(np.array(inputs[f"w/{name}/{key}"]), jnp.float32)
        if d.dtype:
            arr = arr.astype(d.dtype)
        spec = P(*jpdefs.resolve_spec(d, mesh))
        leaves.append(jax.device_put(arr, NamedSharding(mesh, spec)))
    params = jax.tree_util.tree_unflatten(treedef, leaves)
    x = inputs[f"x/{name}"]
    b = x.shape[0]
    cache = jb.init_cache(cfg, b, S + steps, jnp.float32)

    def place(path, leaf):
        pstr = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        stacked = (not cfg.is_hybrid) or ("periods" in pstr)
        if "index" in pstr:
            spec = P(*([None] * leaf.ndim))
        elif stacked:
            spec = P(None, *_cache_spec_for(pstr, leaf.shape[1:], mesh))
        else:
            spec = _cache_spec_for(pstr, leaf.shape, mesh)
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    cache = jax.tree_util.tree_map_with_path(place, cache)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(
        mesh, P("data", *([None] * (x.ndim - 1)))))
    with use_mesh(mesh):
        prefill = jax.jit(lambda p, x, c: jb.prefill(p, cfg, x, c,
                                                     last_only=False))
        decode = jax.jit(lambda p, x, c: jb.decode_step(p, cfg, x, c))
        plog, cache = prefill(params, xs[:, :S], cache)
        outs = []
        for t in range(S, S + steps):
            d, cache = decode(params, xs[:, t:t + 1], cache)
            outs.append(np.asarray(d))
    arrays[f"{name}/prefill"] = np.asarray(plog)
    arrays[f"{name}/decode"] = np.concatenate(outs, 1)
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        arrays[f"{name}/cache/{key}"] = np.asarray(leaf)
np.savez(out_path, **arrays)
"""


@pytest.fixture(scope="module")
def lm_runs(tmp_path_factory):
    """One group of 4 gloo ranks runs every multi-rank check
    (``_case_lm``) while the reference's GSPMD prefill/decode runs on a
    (2, 2) ``devices=`` mesh in a subprocess; returns (each rank's
    results, the port's (2, 2) arrays, the reference's)."""
    from repro_torch.diffusion.convert import wrapper_init_numpy
    from repro_torch.models.convert import backbone_init_numpy
    from tests.test_torch_placement import _run_reference, _wait

    work = tmp_path_factory.mktemp("tp_lm")
    arrays = {}
    for i, name in enumerate(ARCHS):
        cfg = _cfg(name)
        arrays.update(_flat(_perturb(backbone_init_numpy(cfg, SEED + i),
                                     SEED + 10 + i), f"w/{name}"))
        arrays[f"x/{name}"] = _tokens(cfg, B, S + STEPS, SEED + 20 + i)
        arrays[f"labels/{name}"] = np.random.default_rng(i).integers(
            0, cfg.vocab_size, (B, S + STEPS)).astype(np.int64)
    for _, _, _, nb in EXTRA:
        if nb:
            with _gate_blocks(nb):
                cfg = _cfg("recurrentgemma-2b")
                arrays.update(_flat(_perturb(backbone_init_numpy(cfg, 1),
                                             2),
                                    f"w/recurrentgemma-2b/nb{nb}"))
    for name in WRAP_ARCHS:
        arrays.update(_flat(wrapper_init_numpy(_cfg(name), LATENT, 3,
                                               out_scale=0.05),
                            f"wrap/{name}"))
    np.savez(work / "inputs.npz", **arrays)
    archs = ",".join(f"{n}={a}" for n, (a, _) in ARCHS.items())
    ref = _run_reference(REF_SCRIPT, work / "ref.npz", work / "inputs.npz",
                         S, STEPS, archs)
    try:
        outs = spawn("lm", 4, work, timeout=600,
                     module="tests.test_torch_tp_lm")
    finally:
        _wait(ref, timeout=600)
    port = {}
    for r in range(4):
        port.update(dict(np.load(work / f"port{r}.npz")))
    return outs, port, dict(np.load(work / "ref.npz"))


def _cases(outs):
    for rank, out in enumerate(outs):
        for key, rec in out["lm"].items():
            yield rank, key, rec


@pytest.mark.parametrize("name", list(ARCHS))
def test_tp_prefill_decode_match_unsharded_port(lm_runs, name):
    """Each arch on every mesh: prefill, decode and every cache leaf
    within 1e-5 of the unsharded port on the rank's rows; bit for bit at
    model 1; ``forward`` within 1e-5 and ``lm_loss`` within 1e-5.  The
    int8 cache by the rule of ``tests/test_torch_backbone.py::
    test_int8_cache_matches_jax``: a value may move one level where x /
    scale sits at a rounding tie (the rank's k and v come from another
    product's rounding), so its decode logits hold 1e-3."""
    seen = set()
    for rank, key, rec in _cases(lm_runs[0]):
        if not key.startswith(name + "/"):
            continue
        mesh = key.split("/")[1]
        seen.add(mesh)
        assert rec["prefill"] < 1e-5 and rec["forward"] < 1e-5, (key, rec)
        assert rec["decode"] < DECODE_TOL.get(name, 1e-5), (key, rec)
        assert rec["loss"] < 1e-5, (key, rec)
        for leaf, err in rec["cache"].items():
            if leaf.endswith("index"):
                assert err == 1.0, (key, leaf)
            elif isinstance(err, list):
                assert err[0] <= 1 and err[1] < 1e-3, (key, leaf, err)
            else:
                assert err < 1e-5, (key, leaf, err)
        if mesh.endswith("x1"):
            assert rec["bitwise"] and rec["forward_bitwise"], (key, rec)
    assert seen == {f"{d}x{m}" for d, m in MESHES}


@pytest.mark.parametrize("name", list(ARCHS))
def test_tp_collectives_equal_the_formula(lm_runs, name):
    """Each call's collectives on every mesh equal
    ``backbone.tp_collectives`` (its docstring is the formula)."""
    from repro_torch.models.backbone import tp_collectives

    for _, key, rec in _cases(lm_runs[0]):
        if not key.startswith(name + "/"):
            continue
        data, model = map(int, key.split("/")[1].split("x"))
        nb = int(key.split("/nb")[1]) if "/nb" in key else None
        with _gate_blocks(nb):
            cfg = _cfg(name)
            cap = S + STEPS if not cfg.window_size else min(cfg.window_size,
                                                           S + STEPS)
            prefill, *decodes = rec["counts"]
            assert prefill == tp_collectives(cfg, "prefill", model, data, S,
                                             cap), (key, prefill)
            for got in decodes:
                assert got == tp_collectives(cfg, "decode", model, data, 1,
                                             cap), (key, got)


@pytest.mark.parametrize("name", list(ARCHS))
def test_tp_matches_the_reference_gspmd_forward(lm_runs, name):
    """(2, 2): the port's TP prefill and decode logits (each data shard's
    rows) and its final cache gathered back within 1e-5 of the
    reference's GSPMD-sharded prefill/decode."""
    _, port, ref = lm_runs
    for half, tol in (("prefill", 1e-5),
                      ("decode", DECODE_TOL.get(name, 1e-5))):
        got = np.concatenate([port[f"{name}/{lo}/{half}"]
                              for lo in (0, B // 2)])
        assert _rel(got, ref[f"{name}/{half}"]) < tol, (name, half)
    keys = [k for k in port if k.startswith(f"{name}/cache/")]
    assert keys and sorted(keys) == sorted(
        k for k in ref if k.startswith(f"{name}/cache/"))
    for key in keys:
        if key.endswith("index"):
            assert np.array_equal(port[key], ref[key]), key
        elif port[key].dtype == np.int8:
            diff = np.abs(port[key].astype(np.int32)
                          - ref[key].astype(np.int32))
            assert diff.max() <= 1 and diff.mean() < 1e-3, key
        else:
            assert _rel(port[key], ref[key]) < 1e-5, key


@pytest.mark.parametrize("case", EXTRA, ids=["batch1-data2", "shared-gates"])
def test_tp_recurrentgemma_extra_cases(lm_runs, case):
    """A batch of 1 on data 2 (replicated over data, as the reference's
    fallback), and RG-LRU gate blocks shared by pairs of model-4 ranks
    (the block's inputs all-gathered over the pair)."""
    name, (data, model), b, nb = case
    key = f"{name}/{data}x{model}/b{b}" + (f"/nb{nb}" if nb else "")
    recs = [rec for _, k, rec in _cases(lm_runs[0]) if k == key]
    assert len(recs) == data * model
    for rec in recs:
        assert rec["prefill"] < 1e-5 and rec["decode"] < 1e-5, rec
        assert all(e < 1e-5 or k.endswith("index")
                   for k, e in rec["cache"].items()), rec["cache"]
        if b == 1:
            assert rec["rows"] == [0, 1]


@pytest.mark.parametrize("name", WRAP_ARCHS)
def test_tp_wrapper_engine_matches_host(lm_runs, name):
    """``SamplingEngine(param_defs=wrapper_defs(...))`` on debug (data 2 x
    model 2): each rank's trajectories within 1e-4 of the host port,
    iters and nfe equal."""
    for out in lm_runs[0]:
        rec = out["wrapper"][name]
        assert rec["sharded"], rec
        assert rec["rel"] < 1e-4, rec
        assert rec["iters"] == rec["want_iters"], rec
        assert max(i for i, _ in rec["iters"]) > 1, rec     # exercised


def test_tp_lm_at_one_rank_is_the_host_path_and_forward_only(tmp_path):
    """A world of one gloo rank in this process: the (1, 1) mesh's
    ``ShardedParams``/``ShardedCache`` give the host path's bits for
    prefill, decode and ``forward``; under grad ``forward`` (remat on)
    gives the host path's gradients of every block, bit for bit."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps as St
    from repro_torch.models import backbone as bb
    from repro_torch.models.convert import backbone_init
    from repro_torch.models.shardctx import ShardedParams

    cfg = _cfg("recurrentgemma-2b")
    params = backbone_init(cfg, SEED, "cpu")
    x = torch.from_numpy(_tokens(cfg, 2, 20, SEED)).long()
    tmesh.init_distributed("cpu", world_size=1, rank=0,
                           init_method=f"file://{tmp_path}/rendezvous",
                           timeout_s=60)
    try:
        mesh = tmesh.make_mesh("debug", data_parallel=1, model_parallel=1,
                               device_type="cpu")
        tp = ShardedParams.build(params, bb.build_defs(cfg), mesh)
        host_cache = bb.init_cache(cfg, 2, 20, torch.float32, "cpu")
        cache = St.local_cache(cfg, 2, 20, mesh, torch.float32, "cpu")
        with torch.no_grad():
            for p, c in ((params, host_cache), (tp, cache)):
                p_log, _ = bb.prefill(p, cfg, x[:, :16], c, last_only=False)
                d_log = [bb.decode_step(p, cfg, x[:, t:t + 1], c)[0]
                         for t in range(16, 20)]
                if p is params:
                    want = (p_log, d_log, bb.forward(p, cfg, x)[0])
            assert torch.equal(p_log, want[0])
            assert all(torch.equal(a, b) for a, b in zip(d_log, want[1]))
            assert torch.equal(bb.forward(tp, cfg, x)[0], want[2])
        from repro_torch.tree import leaves

        grads = []
        for p in (params, tp):
            flat = leaves(p.local if p is tp else p)
            for leaf in flat:
                leaf.requires_grad_(True)
            logits, _ = bb.forward(p, cfg, x)
            grads.append(torch.autograd.grad(logits.square().sum(), flat))
            for leaf in flat:
                leaf.requires_grad_(False)
        assert all(torch.equal(a, b) for a, b in zip(*grads))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1:], CASES)
