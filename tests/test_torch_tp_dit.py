"""The tensor-parallel DiT on gloo ranks, against the unsharded port and the
JAX package's GSPMD-sharded DiT.

Weights are drawn once by ``dit_init_numpy`` (the port's lecun over the
contracted dims, so wq/wk need no rescale; adaLN-zero leaves N(0, 0.05²))
and each package gets its own copy.

* ``dit_apply`` on a rank's ``ShardedParams`` (``Placement.shard_params``
  with ``dit_defs``) on ``debug`` meshes of (data, model) = (1, 2),
  (2, 1) and (2, 2): within 1e-5 relative of the unsharded port and of the
  reference's ``dit_apply``; bit for bit at model = 1; its collectives
  equal the formula (2L all-reduces and L + 1 all-gathers over model,
  L + 1 over data, none over data of one rank); each block equals the
  ``to_local()`` of ``distribute_params``' DTensor.
* ``SamplingEngine(param_defs=dit_defs)`` — ``run_batch`` and a stepwise
  drain with a mid-solve refill — on ``debug`` (data 2 × model 2) and
  ``debug-time`` (time 2 × model 2): within 1e-4 relative of the host
  port and of the reference's own ``make_engine`` on a ``devices=`` mesh
  (a subprocess with 4 forced host devices), iters/nfe equal, collectives
  per iteration by the formula.
* A resilient drain over the TP engine that loses 2 of 4 ranks: the
  survivors re-slice the weights onto their mesh, every ticket within
  1e-4 of the drain without faults.
* A world of one in this process: the TP path is the host path's bits.
* ``serve.main --mesh debug --model-parallel 2`` on the 4 ranks prints
  the host run's iters/nfe.

The ranks (``python -m tests.test_torch_tp_dit CASE ...``, through
``tests.test_torch_spawn.spawn``, one group for every multi-rank check)
import torch and the port only.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_spawn import _init, _main, spawn

T, NT = 10, 8                    # solver steps, latent tokens
SEED, ADA = 3, 0.05              # the weights' draw
SEEDS = [50, 51, 52, 53, 11, 12, 13]
#: the serving CLI's run, with and without ``--mesh``
SERVE_ARGV = ["--device", "cpu", "--smoke", "--requests", "4", "--steps-T",
              "8", "--batch-size", "2"]
#: dit_apply's meshes: (data, model)
DIT_MESHES = {"model2": (1, 2), "data2": (2, 1), "data2xmodel2": (2, 2)}
MESHES = {"debug": dict(data_parallel=2, model_parallel=2),
          "debug-time": dict(data_parallel=1, time_parallel=2,
                             model_parallel=2)}


def _cfg():
    from repro_torch.configs.registry import get_arch

    return get_arch("dit-xl").reduced()


def _tree(inputs: dict):
    """The numpy weight tree from ``inputs`` ("p/<path>" entries)."""
    tree = {}
    for name, arr in inputs.items():
        if name.startswith("p/"):
            *path, leaf = name[2:].split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = arr
    return tree


def _flat(tree, prefix="p") -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}/{key}"))
        else:
            out[f"{prefix}/{key}"] = val
    return out


def dit_counts(L: int, data: int) -> dict:
    """Collectives of one tensor-parallel DiT call whose every leaf
    divides its mesh: 2L all-reduces over model; L + 1 all-gathers over
    model (the adaLN columns) and, over data axes of more than one rank,
    L + 1 of the embed rows (a block's leaves in one flat all-gather, the
    top-level leaves in another)."""
    return {"all-reduce": 2 * L,
            "all-gather": (L + 1) + (L + 1 if data > 1 else 0)}


def distribute_params(plc, params, defs):
    """The reference layout as ``DTensor``s: each leaf of ``params``
    distributed from the mesh's first rank by its logical axes
    (``pdefs.dtensor_placements``), whose ``to_local()`` must be the block
    ``Placement.shard_params`` gives."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import pdefs
    from repro_torch.tree import leaves, unflatten

    return unflatten(params, [
        distribute_tensor(x, plc.mesh, pdefs.dtensor_placements(
            pdefs.resolve_spec(spec, plc.mesh), plc.mesh))
        for x, (_, spec) in zip(leaves(params), pdefs.walk(defs))])


def _noise(inputs: dict):
    """The engines' noise: the JAX package's draw for each request seed."""
    import torch

    return lambda request: torch.from_numpy(
        inputs[f"noise_seed{request.seed}"])


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --- rank side ------------------------------------------------------------------


def _dit_part(inputs: dict, params) -> dict:
    """One ``dit_apply`` on this rank's blocks against the whole tree, on
    each mesh of ``DIT_MESHES`` (a 2-rank mesh over ranks 0 and 1; the
    others build it and sit out)."""
    import torch

    from repro_torch import comm
    from repro_torch.diffusion import dit
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sampling import Placement
    from repro_torch.tree import leaves

    cfg = _cfg()
    defs = dit.dit_defs(cfg)
    args = (torch.from_numpy(inputs["lat"]), torch.from_numpy(inputs["t"]),
            torch.from_numpy(inputs["y"]))
    with torch.no_grad():
        host = dit.dit_apply(params, cfg, *args)
    out = {}
    for name, (data, model) in DIT_MESHES.items():
        plc = Placement.for_mesh(make_mesh(
            "debug", data_parallel=data, model_parallel=model,
            ranks=range(data * model), device_type="cpu"))
        if not plc.is_member:
            continue
        sharded = plc.shard_params(params, defs)
        with torch.no_grad():
            comm.reset()
            got = dit.dit_apply(sharded, cfg, *args)
            counts = {k: comm.counts[k] for k in ("all-gather",
                                                  "all-reduce")}
        dtensors = distribute_params(plc, params, defs)
        out[name] = {
            "host": _rel(got.numpy(), host.numpy()),
            "jax": _rel(got.numpy(), inputs["eps_jax"]),
            "bitwise": bool(torch.equal(got, host)), "counts": counts,
            "wq": list(sharded["blocks"]["wq"].shape),
            "same_blocks": all(torch.equal(a, b.to_local()) for a, b in
                               zip(leaves(sharded.local),
                                   leaves(dtensors))),
            "describe": plc.describe(True)}
    return out


def _engine_part(rank: int, inputs: dict, params, workdir: Path) -> dict:
    """``run_batch`` and a stepwise drain through the TP engine on each
    mesh of ``MESHES``, against the host placement; rank 0 writes the
    trajectories to ``port.npz``."""
    import torch

    from repro_torch import comm
    from repro_torch.core import ddim_coeffs
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sampling import (Placement, SampleRequest,
                                      get_sampler)

    cfg = _cfg()

    def engine(placement):
        return serve.make_engine(params, cfg, ddim_coeffs(T),
                                 get_sampler("taa"), num_tokens=NT,
                                 device="cpu", noise_fn=_noise(inputs),
                                 placement=placement)

    reqs = [SampleRequest(label=i % 4, seed=50 + i) for i in range(4)]

    def drain(eng):
        bank = eng.stepwise_open(2, chunk_iters=2)
        rq = [SampleRequest(label=0, seed=11, quality_steps=1),
              SampleRequest(label=1, seed=12),
              SampleRequest(label=2, seed=13)]
        eng.stepwise_refill(bank, [0, 1], rq[:2])
        queued, got, rounds = [rq[2]], {}, 0
        while any(r is not None for r in bank.requests) or queued:
            eng.stepwise_step(bank)
            for lane, res in eng.stepwise_harvest(bank):
                got[res.request.seed] = res
                if queued:
                    eng.stepwise_refill(bank, [lane], [queued.pop()])
            rounds += 1
            assert rounds < 100
        return [got[k] for k in sorted(got)]

    with torch.inference_mode():
        host = engine(None)
        want = host.run_batch(reqs, batch_size=4)
        want_drain = drain(host)
        out, arrays = {}, {}
        for name, kw in MESHES.items():
            plc = Placement.for_mesh(make_mesh(name, device_type="cpu",
                                               **kw))
            eng = engine(plc)
            comm.reset()
            got = eng.run_batch(reqs, batch_size=4)
            counts = {k: comm.counts[k] for k in ("all-gather",
                                                  "all-reduce")}
            got_drain = drain(eng)
            out[name] = {
                "sharded": eng.denoiser_sharded,
                "report": {k: eng.last_dispatches[-1][k] for k in (
                    "model_shards", "data_shards", "time_shards",
                    "denoiser_sharded", "device_iters")},
                "counts": counts,
                "host": max(_rel(a.trajectory, b.trajectory) for a, b in
                            zip(got + got_drain, want + want_drain)),
                "same_iters": [(a.iters, a.nfe) for a in got + got_drain]
                == [(b.iters, b.nfe) for b in want + want_drain]}
            for i, r in enumerate(got + got_drain):
                arrays[f"{name}/{i}"] = r.trajectory
                arrays[f"{name}/{i}/info"] = np.asarray([r.iters, r.nfe])
    if rank == 0:
        np.savez(workdir / "port.npz", **arrays)
    return out


def _chaos_part(rank: int, inputs: dict, params) -> dict:
    """A resilient drain of the TP engine (``serve.make_engine``) on debug
    (data 2 x model 2) that loses 2 ranks at round 2, against the same
    drain without faults: the survivors' engines re-slice the weights
    onto their (1, 2) mesh."""
    import torch

    from repro_torch.core import ddim_coeffs
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.shardctx import ShardedParams
    from repro_torch.sampling import Placement, SampleRequest, get_sampler
    from repro_torch.serving import (Batcher, BatchingPolicy, EngineKey,
                                     EngineRegistry, FaultInjector,
                                     RequestQueue, ResilientServingLoop)

    cfg = _cfg()
    key = EngineKey("dit-xl", T, "taa")

    def factory(k, plc):
        return serve.make_engine(params, cfg, ddim_coeffs(k.T),
                                 get_sampler(k.solver), num_tokens=NT,
                                 device="cpu", noise_fn=_noise(inputs),
                                 placement=plc)

    plc = Placement.for_mesh(make_mesh("debug", data_parallel=2,
                                       model_parallel=2, device_type="cpu"))
    reqs = [SampleRequest(label=i % 4, seed=s) for i, s in enumerate(SEEDS)]

    def drain(injector):
        queue = RequestQueue()
        loop = ResilientServingLoop(
            EngineRegistry(lambda k: factory(k, plc)), queue,
            Batcher(BatchingPolicy(max_batch=2)), engine_factory=factory,
            placement=plc, injector=injector, chunk_iters=1)
        tickets = [queue.submit(r, key) for r in reqs] \
            if loop.control.leader else []
        loop.drain()
        return loop, tickets

    with torch.inference_mode():
        _, base = drain(None)
        loop, tickets = drain(FaultInjector({2: 2}))
    out = {"member": loop._serving()}
    if loop._serving():
        engine = loop.registry.get(key)
        out.update(sharded=isinstance(engine.params, ShardedParams),
                   wq=list(engine.params["blocks"]["wq"].shape),
                   placement=engine.placement.describe(True))
    if rank == 0:
        ref = [t.result(timeout=0) for t in base]
        got = [t.result(timeout=0) for t in tickets]
        out.update(resolved=[len(ref), len(got)],
                   rel=max(_rel(a.x0, b.x0) for a, b in zip(got, ref)),
                   iters=[[r.iters for r in got], [r.iters for r in ref]],
                   resilience=dict(loop.resilience))
    torch.distributed.barrier()
    return out


def _case_tp(rank: int, world: int, workdir: Path) -> dict:
    """Every multi-rank check of this file in one group of 4 gloo ranks
    (one start-up of the ranks for all of them)."""
    from repro_torch.diffusion.convert import dit_params_from_numpy

    import contextlib
    import io

    from repro_torch.launch import serve

    _init(rank, world, workdir)
    inputs = dict(np.load(workdir / "inputs.npz"))
    params = dit_params_from_numpy(_tree(inputs), _cfg(), "cpu")
    out = {"dit": _dit_part(inputs, params),
           "engine": _engine_part(rank, inputs, params, workdir),
           "chaos": _chaos_part(rank, inputs, params)}
    # the serving CLI in this group (the process group is up already)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        serve.main(SERVE_ARGV + ["--mesh", "debug", "--data-parallel", "2",
                                 "--model-parallel", "2"])
    if text.getvalue():
        out["serve"] = text.getvalue()
    return out


CASES = {"tp": _case_tp}


# --- parent side (jax lives here) --------------------------------------------------


def _weights():
    from repro_torch.diffusion.convert import dit_init_numpy

    return dit_init_numpy(_cfg(), SEED, ada_scale=ADA)


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """One group of 4 gloo ranks runs every multi-rank check
    (``_case_tp``) while the JAX package's sharded engine runs the same
    requests in a subprocess; returns (each rank's results, the port's
    and the reference's trajectories)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_arch as jget_arch
    from repro.core import ddim_coeffs as jddim
    from repro.diffusion import dit as jdit
    from repro.diffusion.samplers import draw_noises as jdraw
    from tests.test_torch_placement import _run_reference, _wait

    work = tmp_path_factory.mktemp("tp")
    tree = _weights()
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((3, NT, 16)).astype(np.float32)
    t = np.asarray([10.0, 400.0, 990.0], np.float32)
    y = np.asarray([1, 5, 16], np.int64)          # 16: the null class
    pj = jax.tree.map(lambda a: jnp.asarray(np.array(a)), tree)
    eps = np.asarray(jdit.dit_apply(pj, jget_arch("dit-xl").reduced(),
                                    jnp.asarray(lat), jnp.asarray(t),
                                    jnp.asarray(y)))
    assert float(np.abs(eps).max()) > 1e-2                      # exercised
    coeffs = jddim(T)
    noise = {f"noise_seed{s}": np.asarray(jdraw(jax.random.PRNGKey(s),
                                                coeffs, (NT, 16)))
             for s in SEEDS}
    np.savez(work / "inputs.npz", lat=lat, t=t, y=y, eps_jax=eps, **noise,
             **_flat(tree))
    ref = _run_reference(REF_SCRIPT, work / "ref.npz", work / "inputs.npz",
                         T, NT)
    try:
        outs = spawn("tp", 4, work, timeout=400,
                     module="tests.test_torch_tp_dit")
    finally:
        _wait(ref, timeout=400)
    return outs, np.load(work / "port.npz"), np.load(work / "ref.npz")


@pytest.mark.parametrize("name", list(DIT_MESHES))
def test_tp_dit_apply_matches_unsharded_and_jax(tp_runs, name):
    data, model = DIT_MESHES[name]
    outs = [o["dit"][name] for o in tp_runs[0] if name in o["dit"]]
    assert len(outs) == data * model
    L, H = _cfg().num_layers, _cfg().num_heads
    for out in outs:
        assert out["host"] < 1e-5 and out["jax"] < 1e-5, out
        assert out["counts"] == dit_counts(L, data), out
        assert out["wq"] == [L, 128 // data, H // model, 32], out
        assert out["same_blocks"], out
        assert "denoiser TP-sharded over model" in out["describe"]
        if model == 1:
            assert out["bitwise"], out


REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import get_arch
from repro.core import ddim_coeffs
from repro.launch.mesh import make_mesh
from repro.launch.serve import make_engine
from repro.sampling import Placement, SampleRequest, get_sampler

out_path, in_path, T, NT = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    int(sys.argv[4])
inputs = dict(np.load(in_path))
tree = {}
for name, arr in inputs.items():
    if name.startswith("p/"):
        *path, leaf = name[2:].split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
cfg = get_arch("dit-xl").reduced()
reqs = [SampleRequest(label=i % 4, seed=50 + i) for i in range(4)]

def drain(eng):
    bank = eng.stepwise_open(2, chunk_iters=2)
    rq = [SampleRequest(label=0, seed=11, quality_steps=1),
          SampleRequest(label=1, seed=12), SampleRequest(label=2, seed=13)]
    eng.stepwise_refill(bank, [0, 1], rq[:2])
    queued, got = [rq[2]], {}
    while any(r is not None for r in bank.requests) or queued:
        eng.stepwise_step(bank)
        for lane, res in eng.stepwise_harvest(bank):
            got[res.request.seed] = res
            if queued:
                eng.stepwise_refill(bank, [lane], [queued.pop()])
    return [got[k] for k in sorted(got)]

arrays = {}
for name, kw in (("debug", dict(data_parallel=2, model_parallel=2)),
                 ("debug-time", dict(data_parallel=1, time_parallel=2,
                                     model_parallel=2))):
    # the devices= path: a plain Mesh with Auto axes
    plc = Placement.for_mesh(make_mesh(name, devices=jax.devices(), **kw))
    eng = make_engine(tree, cfg, ddim_coeffs(T), get_sampler("taa"),
                      num_tokens=NT, placement=plc)
    assert eng.params["blocks"]["wq"].sharding.spec[2] == "model"
    res = eng.run_batch(reqs, batch_size=4)
    for i, r in enumerate(res + drain(eng)):
        arrays[f"{name}/{i}"] = np.asarray(r.trajectory, np.float32)
        arrays[f"{name}/{i}/info"] = np.asarray([r.iters, r.nfe])
np.savez(out_path, **arrays)
"""


def test_tp_engine_matches_host_and_jax_gspmd(tp_runs):
    """``run_batch`` + stepwise drain with ``param_defs`` on debug (data 2
    × model 2) and debug-time (time 2 × model 2): 1e-4 of the host port
    and of the reference's GSPMD-sharded engine, iters/nfe equal, and the
    DiT's collectives an iteration by the formula."""
    outs, port, want = tp_runs
    for out in outs:
        for name, rec in out["engine"].items():
            per_call = dit_counts(_cfg().num_layers,
                                  MESHES[name].get("data_parallel", 1))
            assert rec["sharded"] and rec["report"]["denoiser_sharded"]
            assert rec["report"]["model_shards"] == 2
            assert rec["host"] < 1e-4 and rec["same_iters"], (name, rec)
            iters = rec["report"]["device_iters"]
            time_gathers = iters if name == "debug-time" else 0
            # + the poll flag's all-reduce an iteration, the window's
            # all-gather over time, and the 5 output all-gathers
            assert rec["counts"] == {
                "all-reduce": iters * (per_call["all-reduce"] + 1),
                "all-gather": iters * per_call["all-gather"]
                + time_gathers + 5}, (name, rec)
    assert sorted(port.files) == sorted(want.files)
    for key in port.files:
        if key.endswith("/info"):
            assert np.array_equal(port[key], want[key]), key
        else:
            assert _rel(port[key], want[key]) < 1e-4, key


def test_tp_chaos_drain_reshards_onto_the_survivors(tp_runs):
    """The resilient loop over the TP engine loses half of debug (data 2
    x model 2) mid-drain: the survivors rebuild on a (data 1, model 2)
    mesh, their engines re-slice the weights (each keeps 2 of the 4
    heads), every ticket resolves within 1e-4 of the drain without
    faults, iters equal."""
    outs = [o["chaos"] for o in tp_runs[0]]
    lead = outs[0]
    assert lead["resolved"] == [len(SEEDS)] * 2, lead
    assert lead["resilience"]["rebuilds"] == 1, lead
    assert lead["resilience"]["recovered_lanes"] > 0, lead
    assert lead["rel"] < 1e-4 and lead["iters"][0] == lead["iters"][1]
    members = [o for o in outs if o["member"]]
    assert len(members) == 2
    for o in members:
        assert o["sharded"] and o["wq"] == [_cfg().num_layers, 128, 2, 32]
        assert o["placement"].startswith("mesh[data=1 x model=2]"), o


def test_tp_path_at_one_rank_is_the_host_path_bit_for_bit(tmp_path):
    """A world of one gloo rank in this process: ``dit_apply`` on the
    (1, 1) mesh's ShardedParams issues every collective and returns the
    host path's bits; under grad (with remat) its gradients of every
    block are the host path's bits too; the engine's x0 too."""
    import torch
    import torch.distributed as dist

    from repro_torch import comm
    from repro_torch.core import ddim_coeffs
    from repro_torch.diffusion import dit
    from repro_torch.diffusion.convert import dit_params_from_numpy
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import serve
    from repro_torch.sampling import Placement, SampleRequest, get_sampler

    cfg = _cfg()
    params = dit_params_from_numpy(_weights(), cfg, "cpu")
    tmesh.init_distributed("cpu", world_size=1, rank=0,
                           init_method=f"file://{tmp_path}/rendezvous",
                           timeout_s=60)
    try:
        plc = Placement.for_mesh(tmesh.make_mesh(
            "debug-time", data_parallel=1, time_parallel=1,
            model_parallel=1, device_type="cpu"))
        sharded = plc.shard_params(params, dit.dit_defs(cfg))
        x = torch.randn(3, NT, 16, generator=torch.Generator().manual_seed(0))
        t, y = torch.tensor([5.0, 300.0, 900.0]), torch.tensor([0, 3, 16])
        with torch.no_grad():
            comm.reset()
            got = dit.dit_apply(sharded, cfg, x, t, y)
            assert {k: comm.counts[k] for k in ("all-gather", "all-reduce")
                    } == dit_counts(cfg.num_layers, 1)
            assert torch.equal(got, dit.dit_apply(params, cfg, x, t, y))
        from repro_torch.tree import leaves

        grads = []
        for p in (params, sharded):
            flat = leaves(p.local if p is sharded else p)
            for leaf in flat:
                leaf.requires_grad_(True)
            out = dit.dit_apply(p, cfg, x, t, y, remat=True)
            grads.append(torch.autograd.grad(out.square().sum(), flat))
            for leaf in flat:
                leaf.requires_grad_(False)
        assert all(torch.equal(a, b) for a, b in zip(*grads))
        reqs = [SampleRequest(label=i, seed=50 + i) for i in range(3)]

        def run(placement):
            return serve.make_engine(params, cfg, ddim_coeffs(T),
                                     get_sampler("taa"), num_tokens=NT,
                                     device="cpu", placement=placement
                                     ).run_batch(reqs, batch_size=3)

        for a, b in zip(run(plc), run(None)):
            assert np.array_equal(a.trajectory, b.trajectory)
            assert (a.iters, a.nfe) == (b.iters, b.nfe)
        # the serving factory: the engines of one placement share its
        # blocks (sliced once); a new placement re-slices
        from types import SimpleNamespace

        from repro_torch.models.shardctx import ShardedParams
        from repro_torch.serving import EngineKey

        args = SimpleNamespace(sampler="ddim", order_k=8, history_m=3,
                               window=0, use_pallas="auto", fuse_round=False)
        factory = serve.make_engine_factory(cfg, params, args, "cpu",
                                            num_tokens=NT, placement=plc)
        a, b = (factory(EngineKey("dit-xl", k, "taa")) for k in (T, T // 2))
        assert isinstance(a.params, ShardedParams) and a.params is b.params
        other = Placement.for_mesh(tmesh.make_mesh(
            "debug", data_parallel=1, model_parallel=1, device_type="cpu"))
        c = factory(EngineKey("dit-xl", T, "taa"), other)
        assert c.denoiser_sharded and c.params is not a.params
    finally:
        dist.destroy_process_group()


def test_serve_model_parallel_on_four_ranks_prints_the_host_iters(tp_runs):
    """``serve.main --mesh debug --data-parallel 2 --model-parallel 2`` on
    the 4 gloo ranks (the DiT's heads split two ways; only rank 0 prints)
    prints the per-request iters/nfe of the run without a mesh."""
    from repro_torch.launch import serve

    _, stats = serve.main(SERVE_ARGV)
    out = tp_runs[0][0]["serve"]
    assert all("serve" not in o for o in tp_runs[0][1:])
    lines = re.findall(r"label=\s*(\d+) iters=\s*(\d+) nfe=\s*(\d+)", out)
    assert lines == [(str(s["label"]), str(s["iters"]), str(s["nfe"]))
                     for s in stats], out[-2000:]
    assert out.count("placement: mesh[data=2 x model=2] (4 devices; "
                     "requests over data, denoiser TP-sharded over model)"
                     ) == 1, out
    assert "[data=2 x model=2 x time=1]" in out


if __name__ == "__main__":
    _main(sys.argv[1:], CASES)
