"""Multi-rank runs of the PyTorch port on gloo, for the mesh tests.

``spawn(case, world, workdir)`` starts ``world`` processes of this module
(``python -m tests.test_torch_spawn CASE RANK WORLD WORKDIR``), each a rank
of one gloo group met through a ``file://`` rendezvous in ``workdir`` (no
TCP port to race for under parallel test workers), with a collective
timeout and a hard wall-clock timeout on the whole group.  Each rank runs
``CASES[case](rank, world, workdir)`` and writes what it returns to
``workdir/rank<R>.json``; arrays go to ``workdir/*.npz`` by the case
itself.  The ranks import torch and the port, never jax: what the JAX
package must supply (noise, oracle weights) the parent test writes to
``workdir/inputs.npz`` first.

The one test here holds the port's counted collectives (``repro_torch.
comm``: the all-gathers exact data movement, the all-reduces' min and
max, the reduce-scatter's block of the sum) to what each rank sent, on
2 ranks.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

#: seconds a collective waits for its peers inside a spawned group
COLLECTIVE_TIMEOUT_S = 60.0


def spawn(case: str, world: int, workdir: Path, *,
          timeout: float = 240.0, module: str = "tests.test_torch_spawn"
          ) -> list:
    """Run ``case`` on ``world`` gloo ranks; returns each rank's result.
    Kills the whole group and fails if any rank fails or the group
    outlives ``timeout`` seconds.  ``module`` is the test module whose
    ``CASES`` hold ``case`` (its ``__main__`` calls :func:`_main`)."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:{REPO}",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, case, str(r),
         str(world), str(workdir)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1.0))
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{case} on {world} ranks outlived {timeout}s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not failed, (failed, [log[-3000:] for log in logs])
    return [json.loads((workdir / f"rank{r}.json").read_text())
            for r in range(world)]


# --- rank-side helpers (torch and the port only) --------------------------------


def _init(rank: int, world: int, workdir: Path):
    from repro_torch.launch.mesh import init_distributed

    init_distributed("cpu", world_size=world, rank=rank,
                     init_method=f"file://{workdir}/rendezvous",
                     timeout_s=COLLECTIVE_TIMEOUT_S)


def _label_eps(xstars: np.ndarray, W: np.ndarray):
    """The JAX package's label oracle (tests/helpers.make_label_denoiser)
    in torch, computing in float32 as jnp's type promotion does for a
    bfloat16 iterate."""
    import torch

    from repro_torch.diffusion.schedules import make_schedule

    abar = torch.as_tensor(make_schedule("linear", 1000)[0],
                           dtype=torch.float32)
    xs, Wt = torch.from_numpy(xstars), torch.from_numpy(W)

    def eps_apply(params, x, taus, y):
        x = x.float()
        ab = abar[torch.clamp(taus.to(torch.int32), 0, 999).long()][:, None]
        lin = (x - torch.sqrt(ab) * xs[torch.clamp(y, 0, len(xs) - 1)]) \
            / torch.sqrt(1.0 - ab + 1e-8)
        return lin + 0.3 * torch.tanh(x @ Wt)

    return eps_apply


def _noise_fn(inputs, T: int):
    def draw(request):
        return inputs[f"noise_T{T}_seed{request.seed}"]
    return draw


def _bitwise(a, b) -> bool:
    import torch

    return torch.equal(a, b) if a.dtype == b.dtype else False


def _case_comm(rank: int, world: int, workdir: Path) -> dict:
    """all_gather_cat (float32, bfloat16, bool), all_reduce_min and
    broadcast_object on ``world`` ranks, against what each rank sent."""
    import torch

    from repro_torch import comm

    _init(rank, world, workdir)
    out = {}
    for dtype in (torch.float32, torch.bfloat16, torch.bool):
        x = (torch.arange(6, dtype=torch.float32).reshape(2, 3)
             + 10 * rank).to(dtype)
        got = comm.all_gather_cat(x, None, dim=1)
        want = torch.cat([(torch.arange(6, dtype=torch.float32)
                           .reshape(2, 3) + 10 * r).to(dtype)
                          for r in range(world)], dim=1)
        out[str(dtype)] = _bitwise(got, want)
    flag = comm.all_reduce_min(torch.tensor(rank % 2, dtype=torch.int32),
                               None)
    out["min"] = int(flag)
    top = comm.all_reduce_max(torch.tensor([rank, -rank],
                                           dtype=torch.float32), None)
    out["max"] = top.tolist()
    # each rank keeps its block of the sum (rows 2r, 2r + 1)
    x = torch.arange(4 * world, dtype=torch.float32).view(2 * world, 2) \
        * (rank + 1)
    got = comm.reduce_scatter(x, None, 0)
    want = torch.arange(4 * world, dtype=torch.float32).view(2 * world, 2) \
        * sum(r + 1 for r in range(world))
    out["reduce_scatter"] = _bitwise(got, want[2 * rank:2 * rank + 2])
    out["object"] = comm.broadcast_object({"from": rank, "k": [1, 2]})
    out["counts"] = dict(comm.counts)
    return out


def _case_placement(rank: int, world: int, workdir: Path) -> dict:
    """The port's data x time sharded solve against its host placement:
    core ``sample``/``sample_recording`` (one lane, window over time),
    engine ``run_batch`` and a stepwise drain with a mid-solve refill,
    for each (mode, dtype) of ``inputs["cases"]``.  Rank 0 also writes the
    sharded results to ``port.npz`` for the parent's comparison with the
    JAX package's sharded run."""
    import dataclasses

    import torch

    from repro_torch.core import ddim_coeffs
    from repro_torch.core import parataa as pt
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import shardctx
    from repro_torch.sampling import (Placement, SampleRequest,
                                      SamplingEngine, get_sampler)

    _init(rank, world, workdir)
    inputs = dict(np.load(workdir / "inputs.npz"))
    T, D = int(inputs["T"]), int(inputs["D"])
    eps_apply = _label_eps(inputs["xstars"], inputs["W"])
    coeffs = ddim_coeffs(T)
    mesh = make_mesh("debug-time", data_parallel=2, time_parallel=2,
                     model_parallel=1, device_type="cpu")
    plc = Placement.for_mesh(mesh)
    noise = _noise_fn(inputs, T)
    xi = torch.from_numpy(inputs["xi"])[None]
    reqs = [SampleRequest(label=i % 4, seed=50 + i) for i in range(4)]
    out = {"describe": plc.describe(), "cases": {}}
    arrays = {}

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
        return got

    def eps_fn(xw, taus):
        y = torch.full((xw.shape[0],), 2, dtype=torch.long)
        return eps_apply(None, xw, taus, y)

    for name in inputs["cases"]:
        mode, dt = str(name).split("/")
        dtype = getattr(torch, dt)
        spec = get_sampler(mode)
        cfg = spec.solver_config(T)
        cfg_t = dataclasses.replace(cfg, time_axis="time")
        rec = {}
        with torch.inference_mode():
            host, hinfo = pt.sample(eps_fn, coeffs, cfg, xi, dtype=dtype)
            with shardctx.serving_mesh(mesh):
                sh, sinfo = pt.sample(eps_fn, coeffs, cfg_t, xi, dtype=dtype)
            rec["sample"] = _bitwise(sh, host) and all(
                torch.equal(sinfo[k], hinfo[k])
                for k in ("iters", "nfe", "converged"))
            host_r, hr = pt.sample_recording(eps_fn, coeffs, cfg, xi,
                                             dtype=dtype)
            with shardctx.serving_mesh(mesh):
                sh_r, sr = pt.sample_recording(eps_fn, coeffs, cfg_t, xi,
                                               dtype=dtype)
            rec["sample_recording"] = _bitwise(sh_r, host_r) and all(
                _bitwise(sr[k], hr[k]) for k in hr)
        host_eng = SamplingEngine(eps_apply, None, coeffs, spec,
                                  sample_shape=(D,), dtype=dtype,
                                  device="cpu", noise_fn=noise)
        time_eng = SamplingEngine(eps_apply, None, coeffs, spec,
                                  sample_shape=(D,), dtype=dtype,
                                  device="cpu", noise_fn=noise,
                                  placement=plc)
        ref = host_eng.run_batch(reqs, batch_size=4)
        res = time_eng.run_batch(reqs, batch_size=4)
        rec["run_batch"] = all(
            np.array_equal(r.trajectory, h.trajectory)
            and (r.iters, r.nfe, r.converged) == (h.iters, h.nfe,
                                                  h.converged)
            for r, h in zip(res, ref))
        report = time_eng.last_dispatches[-1]
        rec["report"] = {k: report[k] for k in (
            "devices", "data_shards", "model_shards", "time_shards",
            "axis_utilization", "blocking_polls")}
        rec["host_polls"] = host_eng.last_dispatches[-1]["blocking_polls"]
        got_h, got_t = drain(host_eng), drain(time_eng)
        rec["stepwise"] = set(got_h) == set(got_t) and all(
            np.array_equal(got_t[k].trajectory, got_h[k].trajectory)
            and (got_t[k].iters, got_t[k].nfe)
            == (got_h[k].iters, got_h[k].nfe) for k in got_h)
        rec["stepwise_traces"] = time_eng.stats["stepwise_traces"]
        rec["polls"] = [time_eng.stats["blocking_polls"],
                        host_eng.stats["blocking_polls"]]
        out["cases"][name] = rec
        arrays[f"{name}/sample"] = sh[0].float().numpy()
        arrays[f"{name}/sample_info"] = np.asarray(
            [int(sinfo["iters"][0]), int(sinfo["nfe"][0])])
        arrays[f"{name}/run_batch"] = np.stack([r.trajectory for r in res])
        arrays[f"{name}/run_batch_info"] = np.asarray(
            [[r.iters, r.nfe] for r in res])
        for k, r in sorted(got_t.items()):
            arrays[f"{name}/stepwise/{k}"] = r.trajectory
            arrays[f"{name}/stepwise_info/{k}"] = np.asarray([r.iters,
                                                              r.nfe])
    if rank == 0:
        np.savez(workdir / "port.npz", **arrays)
    return out


def _case_chaos(rank: int, world: int, workdir: Path) -> dict:
    """The chaos drain on ``world`` ranks (debug mesh, data = world): a
    drain without faults, then one that loses ``inputs["drop"]`` ranks at
    round ``inputs["round"]``; rank 0 holds the tickets."""
    import torch

    from repro_torch.core import ddim_coeffs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sampling import (Placement, SampleRequest,
                                      SamplingEngine, get_sampler)
    from repro_torch.serving import (Batcher, BatchingPolicy, EngineKey,
                                     EngineRegistry, FaultInjector,
                                     RequestQueue, ResilientServingLoop)

    _init(rank, world, workdir)
    inputs = dict(np.load(workdir / "inputs.npz"))
    T, D = int(inputs["T"]), int(inputs["D"])
    eps_apply = _label_eps(inputs["xstars"], inputs["W"])
    key = EngineKey("oracle", T, "taa")

    def factory(k, plc):
        return SamplingEngine(eps_apply, None, ddim_coeffs(k.T),
                              get_sampler(k.solver), sample_shape=(D,),
                              device="cpu", noise_fn=_noise_fn(inputs, k.T),
                              placement=plc)

    plc = Placement.for_mesh(make_mesh("debug", data_parallel=world,
                                       model_parallel=1, device_type="cpu"))
    reqs = [SampleRequest(label=i % 4, seed=100 + i,
                          **({} if i % 3 == 0
                             else dict(tau=1e-2, quality_steps=1 + i % 4)))
            for i in range(10)]

    def drain(injector):
        registry = EngineRegistry(lambda k: factory(k, plc))
        queue = RequestQueue()
        loop = ResilientServingLoop(
            registry, queue, Batcher(BatchingPolicy(max_batch=4)),
            engine_factory=factory, placement=plc, injector=injector,
            chunk_iters=2)
        tickets = [queue.submit(r, key) for r in reqs] \
            if loop.control.leader else []
        loop.drain()
        return loop, tickets

    _, base = drain(None)
    loop, tickets = drain(FaultInjector({int(inputs["round"]):
                                         int(inputs["drop"])}))
    out = {"serving": loop._serving()}
    if rank == 0:
        engine = loop.registry.get(key)
        ref = [t.result(timeout=0) for t in base]
        got = [t.result(timeout=0) for t in tickets]
        out.update(
            resolved=[sum(t.done() for t in base),
                      sum(t.done() for t in tickets)],
            bitwise=all(a.x0.tobytes() == b.x0.tobytes()
                        for a, b in zip(ref, got)),
            iters=[r.iters for r in got], nfe=[r.nfe for r in got],
            resilience=dict(loop.resilience),
            devices_after=engine.placement.num_devices,
            placement_after=engine.placement.describe())
        np.savez(workdir / "port.npz", x0=np.stack([r.x0 for r in got]))
    torch.distributed.barrier()
    return out


def _case_moe(rank: int, world: int, workdir: Path) -> dict:
    """``moe_apply`` under a (data 1, model ``world``) mesh — the
    expert-parallel branch — and the local path, on the JAX package's
    weights and tokens (``inputs.npz``: leaves by '/'-joined path)."""
    import dataclasses

    import torch

    from repro_torch import comm
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.shardctx import use_mesh

    _init(rank, world, workdir)
    inputs = dict(np.load(workdir / "inputs.npz"))
    cfg = dataclasses.replace(get_arch("qwen2-moe-a2.7b").reduced(),
                              moe_capacity_factor=8.0, d_model=64)
    params = {}
    for name, arr in inputs.items():
        if name.startswith("p/"):
            *path, leaf = name[2:].split("/")
            node = params
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = torch.from_numpy(arr)
    x = torch.from_numpy(inputs["x"])
    mesh = make_mesh("debug", data_parallel=1, model_parallel=world,
                     device_type="cpu")
    y_local, aux_local = moe._moe_local(params, cfg, x)
    comm.reset()
    with use_mesh(mesh):
        y_ep, aux_ep = moe.moe_apply(params, cfg, x)
    if rank == 0:
        np.savez(workdir / "port.npz", y_ep=y_ep.numpy(),
                 y_local=y_local.numpy())
    return {"local_err": float((y_ep - y_local).abs().max()),
            "aux_equal": bool(torch.equal(aux_ep, aux_local)),
            "counts": dict(comm.counts)}


CASES = {"comm": _case_comm, "placement": _case_placement,
         "chaos": _case_chaos, "moe": _case_moe}


def _main(argv, cases=None):
    case, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), \
        Path(argv[3])
    result = (cases or CASES)[case](rank, world, workdir)
    (workdir / f"rank{rank}.json").write_text(json.dumps(result))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def test_counted_collectives_are_exact_on_two_gloo_ranks(tmp_path):
    outs = spawn("comm", 2, tmp_path, timeout=120)
    for rank, out in enumerate(outs):
        assert out["torch.float32"] and out["torch.bfloat16"] \
            and out["torch.bool"], out
        assert out["min"] == 0 and out["max"] == [1.0, 0.0]
        assert out["reduce_scatter"], out
        assert out["object"] == {"from": 0, "k": [1, 2]}
        assert out["counts"] == {"all-gather": 3, "all-reduce": 2,
                                 "reduce-scatter": 1, "broadcast": 1}


if __name__ == "__main__":
    _main(sys.argv[1:])
