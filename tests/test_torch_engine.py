"""Port parity for the whole slice: SamplingEngine.run_batch over the
reduced DiT against the JAX engine with the same injected noise, and the
serving CLI end to end on the CPU."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import get_arch as jget_arch
from repro.diffusion import dit as jdit
from repro.sampling import SampleRequest as JRequest
from repro.sampling import SamplingEngine as JEngine
from repro.sampling import get_sampler as jget_sampler
from repro_torch.core.coeffs import ddim_coeffs
from repro_torch.diffusion.convert import dit_params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.sampling import SampleRequest, WarmStart, get_sampler
from tests.test_torch_helpers import (CPU, dit_param_trees, normal, rel_err,
                                      torch_cfg)

T = 8
SHAPE = (16, 16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dit():
    cfg_j = jget_arch("dit-xl").reduced()
    pj, tree = dit_param_trees(cfg_j, seed=0, ada_scale=0.05)
    cfg_t = torch_cfg(cfg_j)
    return cfg_j, pj, cfg_t, dit_params_from_numpy(tree, cfg_t, CPU)


def _xi_table(seeds):
    return {s: normal(100 + s, T + 1, *SHAPE) for s in seeds}


def _engines(dit, name, xis, **spec_kw):
    cfg_j, pj, cfg_t, pt = dit
    coeffs = ddim_coeffs(T)
    jeng = JEngine(lambda p, x, t, y: jdit.dit_apply(p, cfg_j, x, t, y), pj,
                   coeffs, jget_sampler(name, **spec_kw), sample_shape=SHAPE)
    jeng.draw_request_noise = lambda req: jnp.asarray(xis[req.seed])
    teng = tserve.make_engine(pt, cfg_t, coeffs, get_sampler(name, **spec_kw),
                              num_tokens=SHAPE[0], device=CPU,
                              noise_fn=lambda req: xis[req.seed])
    return jeng, teng


@pytest.mark.parametrize("name", ["taa", "seq"])
def test_run_batch_matches_jax_engine(dit, name):
    """3 requests at batch 2 (the second dispatch has one padded slot):
    per-request iters/nfe, update_launches and trajectories."""
    reqs = [(3, 1), (7, 2), (3, 5)]            # (label, seed)
    xis = _xi_table([s for _, s in reqs])
    jeng, teng = _engines(dit, name, xis)
    res_j = jeng.run_batch([JRequest(label=l, seed=s) for l, s in reqs],
                           batch_size=2)
    res_t = teng.run_batch([SampleRequest(label=l, seed=s) for l, s in reqs],
                           batch_size=2)
    for rj, rt in zip(res_j, res_t):
        assert (rt.iters, rt.nfe, rt.converged) == \
            (int(rj.iters), int(rj.nfe), bool(rj.converged))
        assert rel_err(rt.trajectory, rj.trajectory) < 1e-4
        assert rt.trajectory.shape == (T + 1,) + SHAPE
    assert teng.stats["update_launches"] == jeng.stats["update_launches"]
    for key in ("batches", "requests"):
        assert teng.stats[key] == jeng.stats[key], key
    # the port's own count: the reference's while_loop runs on the device,
    # the port's loop on the host polls once per iteration (one flag byte
    # each), and collect fetches once
    polls = [d["device_iters"] + 1 if name == "taa" else 1
             for d in teng.last_dispatches]
    assert [d["blocking_polls"] for d in teng.last_dispatches] == polls
    assert teng.stats["blocking_polls"] == sum(polls)
    # per dispatch of 2 slots: trajectories, iters/nfe (int64), converged
    # (bool), residuals (float32, ParaTAA only), and a byte per poll
    outputs = 2 * ((T + 1) * SHAPE[0] * SHAPE[1] * 4 + 8 + 8 + 1
                   + (T * 4 if name == "taa" else 0))
    assert [d["host_fetch_bytes"] for d in teng.last_dispatches] == \
        [outputs + p - 1 for p in polls]
    assert teng.stats["host_fetch_bytes"] == sum(outputs + p - 1
                                                 for p in polls)
    assert [d["slots"] for d in teng.last_dispatches] == [2, 2]
    assert [d["iters"] for d in teng.last_dispatches] == \
        [d["iters"] for d in jeng.last_dispatches]
    if name == "taa":
        assert res_t[0].iters < T                # parallel beat sequential


def test_fused_engine_equals_staged_and_counts_one_launch(dit):
    reqs = [SampleRequest(label=1, seed=4), SampleRequest(label=2, seed=6)]
    xis = _xi_table([4, 6])
    _, staged = _engines(dit, "taa", xis)
    _, fused = _engines(dit, "taa", xis, fuse_round=True)
    rs, rf = staged.run_batch(reqs), fused.run_batch(reqs)
    for a, b in zip(rs, rf):
        assert np.array_equal(a.trajectory, b.trajectory) and a.iters == b.iters
    iters = staged.last_dispatches[0]["device_iters"]
    assert staged.stats["update_launches"] == 3 * iters
    assert fused.stats["update_launches"] == iters


def test_warm_start_and_validation(dit):
    xis = _xi_table([9])
    _, eng = _engines(dit, "taa", xis)
    cold = eng.run(SampleRequest(label=0, seed=9))
    warm = eng.run(SampleRequest(label=0, seed=9,
                                 init=WarmStart(cold.trajectory, t_init=0)))
    assert warm.iters <= 1 and warm.converged
    assert rel_err(warm.x0, cold.x0) < 1e-4
    with pytest.raises(ValueError, match="does not match"):
        eng.validate_request(SampleRequest(init=WarmStart(np.zeros((3, 2)))))
    with pytest.raises(ValueError, match="t_init"):
        eng.validate_request(SampleRequest(
            init=WarmStart(cold.trajectory, t_init=T + 1)))
    _, seq = _engines(dit, "seq", xis)
    with pytest.raises(ValueError, match="sequential"):
        seq.validate_request(SampleRequest(tau=1e-2))


def test_serve_cli_runs_on_cpu_in_a_subprocess():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--requests", "2", "--steps-T", "8"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert sum(line.startswith("label=") for line in lines) == 2
    assert any("step reduction" in line for line in lines)
