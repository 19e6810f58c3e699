"""The port's CUDA kernels on the card, against their plain PyTorch
versions, and the solver path through them.  Every test needs a CUDA
device and skips without one.

This file imports neither jax nor the JAX package, so it also runs on a
GPU machine without JAX (there ``tests/conftest.py``, which imports jax,
is skipped):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core import parataa
from repro_torch.core.coeffs import ddim_coeffs
from repro_torch.diffusion.convert import dit_init
from repro_torch.kernels import ref
from repro_torch.kernels import taa_update as k
from repro_torch.launch import serve
from repro_torch.sampling import SampleRequest, get_sampler

MODES = ["taa", "aa", "aa+"]
DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(dtype, cuda, B=2, m=3, T=25, D=4000, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(cuda, dtype)

    x, R = t(B, T, D), t(B, T, D, scale=0.3)
    dX, dF = t(B, m, T, D, scale=0.1), t(B, m, T, D, scale=0.1)
    rows = torch.arange(T, device=cuda)
    mask = (rows >= 4).float().expand(B, T).contiguous()
    guard = (rows >= T - 3).float().expand(B, T).contiguous()
    gamma = t(B, T, m, scale=0.1).float()
    return x, R, dX, dF, mask, guard, gamma


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [4096, 4000, 37])
def test_gram_and_apply_match_plain(dtype, D, cuda):
    x, R, dX, dF, mask, _, gamma = _inputs(dtype, cuda, D=D)
    G, u = k.taa_gram(dF, R, mask)
    Gr, ur = ref.taa_gram_ref(dF, R, mask)
    Ga, ua = ref.taa_gram_ref(dF.abs(), R.abs(), mask)
    tol_g = 2.0 ** -16 * max(float(Ga.max()), float(ua.max()), 1.0)
    assert _err(G, Gr) < tol_g and _err(u, ur) < tol_g
    out = k.taa_apply(x, R, dX, dF, gamma, mask)
    assert out.dtype == dtype
    assert _err(out, ref.taa_apply_ref(x, R, dX, dF, gamma, mask)) < TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [3, 8])
def test_round_matches_plain(mode, dtype, m, cuda):
    x, R, dX, dF, mask, guard, _ = _inputs(dtype, cuda, m=m)
    out = k.taa_round(x, R, dX, dF, mask, guard, mode=mode, lam=1e-6)
    want = ref.taa_round_ref(x, R, dX, dF, mask, guard, mode=mode, lam=1e-6)
    assert _err(out, want) < TOL[dtype]


@pytest.mark.gpu
def test_gram_is_deterministic_and_unbatched_shapes_work(cuda):
    x, R, dX, dF, mask, guard, gamma = _inputs(torch.float32, cuda)
    G1, _ = k.taa_gram(dF, R, mask)
    G2, _ = k.taa_gram(dF, R, mask)
    assert torch.equal(G1, G2)                 # no float atomics
    G0, u0 = k.taa_gram(dF[0], R[0], mask[0])
    assert G0.shape == (25, 3, 3) and torch.equal(G0, G1[0])
    out0 = k.taa_round(x[0], R[0], dX[0], dF[0], mask[0], guard[0])
    assert out0.shape == x[0].shape


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,T,D", [(1, 7, 1037), (8, 25, 4096),
                                   (3, 25, 9000), (2, 1000, 64)])
def test_gram_tiles_match_plain_and_their_plan(dtype, m, T, D, cuda):
    """Ragged D (vectors element by element), more tiles a row than CTAs a
    cluster, one tile a row at T=1000: against the plain version, the
    grid of ``gram_plan``, and the same bits on a second run."""
    _, R, _, dF, mask, _, _ = _inputs(dtype, cuda, m=m, T=T, D=D)
    G, u = k.taa_gram(dF, R, mask)
    grid = dict(k.last_gram_grid)
    Gr, ur = ref.taa_gram_ref(dF, R, mask)
    Ga, ua = ref.taa_gram_ref(dF.abs(), R.abs(), mask)
    tol_g = 2.0 ** -16 * max(float(Ga.max()), float(ua.max()), 1.0)
    assert _err(G, Gr) < tol_g and _err(u, ur) < tol_g
    plan = k.gram_plan(2, m, T, D, dF.element_size())
    assert grid == {key: plan[key] for key in ("ctas", "tiles_per_row",
                                               "threads", "cluster")}
    G2, u2 = k.taa_gram(dF, R, mask)
    assert torch.equal(G, G2) and torch.equal(u, u2)


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [False, True])
def test_sample_waits_on_the_card_only_at_its_polls(fuse, cuda):
    """Under sync-debug mode "error" every synchronizing call raises; the
    solve's one wait, the poll's event, is not one of them.  One poll an
    iteration."""
    rng = np.random.default_rng(0)
    W = torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32)
                         / 32 ** 0.5).to(cuda)

    def eps(x, taus):
        return 0.5 * x + 0.3 * torch.tanh(x @ W)

    xi = torch.from_numpy(rng.standard_normal((2, 11, 32)).astype(
        np.float32)).to(cuda)
    cfg = parataa.ParaTAAConfig(order_k=4, history_m=3, fuse_round=fuse)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, info = parataa.sample(eps, ddim_coeffs(10), cfg, xi)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert info["polls"] == int(info["iters"].max()) > 1


@pytest.mark.gpu
def test_round_handles_large_T_in_dynamic_shared_memory(cuda):
    """Any T: the Gram partials live in a device scratch, not in shared
    memory.  T=1000 with m=3 (60 KB of G and u) and with m=8 (320 KB, more
    than a block's shared memory, which an earlier one-CTA-per-lane design
    refused) both agree with the plain round."""
    for m in (3, 8):
        x, R, dX, dF, mask, guard, _ = _inputs(torch.float32, cuda, B=1, m=m,
                                               T=1000, D=64)
        for mode in MODES:
            out = k.taa_round(x, R, dX, dF, mask, guard, mode=mode, lam=1e-6)
            want = ref.taa_round_ref(x, R, dX, dF, mask, guard, mode=mode,
                                     lam=1e-6)
            assert _err(out, want) < 1e-3, (m, mode)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_round_is_one_cooperative_launch_and_deterministic(mode, dtype,
                                                           cuda):
    """One launch per call, over more CTAs than lanes (the grid of
    ``round_plan`` on this card), and two runs give the same bits (no
    float atomics; every CTA of a row reduces its partials in one order)."""
    x, R, dX, dF, mask, guard, _ = _inputs(dtype, cuda)
    k.reset_launches()
    first = k.taa_round(x, R, dX, dF, mask, guard, mode=mode, lam=1e-6)
    assert k.launches == {"taa_gram": 0, "taa_apply": 0, "taa_round": 1}
    grid = dict(k.last_round_grid)
    second = k.taa_round(x, R, dX, dF, mask, guard, mode=mode, lam=1e-6)
    assert k.launches["taa_round"] == 2
    assert torch.equal(first, second)
    B, m, T, D = dF.shape
    plan = k.round_plan(B, m, T, D, grid["co_resident"])
    assert grid["ctas"] == plan["ctas"] > B
    assert grid["tiles"] == plan["tiles"]


@pytest.mark.gpu
def test_engine_on_the_card_goes_through_the_kernels(cuda):
    """The reduced DiT served on the card, staged and fused, against the
    same requests on the CPU; the launch counts equal device iterations."""
    cfg = get_arch("dit-xl").reduced()
    coeffs = ddim_coeffs(10)
    reqs = [SampleRequest(label=1, seed=3), SampleRequest(label=5, seed=4)]
    outs = {}
    for dev in ("cpu", "cuda"):
        params = dit_init(cfg, 0, dev, ada_scale=0.05)
        for fuse in (False, True):
            eng = serve.make_engine(params, cfg, coeffs,
                                    get_sampler("taa", fuse_round=fuse),
                                    device=dev)
            k.reset_launches()
            res = eng.run_batch(reqs)
            n = eng.last_dispatches[0]["device_iters"]
            assert eng.last_dispatches[0]["blocking_polls"] == n + 1
            if dev == "cuda":
                want = {"taa_gram": 0 if fuse else n,
                        "taa_apply": 0 if fuse else n,
                        "taa_round": n if fuse else 0}
                assert k.launches == want
            outs[dev, fuse] = res
    for key, res in outs.items():
        for r, c in zip(res, outs["cpu", False]):
            assert r.converged and r.iters == c.iters, key
            err = np.abs(r.trajectory - c.trajectory).max() \
                / np.abs(c.trajectory).max()
            assert err < 1e-4, (key, err)


@pytest.mark.gpu
def test_stepwise_serving_on_the_card(cuda):
    """The reduced DiT served stepwise (fused) on the card and on the CPU
    through the same ServingLoop drain: the same iters, trajectories
    within 1e-4; each step and refill under sync-debug mode "error"; K3
    launched once per device iteration; a whole-batch dispatch carries
    an event that ``collect`` waits on."""
    from repro_torch.serving import (Batcher, BatchingPolicy, EngineKey,
                                     EngineRegistry, RequestQueue,
                                     ServingLoop)

    cfg = get_arch("dit-xl").reduced()
    reqs = [SampleRequest(label=1, seed=3), SampleRequest(label=5, seed=4),
            SampleRequest(label=2, seed=5, tau=1e-2)]
    key = EngineKey("dit-xl", 10, "taa")
    outs = {}
    for dev in ("cpu", "cuda"):
        params = dit_init(cfg, 0, dev, ada_scale=0.05)

        def factory(key, params=params, dev=dev):
            engine = serve.make_engine(params, cfg, ddim_coeffs(key.T),
                                       get_sampler("taa", fuse_round=True),
                                       device=dev)
            if dev == "cuda":
                for name in ("stepwise_step", "stepwise_refill"):
                    fn = getattr(engine, name)

                    def strict(*args, fn=fn):
                        torch.cuda.set_sync_debug_mode("error")
                        try:
                            return fn(*args)
                        finally:
                            torch.cuda.set_sync_debug_mode(0)

                    setattr(engine, name, strict)
            return engine

        registry = EngineRegistry(factory)
        queue = RequestQueue()
        loop = ServingLoop(registry, queue,
                           Batcher(BatchingPolicy(max_batch=2)),
                           chunk_iters=2)
        k.reset_launches()
        tickets = [queue.submit(r, key) for r in reqs]
        loop.drain()
        report = loop.bank_reports()[key]
        if dev == "cuda":
            assert k.launches == {"taa_gram": 0, "taa_apply": 0,
                                  "taa_round": report["device_iters"]}
            engine = registry.get(key)
            pending = engine.dispatch(reqs[:1], slots=2)
            assert pending.event is not None
            [res] = engine.collect(pending)
            assert pending.ready() and res.converged
        assert report["blocking_polls"] == report["device_iters"] // 2
        assert registry.get(key).stats["stepwise_traces"] == 5
        outs[dev] = [t.result(timeout=0) for t in tickets]
    for g, c in zip(outs["cuda"], outs["cpu"]):
        assert g.converged and g.iters == c.iters
        err = np.abs(g.trajectory - c.trajectory).max() \
            / np.abs(c.trajectory).max()
        assert err < 1e-4, err
