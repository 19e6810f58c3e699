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
def test_round_handles_large_T_in_dynamic_shared_memory(cuda):
    # T=1000, m=8: 1000 * (64 + 16) * 4 B = 320 KB > 227 KB -> refused
    x, R, dX, dF, mask, guard, _ = _inputs(torch.float32, cuda, B=1, m=3,
                                           T=1000, D=64)
    # T=1000, m=3: 60 KB of shared memory, above the 48 KB default
    out = k.taa_round(x, R, dX, dF, mask, guard, mode="taa", lam=1e-6)
    want = ref.taa_round_ref(x, R, dX, dF, mask, guard, mode="taa", lam=1e-6)
    assert _err(out, want) < 1e-3
    x, R, dX, dF, mask, guard, _ = _inputs(torch.float32, cuda, B=1, m=8,
                                           T=1000, D=64)
    with pytest.raises(RuntimeError, match="taa_round launch failed"):
        k.taa_round(x, R, dX, dF, mask, guard)


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
