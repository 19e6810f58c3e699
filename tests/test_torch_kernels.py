"""Port parity for the TAA-update kernels' plain versions, the ops dispatch
and anderson_update, against the JAX package's references and its Pallas
kernels in interpret mode.  The CUDA kernels themselves are tested on the
card by tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import anderson as janderson
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import taa_update as jtaa
from repro_torch.core import anderson as tanderson
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from tests.test_torch_helpers import (_tol, both, gram_tol, max_abs, normal,
                                      to_np)

MODES = ["aa", "aa+", "taa"]
DTYPES = ["float32", "bfloat16"]


def _round_inputs(seed=0, B=2, T=14, D=96, m=3, dtype="float32"):
    """numpy inputs with a lane axis: the JAX tests' magnitudes."""
    x = normal(seed, B, T, D)
    R = normal(seed + 1, B, T, D, scale=0.3)
    dX = normal(seed + 2, B, m, T, D, scale=0.1)
    dF = normal(seed + 3, B, m, T, D, scale=0.1)
    wmask = np.stack([np.arange(T) >= 3, np.arange(T) >= 5])[:B]
    guard = np.stack([np.arange(T) >= T - 2, np.arange(T) >= T - 4])[:B]
    return x, R, dX, dF, wmask, guard


@pytest.mark.parametrize("m,t,d", [(3, 16, 512), (5, 25, 700), (2, 8, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gram_and_apply_plain_match_jax_ref_and_pallas(m, t, d, dtype):
    """Lane axis B=2 (ragged D=700 included) against a per-lane loop over
    the JAX reference and its Pallas kernels in interpret mode."""
    dF, dX = normal(0, 2, m, t, d), normal(1, 2, m, t, d)
    R, x = normal(2, 2, t, d), normal(3, 2, t, d)
    gamma = normal(4, 2, t, m, scale=0.1)
    mask = np.stack([np.arange(t) >= t // 3, np.arange(t) >= 1]
                    ).astype(np.float32)
    dFt, dXt, Rt, xt = (both(a, dtype)[1] for a in (dF, dX, R, x))
    G, u = tref.taa_gram_ref(dFt, Rt, torch.from_numpy(mask))
    out = tref.taa_apply_ref(xt, Rt, dXt, dFt, torch.from_numpy(gamma),
                             torch.from_numpy(mask))
    assert out.dtype == xt.dtype
    tol = _tol(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    for b in range(2):
        dFj, dXj, Rj, xj = (both(a[b], dtype)[0] for a in (dF, dX, R, x))
        mj, gj = jnp.asarray(mask[b]), jnp.asarray(gamma[b])
        Gr, ur = jref.taa_gram_ref(dFj, Rj, mj)
        tol_g = gram_tol(dFt[b], Rt[b], torch.from_numpy(mask[b]))
        assert max_abs(G[b], Gr) < tol_g and max_abs(u[b], ur) < tol_g
        Gk, uk = jtaa.taa_gram(dFj, Rj, mj, bd=256, interpret=True)
        assert max_abs(G[b], Gk) < tol_g and max_abs(u[b], uk) < tol_g
        outr = jref.taa_apply_ref(xj, Rj, dXj, dFj, gj, mj)
        assert max_abs(out[b], outr) < tol
        outk = jtaa.taa_apply(xj, Rj, dXj, dFj, gj, mj, bd=256,
                              interpret=True)
        assert max_abs(out[b], outk) < tol


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_round_plain_matches_pallas_round_and_staged(mode, dtype):
    """The plain fused round (pivot-free Gauss-Jordan) against the Pallas
    taa_round in interpret mode, per lane, with the guard; and against the
    port's staged round (LU solve) to the same tolerance."""
    x, R, dX, dF, wmask, guard = _round_inputs(dtype=dtype)
    xt, Rt, dXt, dFt = (both(a, dtype)[1] for a in (x, R, dX, dF))
    mask_t = torch.from_numpy(wmask.astype(np.float32))
    guard_t = torch.from_numpy(guard)
    got = tref.taa_round_ref(xt, Rt, dXt, dFt, mask_t, guard_t.float(),
                             mode=mode, lam=1e-6)
    staged = tops.taa_round_staged(xt, Rt, dXt, dFt, mask_t, mode=mode,
                                   lam=1e-6, safeguard_mask=guard_t)
    tol = _tol(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert max_abs(got, staged) < tol
    for b in range(2):
        xj, Rj, dXj, dFj = (both(a[b], dtype)[0] for a in (x, R, dX, dF))
        want = jtaa.taa_round(xj, Rj, dXj, dFj,
                              jnp.asarray(wmask[b], jnp.float32),
                              jnp.asarray(guard[b], jnp.float32), mode=mode,
                              lam=1e-6, bd=64, interpret=True)
        assert max_abs(got[b], want) < tol, (mode, b)


def test_gauss_jordan_matches_lu_solve_on_spd():
    A = torch.from_numpy(normal(5, 4, 3, 3))
    A = A @ A.transpose(-1, -2) + 1e-2 * torch.eye(3)
    b = torch.from_numpy(normal(6, 4, 3))
    want = torch.linalg.solve(A, b[..., None])[..., 0]
    assert max_abs(tref.gauss_jordan_ref(A, b), want) < 1e-4


@pytest.mark.parametrize("mode", ["fp", "aa", "aa+", "taa"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_anderson_update_matches_jax(mode, dtype):
    """anderson_update with the lane axis against the JAX update per lane,
    staged and fused; the port's staged and fused agree bit for bit on
    the CPU."""
    x, R, dX, dF, wmask, guard = _round_inputs(dtype=dtype)
    xt, Rt, dXt, dFt = (both(a, dtype)[1] for a in (x, R, dX, dF))
    kw = dict(mode=mode, lam=1e-6, safeguard_mask=torch.from_numpy(guard))
    staged = tanderson.anderson_update(xt, Rt, dXt, dFt,
                                       torch.from_numpy(wmask), **kw)
    fused = tanderson.anderson_update(xt, Rt, dXt, dFt,
                                      torch.from_numpy(wmask),
                                      fuse_round=True, **kw)
    assert torch.equal(staged, fused)
    assert staged.dtype == xt.dtype
    tol = _tol(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    for b in range(2):
        xj, Rj, dXj, dFj = (both(a[b], dtype)[0] for a in (x, R, dX, dF))
        want = janderson.anderson_update(
            xj, Rj, dXj, dFj, jnp.asarray(wmask[b]), mode=mode, lam=1e-6,
            safeguard_mask=jnp.asarray(guard[b]), use_pallas=False)
        assert max_abs(staged[b], want) < tol, (mode, b)


def test_anderson_taa_matches_literal_theorem_3_2():
    T, D, m = 10, 64, 3
    x, R, dX, dF, _, _ = _round_inputs(B=1, T=T, D=D, m=m)
    got = tanderson.anderson_update(
        *(torch.from_numpy(a) for a in (x, R, dX, dF)),
        torch.ones((1, T), dtype=torch.bool), mode="taa", lam=1e-6)
    want_t = tanderson.taa_update_literal(x[0], R[0], dX[0], dF[0], 0, T - 1,
                                          1e-6)
    want_j = janderson.taa_update_literal(x[0], R[0], dX[0], dF[0], 0, T - 1,
                                          1e-6)
    assert np.array_equal(want_t, want_j)
    np.testing.assert_allclose(to_np(got[0]), want_t, rtol=2e-3, atol=2e-3)


def test_ops_rowwise_gamma_matches_jax_ops():
    m, t, d = 3, 12, 300
    dF, R = normal(0, m, t, d), normal(1, t, d)
    mask = (np.arange(t) >= 2).astype(np.float32)
    got = tops.taa_rowwise_gamma(torch.from_numpy(dF), torch.from_numpy(R),
                                 torch.from_numpy(mask), lam=1e-6)
    want = jops.taa_rowwise_gamma(jnp.asarray(dF), jnp.asarray(R),
                                  jnp.asarray(mask), lam=1e-6,
                                  use_pallas=True, interpret=True)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-3,
                               atol=1e-3)
