"""Port parity: schedules, solver coefficients, the k-th order system and
the sequential sampler against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coeffs as jcoeffs
from repro.core import system as jsystem
from repro.diffusion import samplers as jsamplers
from repro.diffusion import schedules as jschedules
from repro_torch.core import coeffs as tcoeffs
from repro_torch.core import system as tsystem
from repro_torch.diffusion import samplers as tsamplers
from repro_torch.diffusion import schedules as tschedules
from tests.helpers import make_oracle_denoiser
from tests.test_torch_helpers import (normal, oracle_arrays, rel_err, to_np,
                                      torch_oracle_denoiser)


@pytest.mark.parametrize("kind", ["linear", "cosine"])
def test_schedules_exact(kind):
    for a, b in zip(jschedules.make_schedule(kind, 1000),
                    tschedules.make_schedule(kind, 1000)):
        assert np.array_equal(a, b)
    assert np.array_equal(jschedules.sampling_grid(1000, 25),
                          tschedules.sampling_grid(1000, 25))


@pytest.mark.parametrize("T", [8, 25])
@pytest.mark.parametrize("eta", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_coeffs_and_system_matrices_exact_float64(T, eta, schedule):
    cj = jcoeffs.ddim_coeffs(T, eta=eta, schedule=schedule)
    ct = tcoeffs.ddim_coeffs(T, eta=eta, schedule=schedule)
    for name in ("a", "b", "c", "taus", "g2"):
        assert np.array_equal(getattr(cj, name), getattr(ct, name)), name
    assert ct.is_ode == cj.is_ode and ct.T == cj.T
    for k in (1, 4, T):
        mj, mt = jcoeffs.system_matrices(cj, k), tcoeffs.system_matrices(ct, k)
        for name in ("lift", "w_eps", "w_xi"):
            assert np.array_equal(getattr(mj, name), getattr(mt, name))
    assert np.array_equal(jcoeffs.ddpm_coeffs(T).c, tcoeffs.ddpm_coeffs(T).c)
    assert jcoeffs.abar_prod(cj.a, 2, T - 1) == tcoeffs.abar_prod(ct.a, 2, T - 1)


@pytest.mark.parametrize("order", [1, 3, 10])
def test_apply_F_and_residuals_match_jax_with_lane_axis(order):
    """Lane axis B=2 in the port against a per-lane JAX loop, 1e-6."""
    T, D = 10, 24
    coeffs = tcoeffs.ddpm_coeffs(T)
    mats = tcoeffs.system_matrices(coeffs, order)
    x, e, xi = (normal(s, 2, T + 1, D) for s in (1, 2, 3))
    lift, w_eps = (torch.from_numpy(m) for m in mats.as_f32()[:2])
    abc = tuple(torch.as_tensor(v, dtype=torch.float32)
                for v in (coeffs.a, coeffs.b, coeffs.c))
    tx, te, txi = (torch.from_numpy(v) for v in (x, e, xi))
    noise_t = tsystem.noise_term(mats, txi)
    F_t = tsystem.apply_F((lift, w_eps), tx, te, noise_t)
    r_t = tsystem.first_order_residuals(abc, tx, te, txi)
    jabc = tuple(jnp.asarray(v, jnp.float32)
                 for v in (coeffs.a, coeffs.b, coeffs.c))
    for lane in range(2):
        noise_j = jsystem.noise_term(mats, jnp.asarray(xi[lane]))
        F_j = jsystem.apply_F(tuple(map(jnp.asarray, mats.as_f32()[:2])),
                              jnp.asarray(x[lane]), jnp.asarray(e[lane]),
                              noise_j)
        r_j = jsystem.first_order_residuals(jabc, jnp.asarray(x[lane]),
                                            jnp.asarray(e[lane]),
                                            jnp.asarray(xi[lane]))
        assert rel_err(noise_t[lane], noise_j) < 1e-6
        assert rel_err(F_t[lane], F_j) < 1e-6
        assert rel_err(r_t[lane], r_j) < 1e-6
        lit_j = jsystem.apply_F_literal(coeffs, order, x[lane], e[lane],
                                        xi[lane])
        lit_t = tsystem.apply_F_literal(coeffs, order, x[lane], e[lane],
                                        xi[lane])
        assert np.array_equal(lit_j, lit_t)
        assert rel_err(F_t[lane], lit_t) < 1e-6


@pytest.mark.parametrize("mk", ["ddim", "ddpm"])
def test_sequential_sample_matches_jax(mk):
    T, D = 12, 48
    coeffs = (tcoeffs.ddim_coeffs if mk == "ddim" else tcoeffs.ddpm_coeffs)(T)
    xi = normal(7, 2, T + 1, D)
    eps_t = torch_oracle_denoiser(*oracle_arrays(D))
    eps_j = make_oracle_denoiser(D)
    traj_t = tsamplers._sequential_sample(eps_t, coeffs, torch.from_numpy(xi),
                                          return_traj=True)
    x0_t = tsamplers._sequential_sample(eps_t, coeffs, torch.from_numpy(xi))
    assert np.array_equal(to_np(traj_t[:, 0]), to_np(x0_t))
    for lane in range(2):
        traj_j = jsamplers._sequential_sample(eps_j, coeffs,
                                              jnp.asarray(xi[lane]),
                                              return_traj=True)
        assert rel_err(traj_t[lane], traj_j) < 1e-5


def test_draw_noises_is_seeded_torch_generator():
    coeffs = tcoeffs.ddim_coeffs(8)
    a = tsamplers.draw_noises(3, coeffs, (4, 2))
    assert a.shape == (9, 4, 2) and a.dtype == torch.float32
    assert torch.equal(a, tsamplers.draw_noises(3, coeffs, (4, 2)))
    assert not torch.equal(a, tsamplers.draw_noises(4, coeffs, (4, 2)))
