"""Port parity for the ParaTAA solver and the functional sampling API:
trajectories, iters and nfe against the JAX package with the same noise
and a torch twin of the oracle denoiser."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import parataa as jparataa
from repro.sampling import api as japi
from repro.sampling import specs as jspecs
from repro.sampling.types import SampleRequest as JRequest
from repro.sampling.types import WarmStart as JWarm
from repro_torch.core import parataa as tparataa
from repro_torch.core.coeffs import ddim_coeffs, ddpm_coeffs
from repro_torch.sampling import api as tapi
from repro_torch.sampling import specs as tspecs
from repro_torch.sampling.types import SampleRequest, WarmStart
from tests.helpers import make_oracle_denoiser
from tests.test_torch_helpers import (normal, oracle_arrays, rel_err, to_np,
                                      torch_oracle_denoiser)

D = 48
T = 12
EPS_J = make_oracle_denoiser(D)
EPS_T = torch_oracle_denoiser(*oracle_arrays(D))

# name -> (mode, order_k, history_m, window)
VARIANTS = {
    "seq": ("seq", 1, 1, 0),
    "fp": ("fp", T, 1, 0),
    "fp+": ("fp", 4, 1, 0),
    "aa": ("aa", 4, 3, 0),
    "aa+": ("aa+", 4, 3, 0),
    "taa": ("taa", 4, 3, 0),
    "taa-window": ("taa", 4, 3, 5),
}


def _cfgs(name, **kw):
    mode, k, m, w = VARIANTS[name]
    base = dict(order_k=k, history_m=m, window=w, mode=mode, tau=1e-3,
                s_max=4 * T, safeguard=mode != "seq")
    base.update(kw)
    return jparataa.ParaTAAConfig(**base), tparataa.ParaTAAConfig(**base)


def _check_lanes(traj_t, info_t, runs_j):
    for lane, (traj_j, info_j) in enumerate(runs_j):
        assert int(info_t["iters"][lane]) == int(info_j["iters"]), lane
        assert int(info_t["nfe"][lane]) == int(info_j["nfe"]), lane
        assert bool(info_t["converged"][lane]) == bool(info_j["converged"])
        assert rel_err(traj_t[lane], traj_j) < 1e-4, lane


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("mk", ["ddim", "ddpm"])
def test_sample_matches_jax_per_lane(name, mk):
    """Two lanes with different noise in one port solve against two JAX
    solves: each lane's trajectory, iters and nfe."""
    coeffs = (ddim_coeffs if mk == "ddim" else ddpm_coeffs)(T)
    cj, ct = _cfgs(name)
    xi = normal(11, 2, T + 1, D)
    traj_t, info_t = tparataa.sample(EPS_T, coeffs, ct, torch.from_numpy(xi))
    runs_j = [jparataa.sample(EPS_J, coeffs, cj, jnp.asarray(xi[b]))
              for b in range(2)]
    _check_lanes(traj_t, info_t, runs_j)


@pytest.mark.parametrize("t_init", [None, T // 2, 0])
def test_warm_start_t_init_matches_jax(t_init):
    """Warm starts from a perturbed solved trajectory at T_init in
    {None (full restart), T/2, 0 (verify only)}, mixed with a cold lane."""
    coeffs = ddim_coeffs(T)
    cj, ct = _cfgs("taa")
    xi = normal(3, 2, T + 1, D)
    solved, _ = jparataa.sample(EPS_J, coeffs, cj, jnp.asarray(xi[0]))
    x_init = np.stack([np.asarray(solved) + normal(4, T + 1, D, scale=1e-3),
                       xi[1]])
    t_inits = [t_init, None]
    traj_t, info_t = tparataa.sample(
        EPS_T, coeffs, ct, torch.from_numpy(xi),
        x_init=torch.from_numpy(x_init),
        t_init=torch.tensor([T if t is None else t for t in t_inits]))
    runs_j = [jparataa.sample(EPS_J, coeffs, cj, jnp.asarray(xi[b]),
                              x_init=jnp.asarray(x_init[b]), t_init=t_inits[b])
              for b in range(2)]
    _check_lanes(traj_t, info_t, runs_j)


def test_fused_round_solver_matches_jax_and_port_staged():
    coeffs = ddpm_coeffs(T)
    cj, ct = _cfgs("taa", fuse_round=True)
    xi = normal(5, 2, T + 1, D)
    traj_t, info_t = tparataa.sample(EPS_T, coeffs, ct, torch.from_numpy(xi))
    staged_t, _ = tparataa.sample(EPS_T, coeffs,
                                  dataclasses.replace(ct, fuse_round=False),
                                  torch.from_numpy(xi))
    assert torch.equal(traj_t, staged_t)    # CPU: the same staged round
    _check_lanes(traj_t, info_t,
                 [jparataa.sample(EPS_J, coeffs, cj, jnp.asarray(xi[b]))
                  for b in range(2)])


def test_per_lane_tau_and_iter_cap_match_jax():
    coeffs = ddim_coeffs(T)
    cj, ct = _cfgs("taa")
    xi = normal(6, 2, T + 1, D)
    tau_sq, caps = [np.float32(1e-2 ** 2), np.float32(1e-3 ** 2)], [20, 3]
    traj_t, info_t = tparataa.sample(
        EPS_T, coeffs, ct, torch.from_numpy(xi),
        tau_sq=torch.tensor(np.array(tau_sq)), iter_cap=torch.tensor(caps))
    runs_j = [jparataa.sample(EPS_J, coeffs, cj, jnp.asarray(xi[b]),
                              tau_sq=tau_sq[b], iter_cap=caps[b])
              for b in range(2)]
    _check_lanes(traj_t, info_t, runs_j)
    assert int(info_t["iters"][1]) == 3 and not bool(info_t["converged"][1])


def test_sample_recording_matches_jax():
    coeffs = ddim_coeffs(T)
    cj, ct = _cfgs("taa", s_max=10)
    xi = normal(8, 1, T + 1, D)
    traj_t, info_t = tparataa.sample_recording(EPS_T, coeffs, ct,
                                               torch.from_numpy(xi))
    traj_j, info_j = jparataa.sample_recording(EPS_J, coeffs, cj,
                                               jnp.asarray(xi[0]))
    assert rel_err(traj_t[0], traj_j) < 1e-4
    assert np.array_equal(to_np(info_t["t2_history"][0]),
                          np.asarray(info_j["t2_history"]))
    assert np.array_equal(to_np(info_t["done_history"][0]),
                          np.asarray(info_j["done_history"]))
    finite = np.isfinite(np.asarray(info_j["res_history"]))
    np.testing.assert_allclose(to_np(info_t["res_history"][0])[finite],
                               np.asarray(info_j["res_history"])[finite],
                               rtol=1e-3, atol=1e-6)
    assert rel_err(info_t["x0_history"][0], info_j["x0_history"]) < 1e-4


@pytest.mark.parametrize("name", ["taa", "seq"])
def test_step_chunk_driven_to_finished_equals_sample(name):
    coeffs = ddim_coeffs(T)
    _, ct = _cfgs(name)
    xi = torch.from_numpy(normal(9, 2, T + 1, D))
    want, _ = tparataa.sample(EPS_T, coeffs, ct, xi)
    state = tparataa.init_state(coeffs, ct, xi)
    while not bool(state.finished.all()):
        state = tparataa.step_chunk(EPS_T, coeffs, ct, state, 3)
    assert torch.equal(state.x, want)
    assert bool(state.done.all())


@pytest.mark.parametrize("name,diagnostics", [
    ("seq", False), ("fp+", False), ("aa+", False), ("taa", False),
    ("fp+", True), ("aa+", True), ("taa", True)])
def test_api_run_matches_jax_run(name, diagnostics):
    coeffs = ddim_coeffs(T)
    spec_j = jspecs.get_sampler(name, s_max=30)
    spec_t = tspecs.get_sampler(name, s_max=30)
    xi = normal(10, T + 1, D)
    req_j, req_t = JRequest(label=1, seed=2, tau=3e-3), \
        SampleRequest(label=1, seed=2, tau=3e-3)
    if name == "seq":
        req_j, req_t = None, None
    res_j = japi.run(spec_j, EPS_J, coeffs, jnp.asarray(xi),
                     diagnostics=diagnostics, request=req_j)
    res_t = tapi.run(spec_t, EPS_T, coeffs, torch.from_numpy(xi),
                     diagnostics=diagnostics, request=req_t)
    assert (res_t.iters, res_t.nfe, res_t.converged, res_t.early_stopped) == \
        (int(res_j.iters), int(res_j.nfe), bool(res_j.converged),
         bool(res_j.early_stopped))
    assert rel_err(res_t.trajectory, res_j.trajectory) < 1e-4
    if diagnostics:
        assert np.array_equal(to_np(res_t.diagnostics["t2_history"]),
                              np.asarray(res_j.diagnostics["t2_history"]))


def test_api_run_warm_start_matches_jax():
    coeffs = ddim_coeffs(T)
    xi = normal(12, T + 1, D)
    first = tapi.run(tspecs.get_sampler("taa"), EPS_T, coeffs,
                     torch.from_numpy(xi))
    init = np.asarray(to_np(first.trajectory))
    res_t = tapi.run(tspecs.get_sampler("taa"), EPS_T, coeffs,
                     torch.from_numpy(xi), init=WarmStart(init, t_init=T // 2))
    res_j = japi.run(jspecs.get_sampler("taa"), EPS_J, coeffs, jnp.asarray(xi),
                     init=JWarm(jnp.asarray(init), t_init=T // 2))
    assert res_t.iters == int(res_j.iters) and res_t.nfe == int(res_j.nfe)
    assert rel_err(res_t.x0, res_j.x0) < 1e-4


def test_sampler_registry_matches_jax():
    assert tspecs.sampler_names() == jspecs.sampler_names()
    for name in tspecs.sampler_names():
        st, sj = tspecs.get_sampler(name), jspecs.get_sampler(name)
        for f in dataclasses.fields(st):
            assert getattr(st, f.name) == getattr(sj, f.name), (name, f.name)
        if not st.is_sequential:
            ct, cj = st.solver_config(25), sj.solver_config(25)
            for f in dataclasses.fields(ct):
                assert getattr(ct, f.name) == getattr(cj, f.name)
