"""The port's solve path reads the device on the host only where it means
to: ``step_chunk`` and the staged round make no host read at all, and
``sample`` makes one (its poll) per iteration.  Checked on the CPU with a
dispatch mode that sees every host read of a tensor's value; on the card
``chip_smoke.py`` runs each solve under ``torch.cuda.set_sync_debug_mode``.
Also the one-request ``sequential_sample`` against the JAX package's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import parataa as jparataa
from repro.sampling import sequential_sample as jsequential_sample
from repro_torch.core import parataa as tparataa
from repro_torch.core.coeffs import ddim_coeffs, ddpm_coeffs
from repro_torch.kernels import ops
from repro_torch.sampling import sequential_sample
from tests.helpers import make_oracle_denoiser
from tests.test_torch_helpers import (normal, oracle_arrays, rel_err,
                                      torch_oracle_denoiser)

D = 48
T = 12
EPS_J = make_oracle_denoiser(D)
EPS_T = torch_oracle_denoiser(*oracle_arrays(D))

#: the ops through which a tensor's value reaches the host
HOST_READS = {torch.ops.aten._local_scalar_dense, torch.ops.aten.is_nonzero,
              torch.ops.aten.item, torch.ops.aten._linalg_check_errors}


class HostReads(TorchDispatchMode):
    """Counts the host reads made under it; raises on the first one unless
    ``allow``."""

    def __init__(self, allow: bool = False):
        super().__init__()
        self.allow = allow
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in HOST_READS:
            self.reads.append(str(func))
            if not self.allow:
                raise AssertionError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


# name -> (mode, order_k, history_m, fuse_round)
STEP_VARIANTS = {
    "taa staged": ("taa", 4, 3, False),
    "taa fused": ("taa", 4, 3, True),
    "fp": ("fp", T, 1, False),
    "seq": ("seq", 1, 1, False),
}


def _cfg(name):
    mode, k, m, fuse = STEP_VARIANTS[name]
    return tparataa.ParaTAAConfig(
        order_k=k, history_m=m, mode=mode, tau=1e-3, s_max=4 * T,
        safeguard=mode != "seq", fuse_round=fuse)


@pytest.mark.parametrize("name", list(STEP_VARIANTS))
def test_step_chunk_reads_nothing_on_the_host(name):
    """init_state and step_chunk past every lane's finish (finished lanes
    pass through): no host read, and the same trajectory as sample."""
    coeffs = ddim_coeffs(T)
    cfg = _cfg(name)
    xi = torch.from_numpy(normal(5, 2, T + 1, D))
    want, info = tparataa.sample(EPS_T, coeffs, cfg, xi)
    n = int(info["iters"].max())
    with HostReads():
        state = tparataa.init_state(coeffs, cfg, xi)
        state = tparataa.step_chunk(EPS_T, coeffs, cfg, state, n + 2)
    assert bool(state.finished.all())
    assert torch.equal(state.x, want)
    assert torch.equal(state.it, info["iters"])
    assert torch.equal(state.nfe, info["nfe"])


@pytest.mark.parametrize("mode", ["taa", "aa", "aa+"])
def test_staged_round_reads_nothing_on_the_host(mode):
    B, m, Tn, Dn = 2, 3, 9, 40
    x, R = normal(0, B, Tn, Dn), normal(1, B, Tn, Dn, scale=0.3)
    dX, dF = normal(2, B, m, Tn, Dn, scale=0.1), \
        normal(3, B, m, Tn, Dn, scale=0.1)
    mask = torch.from_numpy((np.arange(Tn) >= 2).astype(np.float32)
                            ).expand(B, Tn)
    guard = torch.from_numpy(np.arange(Tn) >= Tn - 2).expand(B, Tn)
    args = [torch.from_numpy(a) for a in (x, R, dX, dF)]
    with HostReads():
        out = ops.taa_round_staged(*args, mask, mode=mode, lam=1e-6,
                                   safeguard_mask=guard)
        fused = ops.taa_round(*args, mask, mode=mode, lam=1e-6,
                              safeguard_mask=guard)
    assert torch.equal(out, fused) and bool(torch.isfinite(out).all())


def test_the_guard_sees_host_reads():
    """What the tests above rule out: ``bool`` of a tensor and the error
    check of ``torch.linalg.solve`` are host reads."""
    A = torch.eye(3).expand(2, 3, 3) * 2.0
    b = torch.ones(2, 3, 1)
    with pytest.raises(AssertionError, match="host read"):
        with HostReads():
            torch.linalg.solve(A, b)
    with pytest.raises(AssertionError, match="host read"):
        with HostReads():
            bool(b.all())
    with HostReads():
        torch.linalg.solve_ex(A, b, check_errors=False)


@pytest.mark.parametrize("name", ["taa staged", "taa fused", "fp"])
def test_sample_polls_once_per_iteration(name, monkeypatch):
    """sample calls poll_finished exactly as often as its slowest lane
    iterates, and reads the host nowhere else; it reports that count."""
    coeffs = ddim_coeffs(T)
    cfg = _cfg(name)
    calls = []
    poll = tparataa.poll_finished

    def counted(state):
        calls.append(1)
        return poll(state)

    monkeypatch.setattr(tparataa, "poll_finished", counted)
    xi = torch.from_numpy(normal(7, 3, T + 1, D))
    with HostReads(allow=True) as reads:
        _, info = tparataa.sample(EPS_T, coeffs, cfg, xi)
    iters_max = int(info["iters"].max())
    assert len(calls) == iters_max == info["polls"]
    assert len(reads.reads) == iters_max
    assert iters_max > 1


@pytest.mark.parametrize("mk", ["ddim", "ddpm"])
@pytest.mark.parametrize("return_traj", [False, True])
def test_sequential_sample_matches_jax(mk, return_traj):
    """The public one-request signature (eps_fn, coeffs, xi (T+1, *shape))
    against ``repro.sampling.sequential_sample`` on the same xi."""
    coeffs = (ddim_coeffs if mk == "ddim" else ddpm_coeffs)(T)
    xi = normal(13, T + 1, D)
    got = sequential_sample(EPS_T, coeffs, torch.from_numpy(xi),
                            return_traj=return_traj)
    want = jsequential_sample(EPS_J, coeffs, jnp.asarray(xi),
                              return_traj=return_traj)
    assert got.shape == ((T + 1, D) if return_traj else (D,))
    assert rel_err(got, want) < 1e-5


def test_sequential_sample_is_the_solvers_fixed_point():
    """ParaTAA converges to the sequential trajectory (Theorem 2.2): the
    public sampler agrees with the JAX solver's solution."""
    coeffs = ddim_coeffs(T)
    xi = normal(17, T + 1, D)
    cfg = jparataa.ParaTAAConfig(order_k=4, history_m=3, mode="taa",
                                 tau=1e-4, s_max=4 * T)
    solved, _ = jparataa.sample(EPS_J, coeffs, cfg, jnp.asarray(xi))
    traj = sequential_sample(EPS_T, coeffs, torch.from_numpy(xi),
                             return_traj=True)
    assert rel_err(traj, solved) < 2e-2
