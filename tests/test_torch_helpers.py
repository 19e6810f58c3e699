"""Shared helpers for the PyTorch-port parity tests (no tests here).

Inputs are made with numpy from a seed and handed to both the JAX package
and the port; JAX stays on the CPU and the two exchange numpy arrays.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion.schedules import make_schedule

CPU = torch.device("cpu")


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for a test that runs the port alone, restored
    after it.  The suite's parallel workers share the host's cores, and a
    torch thread a core in every worker oversubscribes them many times
    over: spinning threads then wait on descheduled ones at every
    parallel op.  Tests that also run the JAX package keep the default
    (the thread count a process starts its XLA client with moves the
    reference's float sums)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _tol(dtype):
    """The JAX package's kernel tolerances (tests/test_kernels.py)."""
    return 2e-2 if dtype in (jnp.bfloat16, torch.bfloat16) else 3e-5


def gram_tol(dF, R, mask) -> float:
    """Bound for a Gram block summed in another order: 2^-16 of the
    largest sum of absolute products, max_ij sum_d |w dF_i| |w dF_j| (and
    the same with R) — the magnitude that float32 rounding scales with."""
    from repro_torch.kernels.ref import taa_gram_ref

    Ga, ua = taa_gram_ref(dF.float().abs(), R.float().abs(), mask.abs())
    return 2.0 ** -16 * max(float(Ga.max()), float(ua.max()), 1.0)


def rel_err(a, b) -> float:
    """max |a - b| / max |b| over float64 copies."""
    a = np.asarray(to_np(a), np.float64)
    b = np.asarray(to_np(b), np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def max_abs(a, b) -> float:
    a = np.asarray(to_np(a), np.float64)
    b = np.asarray(to_np(b), np.float64)
    return float(np.max(np.abs(a - b)))


def to_np(x) -> np.ndarray:
    """jax array / torch tensor / numpy -> numpy (bf16 as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def normal(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def both(arr: np.ndarray, dtype: str = "float32"):
    """One numpy array -> (jax array, torch CPU tensor) of ``dtype``."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(
        np.ascontiguousarray(arr)).to(tdt)


# --- oracle denoisers (torch twins of tests/helpers.py) ----------------------


def oracle_arrays(dim: int, seed: int = 0):
    """The (xstar, W) that ``tests.helpers.make_oracle_denoiser`` draws."""
    key = jax.random.PRNGKey(seed)
    xstar = jax.random.normal(key, (dim,))
    W = jax.random.normal(jax.random.fold_in(key, 3), (dim, dim)) / np.sqrt(dim)
    return np.array(xstar), np.array(W)


def label_arrays(dim: int = 32, n_labels: int = 4, seed: int = 0):
    """The (xstars, W) that ``tests.helpers.make_label_denoiser`` draws."""
    key = jax.random.PRNGKey(seed)
    xstars = jax.random.normal(key, (n_labels, dim))
    W = jax.random.normal(jax.random.fold_in(key, 3), (dim, dim)) / np.sqrt(dim)
    return np.array(xstars), np.array(W)


def _abar_t():
    return torch.as_tensor(make_schedule("linear", 1000)[0], dtype=torch.float32)


def torch_oracle_denoiser(xstar: np.ndarray, W: np.ndarray,
                          nonlin: float = 0.3):
    """Torch twin of ``make_oracle_denoiser``: eps_fn(x (n, D), taus (n,))."""
    abar = _abar_t()
    xs, Wt = torch.from_numpy(xstar), torch.from_numpy(W)

    def eps_fn(x, taus):
        ab = abar[torch.clamp(taus.to(torch.int32), 0, 999).long()][:, None]
        lin = (x - torch.sqrt(ab) * xs[None]) / torch.sqrt(1.0 - ab + 1e-8)
        return lin + nonlin * torch.tanh(x @ Wt)

    return eps_fn


def torch_label_denoiser(xstars: np.ndarray, W: np.ndarray,
                         nonlin: float = 0.3):
    """Torch twin of ``make_label_denoiser``: (params, x, taus, y) -> eps."""
    abar = _abar_t()
    xs, Wt = torch.from_numpy(xstars), torch.from_numpy(W)
    n_labels = xs.shape[0]

    def eps_apply(params, x, taus, y):
        ab = abar[torch.clamp(taus.to(torch.int32), 0, 999).long()][:, None]
        lin = (x - torch.sqrt(ab) * xs[torch.clamp(y, 0, n_labels - 1)]) \
            / torch.sqrt(1.0 - ab + 1e-8)
        return lin + nonlin * torch.tanh(x @ Wt)

    return eps_apply


# --- DiT params for both packages ---------------------------------------------


def dit_param_trees(cfg_jax, seed: int = 0, ada_scale: float = 0.05,
                    fan_in_qk: bool = True):
    """Nonzero DiT params in the JAX package's tree (its ``dit_defs``
    shapes), drawn from numpy with its initializer's statistics — lecun
    N(0, 1/shape[-2]), normal N(0, 0.02^2) — and the adaLN-zero leaves
    (ada, final_ada, out_proj) N(0, ada_scale^2).

    The lecun rule divides wq/wk by the head count (shape[-2]), which
    saturates the softmax: then the float32 function itself is off its
    float64 value by more than 1e-5, and a 1e-5 parity bound would measure
    conditioning, not the port.  ``fan_in_qk`` rescales wq/wk to std 1/sqrt(d_model).
    Returns (jax tree, numpy tree)."""
    from repro.diffusion import dit as jdit
    from repro.models import pdefs

    rng = np.random.default_rng(seed)

    def draw(d):
        std = {"zeros": ada_scale, "lecun": 1.0 / np.sqrt(d.shape[-2])}.get(
            d.init, d.scale or 0.02)
        return (rng.standard_normal(d.shape) * std).astype(np.float32)

    tree = jax.tree.map(draw, jdit.dit_defs(cfg_jax), is_leaf=pdefs.is_def)
    if fan_in_qk:
        rescale = np.float32(np.sqrt(cfg_jax.num_heads / cfg_jax.d_model))
        for key in ("wq", "wk"):
            tree["blocks"][key] *= rescale
    return jax.tree.map(jnp.asarray, tree), tree


def torch_cfg(cfg_jax):
    """The port's ArchConfig with the same fields as a JAX ArchConfig."""
    import dataclasses

    from repro_torch.configs.base import ArchConfig

    names = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in dataclasses.asdict(cfg_jax).items()
                         if k in names})


# --- serving stacks over the label oracle, for both packages -------------------


def label_factories(dim: int = 24, n_labels: int = 4):
    """(jax factory, torch factory), each ``(EngineKey, spec_kw=None,
    **engine_kw) -> SamplingEngine`` over the label oracle denoiser (the
    sampler ``get_sampler(key.solver, **spec_kw)``), the port's noise the
    JAX package's draw for the same seed (``noise_fn``)."""
    from repro.core import ddim_coeffs as jddim
    from repro.diffusion.samplers import draw_noises as jdraw
    from repro.sampling import SamplingEngine as JEngine
    from repro.sampling import get_sampler as jget
    from repro_torch.core import ddim_coeffs as tddim
    from repro_torch.sampling import SamplingEngine as TEngine
    from repro_torch.sampling import get_sampler as tget
    from tests.helpers import make_label_denoiser

    eps_j = make_label_denoiser(dim=dim, n_labels=n_labels)
    eps_t = torch_label_denoiser(*label_arrays(dim, n_labels))
    noises = {}

    def noise_fn(coeffs):
        def draw(req):
            key = (coeffs.T, req.seed)
            if key not in noises:
                noises[key] = np.asarray(jdraw(jax.random.PRNGKey(req.seed),
                                               coeffs, (dim,)))
            return noises[key]
        return draw

    def jax_factory(key, spec_kw=None, **kw):
        return JEngine(eps_j, None, jddim(key.T),
                       jget(key.solver, **(spec_kw or {})),
                       sample_shape=(dim,), **kw)

    def torch_factory(key, spec_kw=None, **kw):
        coeffs = tddim(key.T)
        return TEngine(eps_t, None, coeffs,
                       tget(key.solver, **(spec_kw or {})),
                       sample_shape=(dim,), device=CPU,
                       noise_fn=noise_fn(coeffs), **kw)

    return jax_factory, torch_factory


def assert_same_result(got, want, tol: float = 1e-4) -> None:
    """A port SampleResult against the JAX package's: iters/nfe/flags
    exactly, the trajectory within ``tol`` relative."""
    assert (got.iters, got.nfe, got.converged, got.early_stopped) == \
        (int(want.iters), int(want.nfe), bool(want.converged),
         bool(want.early_stopped)), (got.request, want.request)
    assert got.request.label == want.request.label
    assert got.request.seed == want.request.seed
    assert rel_err(got.trajectory, want.trajectory) < tol, got.request
