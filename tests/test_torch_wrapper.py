"""Port parity for the DiffusionWrapper (any LM backbone as a causal
latent-sequence denoiser: attention, mamba2, the RG-LRU hybrid, MoE) and ParaTAA with it as eps_theta: the
same numpy-seeded weights, latents and noise through the JAX package and
the port, on the CPU, at each config's ``reduced()`` size."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ddim_coeffs as jddim
from repro.diffusion import dit as jdit
from repro.models import pdefs as jpdefs
from repro.sampling import get_sampler as jget
from repro.sampling import run as jrun
from repro.sampling import sequential_sample as jseq
from repro_torch.core import ddim_coeffs as tddim
from repro_torch.diffusion import dit as tdit
from repro_torch.diffusion.convert import (wrapper_init, wrapper_init_numpy,
                                           wrapper_params_from_numpy)
from repro_torch.models import pdefs as tpdefs
from repro_torch.sampling import get_sampler as tget
from repro_torch.sampling import run as trun
from repro_torch.sampling import sequential_sample as tseq
from repro_torch.tree import leaves
from tests.test_torch_backbone import ATTN_ARCHS, cfgs, keystr, perturb
from tests.test_torch_helpers import CPU, normal, rel_err

LATENT, TOKENS, T = 8, 16, 20
OUT_SCALE = 0.02


def wrapper_trees(name, seed=0):
    cj, ct = cfgs(name)
    tree = wrapper_init_numpy(ct, LATENT, seed, out_scale=OUT_SCALE)
    perturb(tree["backbone"], seed + 1)
    return (cj, jax.tree.map(jnp.asarray, tree),
            ct, wrapper_params_from_numpy(tree, ct, LATENT, CPU))


def check_wrapper_defs(name):
    cj, ct = cfgs(name)
    want = {jax.tree_util.keystr(p): d.shape for p, d in
            jax.tree_util.tree_flatten_with_path(
                jdit.wrapper_defs(cj, LATENT), is_leaf=jpdefs.is_def)[0]}
    got = {keystr(path): spec.shape
           for path, spec in tpdefs.walk(tdit.wrapper_defs(ct, LATENT))}
    assert got == want


def check_wrapper_apply(name):
    cj, pj, ct, pt = wrapper_trees(name)
    lat = normal(2, 3, TOKENS, LATENT)
    t = np.array([10.0, 500.0, 999.0], np.float32)
    want = jdit.wrapper_apply(pj, cj, jnp.asarray(lat), jnp.asarray(t))
    got = tdit.wrapper_apply(pt, ct, torch.from_numpy(lat),
                             torch.from_numpy(t))
    assert got.shape == (3, TOKENS, LATENT)
    assert rel_err(got, want) < 1e-4


@pytest.mark.parametrize("name", ATTN_ARCHS)
def test_wrapper_defs_match_jax(name):
    check_wrapper_defs(name)


@pytest.mark.parametrize("name", ATTN_ARCHS)
def test_wrapper_apply_matches_jax(name):
    check_wrapper_apply(name)


def test_untrained_wrapper_is_zero():
    """``out_proj`` starts at zeros, as in the reference: eps = 0."""
    _, ct = cfgs("qwen3-0.6b")
    pt = wrapper_init(ct, LATENT, 0, CPU)
    assert not pt["out_proj"].any()
    out = tdit.wrapper_apply(pt, ct, torch.ones(2, TOKENS, LATENT),
                             torch.tensor([1.0, 2.0]))
    assert not out.any()


def test_wrapper_remat_gives_the_same_values():
    _, _, ct, pt = wrapper_trees("granite-8b")
    lat = torch.from_numpy(normal(3, 2, TOKENS, LATENT))
    t = torch.tensor([3.0, 700.0])
    outs = []
    flat = leaves(pt)
    for remat in (False, True):
        for p in flat:
            p.requires_grad_(True)
        out = tdit.wrapper_apply(pt, ct, lat, t, remat=remat)
        grads = torch.autograd.grad(out.square().sum(), flat,
                                    allow_unused=True)
        for p in flat:
            p.requires_grad_(False)
        outs.append((out.detach(), grads))
    (o0, g0), (o1, g1) = outs
    assert torch.equal(o0, o1)
    for a, b in zip(g0, g1):
        assert (a is None and b is None) or torch.equal(a, b)


def check_parataa_on_the_wrapper(name, fuse):
    """ParaTAA (``run``, taa, DDIM T=20) with the wrapper as eps_theta in
    both packages from the same noise: equal iters and nfe, x0 and the
    trajectory within 1e-4 relative; and within 2e-2 of the port's
    sequential DDIM (Theorem 2.2), which matches the reference's."""
    cj, pj, ct, pt = wrapper_trees(name, seed=4)
    xi = normal(5, T + 1, TOKENS, LATENT)
    want = jrun(jget("taa", fuse_round=fuse),
                lambda x, taus: jdit.wrapper_apply(pj, cj, x, taus),
                jddim(T), jnp.asarray(xi))
    eps_t = lambda x, taus: tdit.wrapper_apply(pt, ct, x, taus)
    got = trun(tget("taa", fuse_round=fuse), eps_t, tddim(T),
               torch.from_numpy(xi))
    assert (got.iters, got.nfe, got.converged) == \
        (int(want.iters), int(want.nfe), bool(want.converged))
    assert 1 < got.iters < T
    assert rel_err(got.x0, want.x0) < 1e-4
    assert rel_err(got.trajectory, want.trajectory) < 1e-4
    if fuse:
        return
    x_seq = tseq(eps_t, tddim(T), torch.from_numpy(xi))
    assert rel_err(got.x0, x_seq) < 2e-2
    assert rel_err(x_seq, jseq(lambda x, taus: jdit.wrapper_apply(
        pj, cj, x, taus), jddim(T), jnp.asarray(xi))) < 1e-4


@pytest.mark.parametrize("fuse", [False, True], ids=["staged", "fused"])
@pytest.mark.parametrize("name", ATTN_ARCHS)
def test_parataa_on_the_wrapper_matches_jax(name, fuse):
    check_parataa_on_the_wrapper(name, fuse)
