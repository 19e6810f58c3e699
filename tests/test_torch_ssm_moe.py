"""Port parity for the mamba2, RG-LRU and MoE modules, function by
function: the same numpy inputs through the JAX package's
``repro.models.{mamba2,rglru,moe}`` (jitted, on the CPU) and the port's,
float32 within 1e-4 relative (bf16 2e-2), MoE routing ids exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jm
from repro.models import moe as jmoe
from repro.models import rglru as jr
from repro_torch.models import mamba2 as tm
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as tr
from repro_torch.models.pdefs import init_numpy, params_from_numpy
from tests.test_torch_backbone import cfgs, jax_params, perturb
from tests.test_torch_helpers import CPU, both, normal, rel_err, to_np


def block_params(cj, ct, defs_j, defs_t, seed):
    """(JAX, port) float32 params of one block from one numpy tree, its
    constant inits perturbed."""
    tree = perturb(init_numpy(defs_t, seed), seed + 1)
    return jax_params(cj, tree, defs=defs_j), params_from_numpy(
        defs_t, tree, CPU)


# --- mamba2 -------------------------------------------------------------------


def test_causal_conv_with_carry():
    x, k, c = normal(0, 2, 7, 12), normal(1, 4, 12), normal(2, 2, 3, 12)
    want, carry_j = jax.jit(jm._causal_conv)(*map(jnp.asarray, (x, k, c)))
    got, carry_t = tm._causal_conv(*map(torch.from_numpy, (x, k, c)))
    assert rel_err(got, want) < 1e-6 and rel_err(carry_t, carry_j) == 0.0
    want0, _ = jm._causal_conv(jnp.asarray(x), jnp.asarray(k))
    got0, _ = tm._causal_conv(torch.from_numpy(x), torch.from_numpy(k))
    assert rel_err(got0, want0) < 1e-6


def ssd_inputs(b, s, h, p, g, n, seed, pad=0):
    """SSD inputs with dt > 0 and A < 0; ``pad`` steps of dt = 0 (and
    zeros) appended, as ``mamba_apply`` pads to a chunk multiple."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (0.1 + rng.random((b, s, h))).astype(np.float32)
    A = -(0.5 + rng.random(h)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    widths = lambda a: [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)
    return [np.pad(a, widths(a)) for a in (x, dt)] + [A] + \
        [np.pad(a, widths(a)) for a in (B, C)]


@pytest.mark.parametrize("s,pad,g,init", [
    (64, 0, 1, False), (64, 0, 1, True), (40, 8, 1, True), (40, 8, 2, True),
    (16, 0, 2, False)], ids=["4chunks", "init", "ragged", "groups2",
                             "onechunk"])
def test_ssd_chunked_matches_jax(s, pad, g, init):
    """Several chunks of 16, a ragged length padded with dt = 0 steps
    (the padded outputs cut, the state passing through them), an initial
    state, and 2 groups of 2 heads each."""
    args = ssd_inputs(2, s, 4, 8, g, 16, seed=s + g, pad=pad)
    state = normal(7, 2, 4, 8, 16) if init else None
    y_j, st_j = jax.jit(jm._ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, args), 16,
        None if state is None else jnp.asarray(state))
    y_t, st_t = tm._ssd_chunked(
        *map(torch.from_numpy, args), 16,
        None if state is None else torch.from_numpy(state))
    assert rel_err(y_t[:, :s], np.asarray(y_j)[:, :s]) < 1e-4
    assert rel_err(st_t, st_j) < 1e-4
    if pad:     # the state after the padding is the state after step s
        _, st_s = jm._ssd_chunked(*map(jnp.asarray, ssd_inputs(
            2, s, 4, 8, g, 16, seed=s + g)), 8,
            None if state is None else jnp.asarray(state))
        assert rel_err(st_t, st_s) < 1e-4


def test_ssd_decode_matches_jax():
    x, dt, A, B, C = ssd_inputs(3, 1, 4, 8, 2, 16, seed=5)
    state = normal(6, 3, 4, 8, 16)
    args = (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], state)
    y_j, st_j = jax.jit(jm._ssd_decode)(*map(jnp.asarray, args))
    y_t, st_t = tm._ssd_decode(*map(torch.from_numpy, args))
    assert rel_err(y_t, y_j) < 1e-5 and rel_err(st_t, st_j) < 1e-5


@pytest.mark.parametrize("ngroups", [1, 2])
def test_mamba_apply_each_mode_matches_jax(ngroups):
    """``mamba_apply`` train (40 tokens: 2 chunks + padding), prefill of 20
    into a cache and 4 decode steps: outputs and every cache leaf."""
    cj, ct = cfgs("mamba2-1.3b", ssm_ngroups=ngroups)
    pj, pt = block_params(cj, ct, jm.mamba_def(cj), tm.mamba_def(ct), 3)
    x = normal(4, 2, 40, ct.d_model, scale=0.5)
    y_j, _ = jax.jit(lambda p, x: jm.mamba_apply(p, cj, x))(pj, jnp.asarray(x))
    y_t, c_t = tm.mamba_apply(pt, ct, torch.from_numpy(x))
    assert c_t is None and rel_err(y_t, y_j) < 1e-4

    cache_j = jm.init_mamba_cache(cj, 2, jnp.float32)
    cache_t = tm.init_mamba_cache(ct, 2, torch.float32, CPU)
    step = jax.jit(lambda p, x, c, mode: jm.mamba_apply(p, cj, x, mode=mode,
                                                        cache=c),
                   static_argnums=3)
    for t0, t1, mode in ((0, 20, "prefill"),) + tuple(
            (t, t + 1, "decode") for t in range(20, 24)):
        y_j, cache_j = step(pj, jnp.asarray(x[:, t0:t1]), cache_j, mode)
        y_t, out = tm.mamba_apply(pt, ct, torch.from_numpy(x[:, t0:t1]),
                                  mode=mode, cache=cache_t)
        assert out is cache_t and rel_err(y_t, y_j) < 1e-4, (mode, t0)
        for key in cache_t:
            assert rel_err(cache_t[key], cache_j[key]) < 1e-4, (mode, key)
    assert int(cache_t["index"]) == 24


# --- RG-LRU -------------------------------------------------------------------


def test_block_diag_matches_jax():
    x, w, b = normal(0, 2, 5, 32), normal(1, 8, 4, 4), normal(2, 32)
    want = jr._block_diag(*map(jnp.asarray, (x, w, b)))
    got = tr._block_diag(*map(torch.from_numpy, (x, w, b)))
    assert rel_err(got, want) < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_gates_match_jax(dtype):
    """The block-diagonal products in the activations' dtype, the gates in
    float32: both outputs float32 in both dtypes."""
    cj, ct = cfgs("recurrentgemma-2b")
    pj, pt = block_params(cj, ct, jr.rglru_def(cj), tr.rglru_def(ct), 5)
    defs = jr.rglru_def(cj)
    pj = jax.tree.map(lambda d, a: a if d.dtype else a.astype(dtype), defs,
                      pj, is_leaf=lambda d: hasattr(d, "init"))
    pt = {k: v if k == "lam" else v.to(getattr(torch, dtype))
          for k, v in pt.items()}
    u_j, u_t = both(normal(6, 2, 9, ct.d_model), dtype)
    a_j, b_j = jax.jit(jr._rglru_gates)(pj, u_j)
    a_t, b_t = tr._rglru_gates(pt, u_t)
    assert a_t.dtype == b_t.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert rel_err(a_t, a_j) < tol and rel_err(b_t, b_j) < tol


@pytest.mark.parametrize("s", [1, 7, 64, 1000])
def test_rglru_scan_with_h0_matches_jax(s):
    """The log-depth scan against ``associative_scan`` (another association
    order: float32 tolerance, not bits), with an initial state."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 24)).astype(np.float32)
    b = rng.standard_normal((2, s, 24)).astype(np.float32)
    h0 = rng.standard_normal((2, 24)).astype(np.float32)
    want = jax.jit(jr.rglru_scan)(*map(jnp.asarray, (a, b, h0)))
    got = tr.rglru_scan(*map(torch.from_numpy, (a, b, h0)))
    assert rel_err(got, want) < 1e-5
    loop = torch.from_numpy(h0)
    for t in range(s):                       # the recurrence itself
        loop = torch.from_numpy(a[:, t]) * loop + torch.from_numpy(b[:, t])
    assert rel_err(got[:, -1], loop) < 1e-5
    assert rel_err(tr.rglru_scan(torch.from_numpy(a), torch.from_numpy(b)),
                   jr.rglru_scan(jnp.asarray(a), jnp.asarray(b))) < 1e-5


def test_rglru_apply_each_mode_matches_jax():
    """``rglru_apply`` train, prefill of 12 into a cache, 4 decode steps:
    outputs and every cache leaf."""
    cj, ct = cfgs("recurrentgemma-2b")
    pj, pt = block_params(cj, ct, jr.rglru_def(cj), tr.rglru_def(ct), 7)
    x = normal(8, 2, 16, ct.d_model, scale=0.5)
    y_j, _ = jax.jit(lambda p, x: jr.rglru_apply(p, cj, x))(pj, jnp.asarray(x))
    y_t, c_t = tr.rglru_apply(pt, ct, torch.from_numpy(x))
    assert c_t is None and rel_err(y_t, y_j) < 1e-4
    cache_j = jr.init_rglru_cache(cj, 2, jnp.float32)
    cache_t = tr.init_rglru_cache(ct, 2, torch.float32, CPU)
    step = jax.jit(lambda p, x, c, mode: jr.rglru_apply(p, cj, x, mode=mode,
                                                        cache=c),
                   static_argnums=3)
    for t0, t1, mode in ((0, 12, "prefill"),) + tuple(
            (t, t + 1, "decode") for t in range(12, 16)):
        y_j, cache_j = step(pj, jnp.asarray(x[:, t0:t1]), cache_j, mode)
        y_t, out = tr.rglru_apply(pt, ct, torch.from_numpy(x[:, t0:t1]),
                                  mode=mode, cache=cache_t)
        assert out is cache_t and rel_err(y_t, y_j) < 1e-4, (mode, t0)
        for key in cache_t:
            assert rel_err(cache_t[key], cache_j[key]) < 1e-4, (mode, key)
    assert int(cache_t["index"]) == 16


# --- MoE ----------------------------------------------------------------------


def moe_case(name, seed):
    cj, ct = cfgs(name)
    pj, pt = block_params(cj, ct, jmoe.moe_def(cj), tmoe.moe_def(ct), seed)
    return cj, ct, pj, pt


def separated_tokens(ct, pt, n, seed, gap=1e-3):
    """``n`` random tokens whose k-th and (k+1)-th router probabilities
    are at least ``gap`` apart (so that float32 rounding cannot swap the
    top-k set)."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        x = (rng.standard_normal((4 * n, ct.d_model)) * 0.5).astype(
            np.float32)
        with torch.no_grad():
            logits = torch.from_numpy(x) @ pt["router"]
        probs = torch.softmax(logits[:, :ct.num_experts], -1)
        top = probs.topk(ct.moe_top_k + 1, dim=-1).values
        ok = (top[:, -2] - top[:, -1]) > gap
        out.extend(x[ok.numpy()])
    return np.stack(out[:n])


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"])
def test_router_probs_matches_jax(name):
    """The same experts in the same (descending) order — ids exactly —
    the weights and the aux loss within 1e-6; no pad expert chosen."""
    cj, ct, pj, pt = moe_case(name, 9)
    x = separated_tokens(ct, pt, 48, seed=10)
    w_j, ids_j, aux_j = jax.jit(lambda p, x: jmoe.router_probs(p, cj, x))(
        pj, jnp.asarray(x))
    w_t, ids_t, aux_t = tmoe.router_probs(pt, ct, torch.from_numpy(x))
    np.testing.assert_array_equal(to_np(ids_t), np.asarray(ids_j))
    assert int(ids_t.max()) < ct.num_experts
    assert rel_err(w_t, w_j) < 1e-6 and rel_err(aux_t, aux_j) < 1e-6


@pytest.mark.parametrize("capacity", [None, 8], ids=["lossless", "drops"])
def test_moe_local_matches_jax(capacity):
    """``moe_apply`` (the reference's ``_moe_local``) at the reduced
    config's lossless capacity, and at an
    explicit capacity of 8 that drops slots (48 tokens x top-2 over 8
    experts: 12 slots an expert on average)."""
    cj, ct, pj, pt = moe_case("qwen2-moe-a2.7b", 11)
    x = separated_tokens(ct, pt, 48, seed=12).reshape(2, 24, ct.d_model)
    y_j, aux_j = jax.jit(lambda p, x: jmoe._moe_local(p, cj, x, capacity))(
        pj, jnp.asarray(x))
    y_t, aux_t = tmoe.moe_apply(pt, ct, torch.from_numpy(x), capacity)
    assert rel_err(y_t, y_j) < 1e-4 and rel_err(aux_t, aux_j) < 1e-6
    full, _ = tmoe.moe_apply(pt, ct, torch.from_numpy(x), 10_000)
    dropped = bool((full - y_t).abs().amax() > 1e-3 * full.abs().amax())
    assert dropped == (capacity is not None)
    assert torch.equal(y_t, tmoe.moe_apply(pt, ct, torch.from_numpy(x),
                                            capacity)[0])


def test_moe_capacity_matches_the_reference_formula():
    _, ct = cfgs("qwen2-moe-a2.7b")
    for t in (1, 7, 48, 1000):
        want = max(int(np.ceil(t * ct.moe_top_k / 16 * ct.moe_capacity_factor
                               / 8) * 8), 8)
        assert tmoe.moe_capacity(ct, t, 16) == want
