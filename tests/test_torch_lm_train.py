"""Port parity for the LM half of training: ``lm_loss`` and its gradients,
the train step and the prefill/decode step makers — the same
numpy-seeded inputs through the JAX package and the port, on the CPU, at
``reduced()`` size (the drivers and checkpoints:
``tests/test_torch_lm_drivers.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as JS
from repro.models import backbone as jb
from repro.optim import adamw_init as jadamw_init
from repro_torch.launch import steps as TS
from repro_torch.models import backbone as tb
from repro_torch.optim import adamw_init
from repro_torch.tree import flatten_with_paths, leaves
from tests.test_torch_backbone import (LM_ARCHS, TAIL, cfgs, inputs,
                                      param_trees)
from tests.test_torch_helpers import CPU, rel_err


def batch_of(cfg, b, s, seed):
    rng = np.random.default_rng(seed + 100)
    return {"inputs": inputs(cfg, b, s, seed),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32)}


def per_leaf_err(got, want) -> float:
    """The largest per-leaf ``rel_err`` (each leaf against its own largest
    entry) over two trees of one structure."""
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    return max(rel_err(a, b) for a, b in zip(g, w))


@pytest.mark.parametrize("name", LM_ARCHS + [TAIL])
def test_lm_loss_and_grads_match_jax(name):
    """``lm_loss`` (chunked cross entropy, remat'd trunk or period groups;
    the MoE aux term) and the gradient of every leaf against
    ``jax.value_and_grad``: 1e-4 relative."""
    cj, ct = cfgs(name)
    pj, pt = param_trees(cj, ct, seed=9)
    b = batch_of(cj, 4, 16, seed=10)
    lj, gj = jax.jit(jax.value_and_grad(jb.lm_loss), static_argnums=1)(
        pj, cj, {k: jnp.asarray(v) for k, v in b.items()})
    lt, gt = TS.make_grads_fn(ct)(pt, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
    assert lt.shape == () and lt.dtype == torch.float32
    assert rel_err(lt, lj) < 1e-5
    assert per_leaf_err(gt, gj) < 1e-4
    assert not any(p.requires_grad for p in leaves(pt))
    with torch.no_grad():     # the loss alone, no checkpointing
        assert rel_err(tb.lm_loss(pt, ct, {k: torch.from_numpy(v)
                                           for k, v in b.items()}), lj) < 1e-5


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match_jax(grad_accum):
    """Three steps of the port's train step against three of the
    reference's jitted one on qwen3 (reduced), from the same params and
    batches: losses and grad norms within 1e-5 relative, every parameter
    and master weight within 1e-5 of its leaf's largest entry."""
    cj, ct = cfgs("qwen3-0.6b")
    pj, pt = param_trees(cj, ct, seed=11)
    oj, ot = jadamw_init(pj), adamw_init(pt)
    jstep = jax.jit(JS.make_train_step(cj, grad_accum=grad_accum))
    tstep = TS.make_train_step(ct, grad_accum=grad_accum)
    for i in range(3):
        b = batch_of(cj, 4, 16, seed=20 + i)
        pj, oj, mj = jstep(pj, oj, {k: jnp.asarray(v) for k, v in b.items()},
                           jnp.asarray(i, jnp.int32))
        pt, ot, mt = tstep(pt, ot, {k: torch.from_numpy(v)
                                    for k, v in b.items()}, torch.tensor(i))
        assert rel_err(mt["loss"], mj["loss"]) < 1e-5, i
        assert rel_err(mt["grad_norm"], mj["grad_norm"]) < 1e-5, i
    for got, want in ((pt, pj), (ot["master"], oj["master"])):
        for (path, g), w in zip(flatten_with_paths(got),
                                jax.tree.leaves(want)):
            assert rel_err(g, w) < 1e-5, path


def test_prefill_and_decode_steps_match_jax():
    cj, ct = cfgs("granite-8b")
    pj, pt = param_trees(cj, ct, seed=12)
    x = inputs(cj, 2, 12, seed=13)
    cache_j = jb.init_cache(cj, 2, 12, jnp.float32)
    cache_t = tb.init_cache(ct, 2, 12, torch.float32, CPU)
    lj, cache_j = JS.make_prefill_step(cj)(pj, jnp.asarray(x[:, :11]),
                                          cache_j)
    with torch.no_grad():
        lt, cache_t = TS.make_prefill_step(ct)(pt, torch.from_numpy(
            x[:, :11]), cache_t)
        assert lt.shape == (2, 1, ct.vocab_size)       # last position only
        assert rel_err(lt, lj) < 1e-4
        dj, _ = JS.make_decode_step(cj)(pj, jnp.asarray(x[:, 11:]), cache_j)
        dt, _ = TS.make_decode_step(ct)(pt, torch.from_numpy(x[:, 11:]),
                                        cache_t)
    assert rel_err(dt, dj) < 1e-4
