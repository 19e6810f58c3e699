"""``repro_torch.optim.grad_compress`` against ``repro.optim.grad_compress``
in-process: the same gradient trees (numpy, from a seed) through int8
block quantization, top-k and none, two steps of error feedback, and the
wire-byte accounting."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import grad_compress as jgc
from repro_torch.optim import grad_compress as tgc
from tests.test_torch_helpers import normal, to_np


def _trees(seed):
    arrays = {"w": normal(seed, 3, 130), "b": normal(seed + 1, 7),
              "blocks": [normal(seed + 2, 2, 64, 5, scale=1e-3)]}
    jtree = jax.tree.map(jnp.asarray, arrays)
    ttree = {"w": torch.from_numpy(arrays["w"]),
             "b": torch.from_numpy(arrays["b"]),
             "blocks": [torch.from_numpy(arrays["blocks"][0])]}
    return jtree, ttree


def _pairs(jtree, ttree):
    return list(zip(jax.tree.leaves(jtree),
                    [ttree["b"], ttree["blocks"][0], ttree["w"]]))


@pytest.mark.parametrize("kind", ["int8", "topk", "none"])
def test_compress_with_feedback_matches_jax(kind):
    cfg_j = jgc.CompressConfig(kind=kind, topk_frac=0.1)
    cfg_t = tgc.CompressConfig(kind=kind, topk_frac=0.1)
    err_j = err_t = None
    for step in range(2):
        gj, gt = _trees(10 * step)
        deq_j, err_j = jgc.compress_with_feedback(gj, err_j, cfg_j)
        deq_t, err_t = tgc.compress_with_feedback(gt, err_t, cfg_t)
        for a, b in _pairs(deq_j, deq_t):
            np.testing.assert_allclose(to_np(b), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)
        if kind != "none":
            for a, b in _pairs(err_j, err_t):
                np.testing.assert_allclose(to_np(b), np.asarray(a),
                                           rtol=1e-6, atol=1e-7)
    assert tgc.wire_bytes(gt, cfg_t) == jgc.wire_bytes(gj, cfg_j)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compress_leaf_matches_jax_and_feeds_back_its_error(kind):
    g = normal(3, 5, 257)
    dj, ej = jgc.compress_leaf(jnp.asarray(g), None,
                               jgc.CompressConfig(kind=kind))
    dt, et = tgc.compress_leaf(torch.from_numpy(g), None,
                               tgc.CompressConfig(kind=kind))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6,
                               atol=1e-7)
    assert torch.equal(dt + et, torch.from_numpy(g))
    if kind == "topk":
        assert int((dt != 0).sum()) == int(g.size * 0.05)
