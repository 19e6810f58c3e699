"""bf16 prefill-then-decode parity for mamba2, the RG-LRU hybrid and MoE
at reduced size: prefill 20 tokens, decode 8, in bf16 trees (the float32
leaves kept) with a bf16 cache, in both packages.  bf16 rounding
compounds over depth (mamba2's gated SSD output), or flips top-k choices
(MoE), so neither package's bf16 decode meets 2e-2 of another's.  Held
as ``tests/test_torch_backbone.py::test_forward_bf16_is_as_close_to_float32_as_jax``
holds ``forward``: the port's bf16 decode logits are no further from the
float32 logits (the reference's float32 ``forward`` over the same
tokens) than the reference's bf16 decode is, x 1.5, and within that
distance of the reference's bf16 decode.  Measured (of the logits'
scale, reference bf16 / port bf16 from float32, port from reference):
mamba2 0.042 / 0.041, 0.026; recurrentgemma 0.010 / 0.0085, 0.0096;
qwen2-moe 0.160 / 0.187, 0.177.  The port's bf16 decode equals its own
bf16 ``forward`` over the same tokens exactly here."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import backbone as jb
from repro_torch.models import backbone as tb
from tests.test_torch_backbone import _decode_run, cfgs, inputs, param_trees
from tests.test_torch_helpers import CPU, rel_err


@pytest.mark.parametrize("name", ["mamba2-1.3b", "recurrentgemma-2b",
                                  "qwen2-moe-a2.7b"])
def test_decode_bf16_is_as_close_to_float32_as_jax(name):
    cj, ct = cfgs(name)
    b, s, p0 = 2, 28, 20
    x = inputs(cj, b, s, seed=2)
    pj32, _ = param_trees(cj, ct)
    ref = np.asarray(jb.forward(pj32, cj, jnp.asarray(x))[0])[:, p0:]
    pj, pt = param_trees(cj, ct, dtype="bfloat16")
    _, dec_j, _ = _decode_run("jax", pj, cj, x, p0,
                              jb.init_cache(cj, b, s, jnp.bfloat16))
    _, dec_t, cache = _decode_run("torch", pt, ct, x, p0,
                                  tb.init_cache(ct, b, s, torch.bfloat16,
                                                CPU))
    assert int(tb.cache_index(ct, cache)) == s
    assert np.all(np.isfinite(dec_t))
    jax_err = rel_err(dec_j, ref)
    assert jax_err > 0                              # bf16 was exercised
    assert rel_err(dec_t, ref) < 1.5 * jax_err
    assert rel_err(dec_t, dec_j) < 1.5 * jax_err
