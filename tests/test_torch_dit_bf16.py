"""DiT parity in bf16: the reduced DiT's ``dit_apply`` with bf16 params
and latents through the JAX package (its dry-run's and steps'
``PARAM_DTYPE``) and the port, on the CPU.  bf16 rounds at other places
in the two frameworks, so the port is held as
``tests/test_torch_backbone.py::test_forward_bf16_is_as_close_to_float32_as_jax``
holds the backbones: no further from float32 than the reference's own
bf16 is, x 1.5, and within that distance of the reference's bf16.
Measured (labelled case, of the output's scale): the reference's bf16
0.0106 from its float32, the port's 0.0092 from its own, the two bf16
outputs 0.0102 apart; float32 against float32 2.7e-6.  So ``dit_apply``
needed no change for bf16."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.diffusion import dit as jdit
from repro_torch.diffusion import convert as tconvert
from repro_torch.diffusion import dit as tdit
from tests.test_torch_helpers import (CPU, dit_param_trees, normal, rel_err,
                                      torch_cfg)

_jdit_apply = jax.jit(jdit.dit_apply, static_argnums=1)


@pytest.mark.parametrize("labels", [True, False])
def test_dit_apply_bf16_is_as_close_to_float32_as_jax(labels):
    cfg_j = jget_arch("dit-xl").reduced()
    cfg_t = torch_cfg(cfg_j)
    _, tree = dit_param_trees(cfg_j, seed=4, ada_scale=0.05)
    B, n = 3, 16
    lat = normal(11, B, n, cfg_j.latent_dim)
    t = np.linspace(10.0, 990.0, B).astype(np.float32)
    y = (np.arange(B) * 3) % cfg_j.num_classes
    out = {}
    for name, jdt, tdt in (("float32", jnp.float32, torch.float32),
                           ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        pj = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), tree)
        pt = tconvert.dit_params_from_numpy(tree, cfg_t, CPU, tdt)
        want = _jdit_apply(pj, cfg_j, jnp.asarray(lat).astype(jdt),
                           jnp.asarray(t), jnp.asarray(y) if labels else None)
        with torch.no_grad():
            got = tdit.dit_apply(pt, cfg_t, torch.from_numpy(lat).to(tdt),
                                 torch.from_numpy(t),
                                 torch.from_numpy(y) if labels else None)
        assert got.dtype == tdt and want.dtype == jdt
        out[name] = got, want
    (t32, j32), (t16, j16) = out["float32"], out["bfloat16"]
    assert rel_err(t32, j32) < 1e-5
    jax_err = rel_err(j16, j32)
    assert 0 < jax_err < 5e-2                        # bf16 was exercised
    assert rel_err(t16, t32) < 1.5 * jax_err
    assert rel_err(t16, j16) < 1.5 * jax_err
