"""Port parity for the DiT denoiser, its layers and the param converter:
the JAX package's params (nonzero adaLN leaves) converted leaf for leaf,
the same inputs through both ``dit_apply``s, float32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.diffusion import dit as jdit
from repro.models import layers as jlayers
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.diffusion import convert as tconvert
from repro_torch.diffusion import dit as tdit
from repro_torch.models import layers as tlayers
from tests.test_torch_helpers import (CPU, dit_param_trees, normal, rel_err,
                                      torch_cfg)


def test_configs_match_jax():
    j, t = jget_arch("dit-xl"), tget_arch("dit-xl")
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert dataclasses.asdict(t.reduced()) == {
        k: v for k, v in dataclasses.asdict(j.reduced()).items()
        if k in dataclasses.asdict(t)}


def test_layers_match_jax():
    x = normal(0, 3, 7, 40, scale=2.0)
    assert rel_err(tlayers.layernorm_noaffine(torch.from_numpy(x)),
                   jlayers.layernorm_noaffine(jnp.asarray(x))) < 1e-6
    for act in ("gelu", "silu"):
        assert rel_err(tlayers.act_fn(act)(torch.from_numpy(x)),
                       jlayers.act_fn(act)(jnp.asarray(x))) < 1e-6
    # a 1-ulp difference between the two exps of the frequencies, times
    # t up to 999, moves the angle by ~6e-5 rad
    t = np.array([0.0, 39.0, 999.0], np.float32)
    assert rel_err(tlayers.sinusoidal_embed(torch.from_numpy(t), 256),
                   jlayers.sinusoidal_embed(jnp.asarray(t), 256)) < 1e-4
    assert np.array_equal(tlayers.sincos_positions(16, 64),
                          jlayers.sincos_positions(16, 64))
    p = {k: normal(i, *s, scale=0.2) for i, (k, s) in enumerate(
        [("wi_gate", (40, 24)), ("wi_up", (40, 24)), ("wo", (24, 40))])}
    assert rel_err(
        tlayers.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x), "gelu"),
        jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x), "gelu")) < 1e-5


# one compile instead of op-by-op dispatch of the JAX reference
_jdit_apply = jax.jit(jdit.dit_apply, static_argnums=1)


def _dit_pair(cfg_j, B, n, seed=0, ada_scale=0.05, fan_in_qk=True):
    pj, tree = dit_param_trees(cfg_j, seed=seed, ada_scale=ada_scale,
                               fan_in_qk=fan_in_qk)
    cfg_t = torch_cfg(cfg_j)
    pt = tconvert.dit_params_from_numpy(tree, cfg_t, CPU)
    lat = normal(seed + 7, B, n, cfg_j.latent_dim)
    t = np.linspace(10.0, 990.0, B).astype(np.float32)
    y = (np.arange(B) * 3) % cfg_j.num_classes
    return pj, pt, cfg_t, lat, t, y


@pytest.mark.parametrize("labels,fan_in_qk,tol", [
    (True, True, 1e-5), (False, True, 1e-5),
    # the reference initializer's saturated softmax: float32 JAX is itself
    # off its float64 value by more than 1e-5 here (see dit_param_trees)
    (True, False, 1e-3)])
def test_dit_apply_reduced_matches_jax(labels, fan_in_qk, tol):
    cfg_j = jget_arch("dit-xl").reduced()
    pj, pt, cfg_t, lat, t, y = _dit_pair(cfg_j, B=3, n=16,
                                         fan_in_qk=fan_in_qk)
    want = _jdit_apply(pj, cfg_j, jnp.asarray(lat), jnp.asarray(t),
                       jnp.asarray(y) if labels else None)
    got = tdit.dit_apply(pt, cfg_t, torch.from_numpy(lat), torch.from_numpy(t),
                         torch.from_numpy(y) if labels else None)
    assert float(np.max(np.abs(np.asarray(want)))) > 1e-2   # exercised
    assert rel_err(got, want) < tol


def test_dit_apply_full_width_single_layer_matches_jax():
    """One DiT-XL block at full width: d 1152, 16 heads x 72, d_ff 4608,
    256 tokens, batch 1."""
    cfg_j = dataclasses.replace(jget_arch("dit-xl"), num_layers=1)
    pj, pt, cfg_t, lat, t, y = _dit_pair(cfg_j, B=1, n=256, seed=3,
                                         ada_scale=0.02)
    want = _jdit_apply(pj, cfg_j, jnp.asarray(lat), jnp.asarray(t),
                       jnp.asarray(y))
    got = tdit.dit_apply(pt, cfg_t, torch.from_numpy(lat), torch.from_numpy(t),
                         torch.from_numpy(y))
    assert got.shape == (1, 256, 16)
    assert rel_err(got, want) < 1e-5


def test_converter_checks_shapes_and_bf16():
    cfg_j = jget_arch("dit-xl").reduced()
    cfg_t = torch_cfg(cfg_j)
    _, tree = dit_param_trees(cfg_j, seed=1)
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                        tree)
    pt = tconvert.dit_params_from_numpy(tree, cfg_t, CPU)
    assert pt["blocks"]["wq"].shape == (4, 128, 4, 32)
    assert pt["blocks"]["mlp"]["wo"].dtype == torch.float32
    tree["blocks"]["wo"] = tree["blocks"]["wo"][:, :, :, :-1]
    with pytest.raises(ValueError, match="blocks/wo"):
        tconvert.dit_params_from_numpy(tree, cfg_t, CPU)


def test_numpy_init_statistics_and_seed():
    cfg = tget_arch("dit-xl").reduced()
    a = tconvert.dit_init_numpy(cfg, 5)
    assert np.array_equal(a["blocks"]["wq"], tconvert.dit_init_numpy(cfg, 5)
                          ["blocks"]["wq"])
    assert not np.any(a["blocks"]["ada"]) and not np.any(a["out_proj"])
    # lecun: std 1/sqrt(fan_in) over the contracted dimensions
    assert abs(a["blocks"]["mlp"]["wi_up"].std() * np.sqrt(128) - 1) < 0.05
    assert abs(a["blocks"]["wq"].std() * np.sqrt(128) - 1) < 0.05
    assert abs(a["blocks"]["wo"].std() * np.sqrt(4 * 32) - 1) < 0.05
    b = tconvert.dit_init_numpy(cfg, 5, ada_scale=0.1)
    assert abs(b["final_ada"].std() - 0.1) < 0.01
