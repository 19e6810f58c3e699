"""Port parity for the LM train driver's token path and LM checkpoints
crossing between the packages both ways — the JAX package's own init,
converted, and the same token batches through both drivers, on the CPU,
at ``reduced()`` size (split from ``tests/test_torch_lm_train.py`` to
spread the test run's files over its workers)."""
import jax
import numpy as np
import pytest
import torch

from repro.launch.train import main as jtrain_main
from repro.models import backbone as jb
from repro_torch.launch import train as ttrain
from repro_torch.models import pdefs as tpdefs
from repro_torch.models.convert import backbone_params_from_numpy
from repro_torch.optim import adamw_init
from repro_torch.tree import flatten_with_paths
from tests.test_torch_backbone import TAIL, cfgs, param_trees
from tests.test_torch_helpers import CPU


def _argv(name, steps, *extra):
    return ["--arch", name, "--smoke", "--steps", str(steps), "--batch", "4",
            "--seq", "16", "--log-every", "100", *extra]


def _jax_init_params(name):
    """The JAX driver's init (``backbone.init``, PRNGKey 0; its per-leaf
    keys hash the leaf paths, stable within this process), converted."""
    cj, ct = cfgs(name)
    tree = jax.tree.map(np.asarray, jax.jit(jb.init, static_argnums=0)(
        cj, jax.random.PRNGKey(0)))
    return ct, backbone_params_from_numpy(tree, ct, CPU)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "musicgen-medium",
                                  "qwen2-moe-a2.7b"])
def test_port_driver_trains_what_the_jax_driver_trains(name):
    """The JAX package's ``train.main`` and the port's driver loop from the
    same init on the same token batches (random frame embeddings for
    musicgen's ``frontend="embed"``): the same losses within 1e-5."""
    want = jtrain_main(_argv(name, 3))
    ct, params = _jax_init_params(name)
    args = ttrain.parse_args(_argv(name, 3, "--device", "cpu"))
    got = ttrain.train(args, ct, params, adamw_init(params))
    assert got.start_step == 0 and len(got.losses) == 3
    np.testing.assert_allclose(got.losses, want, rtol=1e-5)


def test_lm_checkpoints_cross_both_ways(tmp_path):
    """qwen3 (reduced) trained two steps by either package's driver with
    ``--ckpt-dir`` resumes in the other's driver at step 2, and its steps
    2-3 give the losses of an uninterrupted four-step run (1e-5)."""
    name = "qwen3-0.6b"
    whole_j = jtrain_main(_argv(name, 4))
    jtrain_main(_argv(name, 2, "--ckpt-dir", str(tmp_path / "j")))
    resumed = ttrain.run(_argv(name, 4, "--ckpt-dir", str(tmp_path / "j"),
                               "--device", "cpu"))
    assert resumed.start_step == 2 and len(resumed.losses) == 2
    np.testing.assert_allclose(resumed.losses, whole_j[2:], rtol=1e-5)

    whole_t = ttrain.main(_argv(name, 4, "--device", "cpu"))
    ttrain.main(_argv(name, 2, "--ckpt-dir", str(tmp_path / "t"),
                      "--device", "cpu"))
    resumed_j = jtrain_main(_argv(name, 4, "--ckpt-dir",
                                  str(tmp_path / "t")))
    assert len(resumed_j) == 2
    np.testing.assert_allclose(resumed_j, whole_t[2:], rtol=1e-5)


@pytest.mark.parametrize("name", ["mamba2-1.3b", TAIL])
def test_bf16_params_checkpoints_cross_both_ways(name, tmp_path):
    """bf16 params (the float32 leaves kept) of mamba2 and of the hybrid
    with a tail, saved by either package and restored by the other into
    its own bf16 template: every leaf equal, of its dtype, under the
    reference's names (the tail's as ``params/tail/0/...``)."""
    import json

    from repro.ckpt import checkpoint as jckpt
    from repro_torch.ckpt import checkpoint as tckpt

    cj, ct = cfgs(name)
    pj, pt = param_trees(cj, ct, seed=14, dtype="bfloat16")
    tckpt.save_pytree({"step": 3, "params": pt}, tmp_path / "t")
    names = [leaf["name"] for leaf in json.loads(
        (tmp_path / "t" / "manifest.json").read_text())["leaves"]]
    assert names == jckpt._flatten_with_names({"step": 3, "params": pj})[0]
    if ct.is_hybrid:
        assert "params/tail/0/rec/lam" in names
    back_j = jckpt.load_pytree({"step": 0, "params": pj}, tmp_path / "t")
    jckpt.save_pytree({"step": 3, "params": pj}, tmp_path / "j")
    back_t = tckpt.load_pytree({"step": 0, "params": pt}, tmp_path / "j")
    assert int(back_j["step"]) == int(back_t["step"]) == 3
    for (path, a), b, c in zip(flatten_with_paths(pt),
                               jax.tree.leaves(pj),
                               jax.tree.leaves(back_j["params"])):
        assert c.dtype == b.dtype and np.array_equal(
            np.asarray(c, np.float32), np.asarray(b, np.float32)), path
        got = tpdefs.get_path(back_t["params"], path)
        assert got.dtype == a.dtype and torch.equal(got, a), path
