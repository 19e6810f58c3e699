"""The port's expert-parallel MoE (``models.moe.expert_parallel``, the
branch ``moe_apply`` takes under a mesh with a ``model`` axis: the rank's
blocks through the LM backbones' tensor-parallel layer) on 2 gloo ranks,
against its local path and against the JAX package's shard_map branch on
the same weights and tokens (``tests/test_moe_shardmap.py``'s recipe,
reduced qwen2-moe-a2.7b at d_model 64 and a drop-free capacity factor 8;
the JAX side in a subprocess with 2 forced host devices, its mesh built
through ``devices=``, whose axes are Auto)."""
import dataclasses

import jax
import numpy as np

from repro.configs.registry import ARCHS
from repro.models import pdefs
from repro.models.moe import moe_def
from tests.test_torch_placement import _run_reference, _wait
from tests.test_torch_spawn import spawn

REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import ARCHS
from repro.launch.mesh import make_mesh
from repro.models.moe import moe_apply
from repro.models.shardctx import use_mesh

inputs = dict(np.load(sys.argv[1]))
cfg = dataclasses.replace(ARCHS["qwen2-moe-a2.7b"].reduced(),
                          moe_capacity_factor=8.0, d_model=64)
params = {}
for name, arr in inputs.items():
    if name.startswith("p/"):
        *path, leaf = name[2:].split("/")
        node = params
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
mesh = make_mesh("debug", data_parallel=1, model_parallel=2,
                 devices=jax.devices())
with use_mesh(mesh):
    y, _ = jax.jit(lambda p, x: moe_apply(p, cfg, x))(
        params, jnp.asarray(inputs["x"]))
np.savez(sys.argv[2], y=np.asarray(y))
"""


def test_expert_parallel_moe_on_two_gloo_ranks_matches_jax(tmp_path):
    cfg = dataclasses.replace(ARCHS["qwen2-moe-a2.7b"].reduced(),
                              moe_capacity_factor=8.0, d_model=64)
    params = pdefs.init_params(moe_def(cfg), jax.random.PRNGKey(0))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 16, 64))
                   * 0.5)
    flat = {"p/" + "/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(tmp_path / "inputs.npz", x=x, **flat)
    ref = _run_reference(REF, tmp_path / "inputs.npz", tmp_path / "ref.npz")
    outs = spawn("moe", 2, tmp_path, timeout=120)
    for out in outs:
        # one all-reduce of the experts' and the shared MLP's partials over
        # model; the aux loss moves only over data axes of more than one
        # rank
        assert out["counts"]["all-reduce"] == 1, out
        assert out["local_err"] < 1e-5, out
        assert out["aux_equal"], out
    _wait(ref)
    port = np.load(tmp_path / "port.npz")
    want = np.load(tmp_path / "ref.npz")["y"]
    assert np.max(np.abs(port["y_ep"] - want)) < 1e-4
