"""``repro_torch.launch.mesh`` against ``repro.launch.mesh``: the registry's
names, shapes and axes, ``with_sizes`` and its errors, and the validation
hints (``torchrun`` where the JAX package names ``XLA_FLAGS``).  Then a
world of one gloo rank in this process: the registry meshes build as
``DeviceMesh``es, and an engine on a mesh placement of one rank runs the
sharded code path (its collectives counted) to the host placement's bits,
which is what ``chip_smoke.py`` phase 10 does over NCCL on the card.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch import mesh as jmesh
from repro_torch import comm
from repro_torch.core import ddim_coeffs
from repro_torch.launch import mesh as tmesh
from repro_torch.sampling import (Placement, SampleRequest, SamplingEngine,
                                  get_sampler)
from tests.test_torch_helpers import label_arrays, torch_label_denoiser
from tests.test_torch_tp_dit import distribute_params


def test_registry_matches_jax():
    assert tmesh.mesh_names() == jmesh.mesh_names()
    assert tmesh.time_mesh_names() == jmesh.time_mesh_names() == [
        "debug-time", "pod-time", "single-host-time"]
    for name in tmesh.mesh_names():
        got, want = tmesh.get_mesh_spec(name), jmesh.get_mesh_spec(name)
        assert (got.shape, got.axes, got.num_devices) == \
            (want.shape, want.axes, want.num_devices), name
    with pytest.raises(KeyError, match="registered"):
        tmesh.make_mesh("nope")


@pytest.mark.parametrize("name,kw", [
    ("pod", dict(data_parallel=2, model_parallel=2)),
    ("debug-time", dict(time_parallel=4)),
    ("multi-pod", dict(model_parallel=4)),
    ("single-host", dict(data_parallel=1)),
])
def test_with_sizes_matches_jax(name, kw):
    got = tmesh.get_mesh_spec(name).with_sizes(**kw)
    want = jmesh.get_mesh_spec(name).with_sizes(**kw)
    assert (got.shape, got.num_devices) == (want.shape, want.num_devices)


@pytest.mark.parametrize("kw", [dict(model_parallel=2),
                                dict(time_parallel=2),
                                dict(data_parallel=2)])
def test_with_sizes_errors_match_jax(kw):
    got_spec = tmesh.MeshSpec("flat", (4,), ("model",))
    want_spec = jmesh.MeshSpec("flat", (4,), ("model",))
    if "model_parallel" in kw:
        got_spec = tmesh.MeshSpec("flat", (4,), ("data",))
        want_spec = jmesh.MeshSpec("flat", (4,), ("data",))
    with pytest.raises(ValueError) as got:
        got_spec.with_sizes(**kw)
    with pytest.raises(ValueError) as want:
        want_spec.with_sizes(**kw)
    assert str(got.value) == str(want.value)


def test_validation_hints_name_torchrun():
    # a world of one (no process group): every multi-rank mesh refuses,
    # naming the launcher and the axis overrides
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        tmesh.make_mesh("debug", device_type="cpu")
    with pytest.raises(ValueError, match="--time-parallel"):
        tmesh.make_mesh("debug-time", device_type="cpu")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_mesh("pod", device_type="cpu")
    with pytest.raises(ValueError, match="were given"):
        tmesh.make_mesh("debug", ranks=[0], device_type="cpu")
    with pytest.raises(ValueError, match="must increase"):
        tmesh.get_mesh_spec("debug").check(ranks=[3, 2, 1, 0])
    assert tmesh.get_mesh_spec("debug").check(ranks=range(8)) == [0, 1, 2, 3]
    # a mesh that fits still needs a process group to be built
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.make_mesh("debug", data_parallel=1, model_parallel=1,
                        device_type="cpu")


def test_backends_are_fixed_by_the_device():
    assert tmesh.backend_for("cuda") == "nccl"
    assert tmesh.backend_for(torch.device("cuda", 0)) == "nccl"
    assert tmesh.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError, match="no process-group backend"):
        tmesh.backend_for("meta")
    with pytest.raises(ValueError, match="init_method"):
        tmesh.init_distributed("cpu", world_size=2, rank=0)


@pytest.fixture
def gloo_world_of_one(tmp_path):
    tmesh.init_distributed("cpu", world_size=1, rank=0,
                           init_method=f"file://{tmp_path}/rendezvous",
                           timeout_s=60)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_world_of_one_meshes_and_sharded_engine(gloo_world_of_one):
    assert tmesh.init_distributed("cpu") == "gloo"     # already up: kept
    with pytest.raises(RuntimeError, match="needs 'nccl'"):
        tmesh.init_distributed("cuda")
    mesh = tmesh.make_mesh("debug-time", data_parallel=1, time_parallel=1,
                           model_parallel=1, device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "time", "model")
    assert tuple(mesh.mesh.shape) == (1, 1, 1)
    plc = Placement.for_mesh(mesh)
    assert plc.is_member and plc.time_axis == "time"
    assert plc.describe() == ("mesh[data=1 x time=1 x model=1] (1 devices; "
                              "requests over data, denoiser over model, "
                              "windows over time)")

    D, T = 16, 8
    eps = torch_label_denoiser(*label_arrays(D, 4))
    reqs = [SampleRequest(label=i % 4, seed=20 + i) for i in range(3)]

    def engine(placement):
        return SamplingEngine(eps, None, ddim_coeffs(T), get_sampler("taa"),
                              sample_shape=(D,), device="cpu",
                              placement=placement)

    host = engine(None).run_batch(reqs, batch_size=2)
    sharded = engine(plc)
    comm.reset()
    got = sharded.run_batch(reqs, batch_size=2)
    for a, b in zip(got, host):
        assert np.array_equal(a.trajectory, b.trajectory)
        assert (a.iters, a.nfe) == (b.iters, b.nfe)
    iters = sum(d["device_iters"] for d in sharded.last_dispatches)
    # one window all-gather (time) and one flag all-reduce (data) an
    # iteration, and the outputs' all-gathers at each dispatch's end
    assert comm.counts["all-reduce"] == iters
    assert comm.counts["all-gather"] == iters + 2 * 5


def test_world_of_one_param_and_input_placements(gloo_world_of_one):
    """``distribute_params(placement, params, defs)`` places each leaf as
    a DTensor by its logical axes (its local block is ``shard_params``'
    block); ``input_specs(mesh=)`` the inputs by ``input_partition`` (one
    rank: every block is the whole tensor)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.registry import get_arch
    from repro_torch.diffusion import dit
    from repro_torch.launch import steps
    from repro_torch.models import pdefs

    cfg = get_arch("dit-xl").reduced()
    defs = dit.dit_defs(cfg)
    params = pdefs.init_on_device(defs, 0, "cpu")
    mesh = tmesh.make_mesh("debug", data_parallel=1, model_parallel=1,
                           device_type="cpu")
    plc = Placement.for_mesh(mesh)
    placed = distribute_params(plc, params, defs)
    blocks = _leaves(plc.shard_params(params, defs).local)
    for (path, spec), leaf, block in zip(pdefs.walk(defs), _leaves(placed),
                                         blocks):
        assert isinstance(leaf, DTensor), path
        assert torch.equal(leaf.to_local(), block), path
        assert list(leaf.placements) == pdefs.dtensor_placements(
            pdefs.resolve_spec(spec, mesh), mesh), path
    for a, b in zip(_leaves(params), _leaves(placed)):
        assert torch.equal(b.full_tensor(), a)
    shape = steps.ShapeConfig("t", 64, 8, "train")
    lm = get_arch("qwen3-0.6b").reduced()
    inputs = steps.input_specs(lm, shape, mesh=mesh)
    assert steps.input_partition(lm, shape, mesh) == {
        "inputs": ("data", None), "labels": ("data", None)}
    for name, x in inputs.items():
        assert isinstance(x, DTensor) and x.shape == (8, 64), name
        assert x.device.type == "meta"


def _leaves(tree):
    from repro_torch.tree import leaves

    return leaves(tree)
