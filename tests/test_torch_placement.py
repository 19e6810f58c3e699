"""``repro_torch.sampling.Placement`` and the sharded solve, against the JAX
package's.

In-process: the host placement's identity, the validation errors, and the
geometry (``round_batch``, ``axis_utilization``, ``window_spec``'s entries,
``describe``) against ``repro.sampling.Placement`` on stand-in meshes of
the same axes and sizes (geometry needs no process group).

On 4 gloo ranks (data 2 x time 2 x model 1, ``tests/test_torch_spawn.py``):
the port's sharded ``sample``, ``sample_recording``, ``run_batch`` and
stepwise drain with a mid-solve refill equal its host placement bit for
bit, with iters/nfe/converged equal — taa and aa+ in float32 and taa in
bfloat16, on the JAX package's label oracle (D=16, T=12).  The JAX
package's own sharded run of the same inputs (a subprocess: 4 forced host
devices, the mesh built through ``make_mesh(..., devices=jax.devices())``,
whose axes are Auto) matches them within the suite's 1e-4 relative in
float32 (2e-2 in bfloat16, the kernels' bf16 tolerance), iters/nfe equal.

Last, ``serve.py`` under ``torch.distributed.run`` with ``--mesh debug``
on 2 ranks prints the same per-request iters/nfe as without a mesh.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import ddim_coeffs as jddim
from repro.diffusion.samplers import draw_noises as jdraw
from repro.sampling import Placement as JPlacement
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve
from repro_torch.sampling import Placement
from tests.test_torch_helpers import label_arrays, rel_err
from tests.test_torch_spawn import REPO, spawn

D, T = 16, 12
CASES = ("taa/float32", "aa+/float32", "taa/bfloat16")


class GridMesh:
    """A mesh stand-in with the attributes both packages' ``Placement``
    read for geometry: the JAX ``axis_names``/``devices`` and the
    ``DeviceMesh`` ``mesh_dim_names``/``mesh``/coordinates."""

    def __init__(self, shape, axes):
        self.axis_names = self.mesh_dim_names = tuple(axes)
        self.devices = np.empty(shape, dtype=object)
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)

    def get_coordinate(self):
        return [0] * len(self.axis_names)

    def get_local_rank(self, axis):
        return 0


@pytest.fixture
def no_groups(monkeypatch):
    """Placement makes its process groups at construction; geometry
    checks run without a process group."""
    monkeypatch.setattr(tmesh, "axes_group", lambda mesh, axes: None)


GEOMETRIES = [((2, 2), ("data", "model")), ((4, 2), ("data", "model")),
              ((2, 16, 16), ("pod", "data", "model")),
              ((2, 2, 2), ("data", "time", "model")),
              ((2, 3, 1), ("data", "time", "model")),
              ((8, 2, 16), ("data", "time", "model"))]


@pytest.mark.parametrize("shape,axes", GEOMETRIES,
                         ids=lambda v: "x".join(map(str, v)))
def test_geometry_matches_jax(shape, axes, no_groups):
    mesh = GridMesh(shape, axes)
    got, want = Placement.for_mesh(mesh), JPlacement.for_mesh(mesh)
    for attr in ("data_axes", "data_shards", "model_shards", "time_shards",
                 "num_devices", "is_sharded"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.describe() == want.describe()
    for n in range(1, 11):
        assert got.round_batch(n) == want.round_batch(n)
        for window in (1, 4, 12, 13):
            assert got.axis_utilization(n, got.round_batch(n), window) == \
                want.axis_utilization(n, want.round_batch(n), window)
    for arr in ((4, 12, D), (4, 13, D), (4, T + 1), (8,)):
        assert got.window_spec(arr, dim=1) == \
            tuple(want.window_spec(arr, dim=1))
    assert got.batch_spec(3) == tuple(want.batch_spec(3))


def test_host_placement_is_the_identity():
    plc, ref = Placement.host(), JPlacement.host()
    assert not plc.is_sharded and plc.is_member
    assert (plc.data_shards, plc.model_shards, plc.time_shards,
            plc.num_devices) == (1, 1, 1, 1)
    assert plc.describe() == ref.describe()
    a = torch.arange(6.0).reshape(3, 2)
    assert plc.place_batch(a)[0] is a and plc.place_window(a)[0] is a
    assert plc.gather_lanes(a) is a
    params = {"w": torch.ones(2)}
    assert plc.shard_params(params) is params
    assert plc.lanes(5) == (0, 5) and plc.window_rows(12) == (0, 12)
    with plc.activations() as m:
        assert m is None
    for n in range(1, 6):
        assert plc.round_batch(n) == ref.round_batch(n)


def test_placement_validation_errors_match_jax(no_groups):
    mesh = GridMesh((2, 2), ("data", "model"))
    tmesh3 = GridMesh((2, 2, 2), ("data", "time", "model"))
    cases = [dict(mesh=mesh, data_axis="pod"),
             dict(mesh=mesh, data_axis=("pod", "data")),
             dict(mesh=mesh, model_axis="tp"),
             dict(mesh=mesh, time_axis="time"),
             dict(mesh=tmesh3, time_axis="data"),
             dict(mesh=tmesh3, time_axis="model")]
    for kw in cases:
        with pytest.raises(ValueError) as got:
            Placement(**kw)
        with pytest.raises(ValueError) as want:
            JPlacement(**kw)
        assert str(got.value) == str(want.value), kw


def test_lane_and_row_plans_cover_the_batch(no_groups):
    plc = Placement.for_mesh(GridMesh((2, 2, 1), ("data", "time", "model")))
    assert plc.lanes(4) == (0, 2) and plc.window_rows(12) == (0, 6)
    assert plc.window_rows(13) == (0, 13)      # non-divisible: every row
    with pytest.raises(ValueError, match="do not divide"):
        plc.lanes(3)
    a = torch.arange(4 * 12).reshape(4, 12)
    assert torch.equal(plc.place_batch(a)[0], a[:2])
    assert torch.equal(plc.place_window(a)[0], a[:2, :6])


@pytest.mark.parametrize("shape,axes", GEOMETRIES,
                         ids=lambda v: "x".join(map(str, v)))
def test_activation_rules_match_jax(shape, axes):
    """shardctx's logical-axis rules (``ACT_RULES``/``_resolve`` with the
    reference's divisibility fallbacks), with and without the serving
    context's "batch" override; ``constrain`` keeps every value."""
    from repro.models import shardctx as jctx
    from repro_torch.models import shardctx as tctx

    mesh = GridMesh(shape, axes)
    assert tctx.ACT_RULES == jctx.ACT_RULES
    for override in (None, (), ("data",), ("pod", "data")):
        for logical in ("batch", "seq", "heads", "embed", "window", None):
            for dim in (1, 2, 3, 8, 12, 16, 48):
                def both():
                    return (tctx._resolve(logical, dim, mesh),
                            jctx._resolve(logical, dim, mesh))
                if override is None:
                    got, want = both()
                else:
                    with tctx.batch_axes(override), jctx.batch_axes(
                            override):
                        got, want = both()
                assert got == want, (override, logical, dim)
    x = torch.ones(4, 12, 3)
    with tctx.use_mesh(mesh):
        assert tctx.constrain(x, "batch", "seq", None) is x
        assert tctx.resolve_spec(x.shape, "batch", "seq", None) == tuple(
            jctx._resolve(a, d, mesh) for a, d in
            zip(("batch", "seq", None), x.shape))


def test_window_shard_and_gather_fallbacks(no_groups):
    """No mesh, a None axis, an axis the mesh lacks, or rows the axis
    size does not divide: the window is kept whole and nothing is
    gathered (the reference's ``window_constrain`` no-ops)."""
    from repro_torch.models import shardctx

    x = torch.arange(2 * 12 * 3.0).reshape(2, 12, 3)
    assert shardctx.window_shard(x, "time", 1) is x        # no mesh
    assert shardctx.window_gather(x, "time", 1, 12) is x
    with shardctx.use_mesh(GridMesh((2, 2, 1), ("data", "time", "model"))):
        assert shardctx.window_shard(x, None, 1) is x
        assert shardctx.window_shard(x, "pod", 1) is x
        assert shardctx.window_shard(x[:, :11], "time", 1).shape[1] == 11
        assert shardctx.window_gather(x[:, :11], "time", 1, 11).shape[1] \
            == 11
        assert torch.equal(shardctx.window_shard(x, "time", 1), x[:, :6])


# --- the sharded solve on 4 gloo ranks ----------------------------------------

REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, "tests")
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from helpers import make_label_denoiser
from repro.core import ddim_coeffs
from repro.core import parataa as pt
from repro.diffusion.samplers import draw_noises
from repro.launch.mesh import make_mesh
from repro.models import shardctx
from repro.sampling import Placement, SampleRequest, SamplingEngine, get_sampler

D, T = 16, 12
out_path, cases = sys.argv[1], sys.argv[2].split(",")
eps_apply = make_label_denoiser(dim=D, n_labels=4)
coeffs = ddim_coeffs(T)
# jax.make_mesh gives Explicit axes, which with_sharding_constraint
# refuses; the devices= path builds a plain Mesh (Auto axes)
mesh = make_mesh("debug-time", data_parallel=2, time_parallel=2,
                 model_parallel=1, devices=jax.devices())
plc = Placement.for_mesh(mesh)
xi = draw_noises(jax.random.PRNGKey(7), coeffs, (D,))
reqs = [SampleRequest(label=i % 4, seed=50 + i) for i in range(4)]

def eps_fn(xw, taus):
    return eps_apply(None, xw, taus, jnp.full((xw.shape[0],), 2, jnp.int32))

def drain(eng):
    bank = eng.stepwise_open(2, chunk_iters=2)
    rq = [SampleRequest(label=0, seed=11, quality_steps=1),
          SampleRequest(label=1, seed=12), SampleRequest(label=2, seed=13)]
    eng.stepwise_refill(bank, [0, 1], rq[:2])
    queued, got = [rq[2]], {}
    while any(r is not None for r in bank.requests) or queued:
        eng.stepwise_step(bank)
        for lane, res in eng.stepwise_harvest(bank):
            got[res.request.seed] = res
            if queued:
                eng.stepwise_refill(bank, [lane], [queued.pop()])
    return got

arrays = {}
for name in cases:
    mode, dt = name.split("/")
    dtype = getattr(jnp, dt)
    spec = get_sampler(mode)
    cfg_t = dataclasses.replace(spec.solver_config(T), time_axis="time")
    with shardctx.serving_mesh(mesh):
        traj, info = jax.jit(
            lambda x: pt.sample(eps_fn, coeffs, cfg_t, x, dtype=dtype))(xi)
    arrays[f"{name}/sample"] = np.asarray(traj, np.float32)
    arrays[f"{name}/sample_info"] = np.asarray([int(info["iters"]),
                                                int(info["nfe"])])
    eng = SamplingEngine(eps_apply, None, coeffs, spec, sample_shape=(D,),
                         dtype=dtype, placement=plc)
    res = eng.run_batch(reqs, batch_size=4)
    arrays[f"{name}/run_batch"] = np.stack(
        [np.asarray(r.trajectory, np.float32) for r in res])
    arrays[f"{name}/run_batch_info"] = np.asarray([[r.iters, r.nfe]
                                                   for r in res])
    for k, r in sorted(drain(eng).items()):
        arrays[f"{name}/stepwise/{k}"] = np.asarray(r.trajectory,
                                                    np.float32)
        arrays[f"{name}/stepwise_info/{k}"] = np.asarray([r.iters, r.nfe])
np.savez(out_path, **arrays)
"""


def _write_inputs(path, seeds, *, steps=T, **extra):
    """The JAX package's oracle weights and noise draws (T = ``steps``),
    for ranks that import no jax."""
    xstars, W = label_arrays(D, 4)
    coeffs = jddim(steps)
    arrays = {f"noise_T{steps}_seed{s}": np.asarray(
        jdraw(jax.random.PRNGKey(s), coeffs, (D,))) for s in seeds}
    np.savez(path, T=steps, D=D, xstars=xstars, W=W, **arrays, **extra)


def _run_reference(script: str, *args) -> subprocess.Popen:
    env = {k: os.environ[k] for k in ("PATH", "HOME") if k in os.environ}
    env.update(PYTHONPATH="src", JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", script, *map(str, args)],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(proc: subprocess.Popen, timeout: float = 300.0):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-3000:]
    return out


def test_sharded_solve_equals_host_and_matches_jax_sharded(tmp_path):
    """Data x time sharding on 4 gloo ranks: bit for bit the host
    placement (every entry point, every case); against the JAX package's
    sharded run, 1e-4 relative in float32 (2e-2 in bfloat16) with
    iters/nfe equal."""
    ref_path = tmp_path / "ref.npz"
    ref_proc = _run_reference(REF_SCRIPT, ref_path, ",".join(CASES))
    xi = np.asarray(jdraw(jax.random.PRNGKey(7), jddim(T), (D,)))
    _write_inputs(tmp_path / "inputs.npz",
                  [50, 51, 52, 53, 11, 12, 13], xi=xi,
                  cases=np.asarray(CASES))
    outs = spawn("placement", 4, tmp_path)
    for rank, out in enumerate(outs):
        assert out["describe"].startswith(
            "mesh[data=2 x time=2 x model=1] (4 devices"), out
        for name, rec in out["cases"].items():
            for entry in ("sample", "sample_recording", "run_batch",
                          "stepwise"):
                assert rec[entry] is True, (rank, name, entry, rec)
            assert rec["stepwise_traces"] == 5, (rank, name)
            assert rec["report"]["devices"] == 4
            assert (rec["report"]["data_shards"],
                    rec["report"]["time_shards"],
                    rec["report"]["model_shards"]) == (2, 2, 1)
            assert rec["report"]["axis_utilization"] == {"data": 1.0,
                                                         "time": 1.0}
            # the per-iteration poll and the fetch: as many as the host's
            assert rec["report"]["blocking_polls"] == rec["host_polls"]
            assert rec["polls"][0] == rec["polls"][1]
    _wait(ref_proc)
    port, ref = np.load(tmp_path / "port.npz"), np.load(ref_path)
    assert sorted(port.files) == sorted(ref.files)
    for key in port.files:
        tol = 2e-2 if "bfloat16" in key else 1e-4
        if key.endswith("info") or "_info/" in key:
            assert np.array_equal(port[key], ref[key]), key
        else:
            assert rel_err(port[key], ref[key]) < tol, key


def test_serve_under_torchrun_prints_the_host_iters(tmp_path):
    """``serve.py --mesh debug`` on 2 gloo ranks prints the per-request
    iters/nfe of the run without a mesh (rank 0 prints, once)."""
    argv = ["--device", "cpu", "--smoke", "--requests", "4", "--steps-T",
            "8", "--batch-size", "2"]
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", *argv,
         "--mesh", "debug", "--data-parallel", "2", "--model-parallel", "1"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    _, stats = serve.main(argv)
    out = _wait(proc, timeout=240)
    lines = re.findall(r"label=\s*(\d+) iters=\s*(\d+) nfe=\s*(\d+)", out)
    want = [(str(s["label"]), str(s["iters"]), str(s["nfe"]))
            for s in stats]
    assert lines == want, out[-2000:]
    assert out.count("placement: mesh[data=2 x model=1]") == 1, out
    assert "[data=2 x model=1 x time=1]" in out
