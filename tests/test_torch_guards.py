"""Guards of the PyTorch port: it imports neither jax nor the JAX package,
its entry points never fall back to the CPU unasked, and CPU tensors never
reach (or count as) a kernel launch."""
import ast
import os
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.coeffs import ddim_coeffs
from repro_torch.diffusion.convert import dit_init
from repro_torch.kernels import build
from repro_torch.kernels import (flash_attention, flash_decode, ops,
                                  rglru_scan, ssd_scan, taa_update)
from repro_torch.launch import serve
from repro_torch.sampling import SamplingEngine, get_sampler
from tests.test_torch_helpers import normal

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"] + [
        REPO / "examples" / f"torch_{name}.py"
        for name in ("backbone_denoiser", "train_and_serve",
                     "trajectory_variation", "quickstart")]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_reference_package(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro", "flax"), (path, name)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_unless_cpu_asked(no_cuda):
    cfg = get_arch("dit-xl").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--requests", "1", "--steps-T", "4"])
    with pytest.raises(RuntimeError, match="CUDA"):
        dit_init(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        SamplingEngine(lambda *a: None, None, ddim_coeffs(4),
                       get_sampler("taa"), sample_shape=(2,))
    eng = SamplingEngine(lambda *a: None, None, ddim_coeffs(4),
                         get_sampler("taa"), sample_shape=(2,), device="cpu")
    assert eng.device.type == "cpu"


def test_distributed_never_falls_back_to_gloo_or_the_host_path(
        no_cuda, monkeypatch, tmp_path):
    """``init_distributed("cuda")`` without CUDA raises and leaves no
    process group (no retry on gloo); a CPU group is gloo only when asked
    for; and an engine on a mesh placement runs the sharded path — its
    collectives counted — even on a mesh of one rank."""
    import torch.distributed as dist

    from repro_torch import comm
    from repro_torch.launch import mesh
    from repro_torch.sampling import Placement, SampleRequest

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(backend))
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.init_distributed("cuda", world_size=1, rank=0,
                              init_method=f"file://{tmp_path}/a")
    assert calls == [] and not dist.is_initialized()
    assert mesh.backend_for("cuda") == "nccl"
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--mesh", "debug", "--data-parallel", "1",
                    "--model-parallel", "1"])
    assert calls == []
    monkeypatch.undo()

    mesh.init_distributed("cpu", world_size=1, rank=0,
                          init_method=f"file://{tmp_path}/b")
    try:
        assert dist.get_backend() == "gloo"
        plc = Placement.for_mesh(mesh.make_mesh(
            "debug", data_parallel=1, model_parallel=1, device_type="cpu"))
        assert plc.is_sharded and plc.data_group is not None
        eng = SamplingEngine(lambda p, x, t, y: x * 0.1, None,
                             ddim_coeffs(4), get_sampler("taa"),
                             sample_shape=(2,), device="cpu",
                             placement=plc)
        comm.reset()
        eng.run_batch([SampleRequest(label=0, seed=1)])
        assert comm.counts["all-gather"] > 0
        assert comm.counts["all-reduce"] > 0
        # param_defs on a mesh: each rank keeps its blocks (the
        # tensor-parallel path), never the host's whole tree
        from repro_torch.models.pdefs import ParamSpec
        from repro_torch.models.shardctx import ShardedParams

        eng = SamplingEngine(lambda *a: None, {"w": torch.ones(2)},
                             ddim_coeffs(4), get_sampler("taa"),
                             sample_shape=(2,), device="cpu", placement=plc,
                             param_defs={"w": ParamSpec((2,), "ones",
                                                        axes=("mlp",))})
        assert isinstance(eng.params, ShardedParams)
        assert eng.denoiser_sharded and eng.params.sharded("w")
    finally:
        dist.destroy_process_group()


def test_lm_train_driver_raises_without_cuda_unless_cpu_asked(no_cuda):
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "qwen3-0.6b", "--steps", "1"])
    assert len(train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1",
                           "--batch", "2", "--seq", "8",
                           "--device", "cpu"])) == 1


def test_ops_on_cpu_tensors_launch_nothing():
    taa_update.reset_launches()
    B, m, T, D = 2, 3, 6, 40
    x, R = (torch.from_numpy(normal(s, B, T, D)) for s in (0, 1))
    dX, dF = (torch.from_numpy(normal(s, B, m, T, D, scale=0.1))
              for s in (2, 3))
    mask = (torch.arange(T) >= 1).float().expand(B, T)
    guard = torch.arange(T).expand(B, T) >= T - 1
    ops.taa_gram(dF, R, mask)
    gamma = ops.taa_rowwise_gamma(dF, R, mask, lam=1e-6)
    ops.taa_apply(x, R, dX, dF, gamma, mask)
    for mode in ("taa", "aa", "aa+"):
        ops.taa_round(x, R, dX, dF, mask, mode=mode, lam=1e-6,
                      safeguard_mask=guard)
    assert taa_update.launches == {"taa_gram": 0, "taa_apply": 0,
                                   "taa_round": 0}
    assert taa_update._lib.cache_info().currsize == 0   # nothing built


@pytest.mark.parametrize("lanes", [(2,), ()])
def test_kernel_wrappers_validate_shapes_then_refuse_cpu_tensors(lanes):
    """Well-shaped inputs, with the lane axis or in the JAX package's
    unbatched shapes, pass every shape check and stop at the device check
    (before anything is built); ill-shaped ones stop at the shape check."""
    m, T, D = 3, 4, 8
    dF, dX = torch.zeros(*lanes, m, T, D), torch.ones(*lanes, m, T, D)
    R, x = torch.zeros(*lanes, T, D), torch.zeros(*lanes, T, D)
    mask, gamma = torch.ones(*lanes, T), torch.zeros(*lanes, T, m)
    cuda = "one CUDA device"
    with pytest.raises(ValueError, match=cuda):
        taa_update.taa_gram(dF, R, mask)
    with pytest.raises(ValueError, match=cuda):
        taa_update.taa_apply(x, R, dX, dF, gamma, mask)
    with pytest.raises(ValueError, match=cuda):
        taa_update.taa_round(x, R, dX, dF, mask, mask)
    with pytest.raises(ValueError, match="expected float32"):
        taa_update.taa_apply(x, R, dX, dF, gamma[..., :2], mask)
    with pytest.raises(ValueError, match="expected"):
        taa_update.taa_round(x, R, dX[..., :-1], dF, mask, mask)
    with pytest.raises(ValueError, match="expected"):
        taa_update.taa_gram(dF, R.to(torch.bfloat16), mask)
    with pytest.raises(ValueError, match="history size"):
        taa_update.taa_gram(torch.zeros(*lanes, 9, T, D), R, mask)
    assert taa_update.launches["taa_gram"] == 0
    assert taa_update._lib.cache_info().currsize == 0


@pytest.mark.parametrize("kernel", [taa_update, flash_attention,
                                    flash_decode, ssd_scan, rglru_scan],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_kernel_build_is_repo_local_and_gitignored(kernel):
    """One library per kernel source, built into the gitignored
    build/kernels/ for sm_90a."""
    assert build.BUILD_DIR == REPO / "build" / "kernels"
    assert kernel.SOURCE.exists() and kernel.SOURCE in build.SOURCES
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert os.path.basename(kernel.library_path()).startswith(
        f"lib{kernel.SOURCE.stem}_")
    assert kernel.library_path().parent == build.BUILD_DIR
    assert taa_update.BUILD_DIR == build.BUILD_DIR
    assert taa_update.NVCC_FLAGS == build.NVCC_FLAGS


def test_tensor_core_attention_is_built_like_the_others():
    """The bf16 tensor-core attention kernel is a source of its own, built
    by the same nvcc call for sm_90a (wgmma needs the ``a``)."""
    assert flash_attention.SOURCE_TC.exists()
    assert flash_attention.SOURCE_TC in build.SOURCES
    assert flash_attention.library_path_tc().parent == build.BUILD_DIR
    assert os.path.basename(flash_attention.library_path_tc()).startswith(
        "libflash_attention_tc_")
