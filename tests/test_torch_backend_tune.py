"""The port's ``launch.backend``: TF32 switches are opt-in
(``--backend-tune``), set only on a CUDA device, returned True only when
one changed, and a no-op on the CPU — the counterparts of
tests/test_backend_tune.py, with PyTorch's switches for XLA's flags."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.launch.backend import (TUNED, apply_backend_tune,
                                        detect_platform, read_settings,
                                        tuned_settings, write_settings)

SOURCE = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "launch" / "backend.py"


@pytest.fixture
def restore_switches():
    """Whatever a test sets, the process gets its switches back."""
    saved = read_settings()
    yield saved
    write_settings(saved)


def test_module_imports_no_jax():
    tree = ast.parse(SOURCE.read_text())
    roots = {alias.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for alias in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert roots <= {"__future__", "argparse", "typing", "torch"}


def test_detect_platform_from_cuda_only():
    assert detect_platform(False) == "other"
    assert detect_platform(True) == "gpu"
    assert detect_platform() == ("gpu" if torch.cuda.is_available()
                                 else "other")


def test_tuned_settings_noop_off_gpu_and_tf32_on_gpu():
    current = {"cuda_matmul_allow_tf32": False, "cudnn_allow_tf32": False,
               "float32_matmul_precision": "highest"}
    assert tuned_settings(current, "other") is None
    tuned = tuned_settings(current, "gpu")
    assert tuned == TUNED
    assert current["float32_matmul_precision"] == "highest"   # pure
    assert tuned_settings(tuned, "gpu") == tuned              # idempotent


def test_apply_backend_tune_only_sets_switches_when_requested(
        restore_switches):
    write_settings({"cuda_matmul_allow_tf32": False,
                    "cudnn_allow_tf32": False,
                    "float32_matmul_precision": "highest"})
    before = read_settings()
    assert apply_backend_tune([], platform="gpu") is False
    assert apply_backend_tune(["--solver", "taa"], platform="gpu") is False
    assert read_settings() == before
    assert apply_backend_tune(["--backend-tune"], platform="gpu") is True
    assert read_settings() == TUNED
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "high"
    # a second application changes nothing
    assert apply_backend_tune(["--backend-tune"], platform="gpu") is False


def test_apply_backend_tune_noop_on_cpu_host(restore_switches):
    before = read_settings()
    assert apply_backend_tune(["--backend-tune"], platform="other") is False
    assert read_settings() == before
    if not torch.cuda.is_available():
        assert apply_backend_tune(["--backend-tune"]) is False
        assert read_settings() == before
