"""The port's examples on the CPU at their smallest arguments: each runs
end to end and its own checks hold (ParaTAA against sequential within
2e-2, serving bit for bit ``run_batch``, the routing and fused-round
equalities)."""
import importlib.util
from pathlib import Path

import pytest

from tests.test_torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_train_and_serve_on_cpu():
    err = _example("torch_train_and_serve").main(
        ["--steps", "10", "--requests", "2", "--batch-size", "2",
         "--device", "cpu"])
    assert err < 2e-2


def test_torch_trajectory_variation_on_cpu():
    steps = _example("torch_trajectory_variation").main(
        ["--train-steps", "5", "--steps-T", "8", "--device", "cpu"])
    assert set(steps) == {"cold", "warm T_init=8", "warm T_init=5"}
    assert steps["warm T_init=8"] <= steps["cold"]


def test_torch_quickstart_on_cpu():
    par, seq = _example("torch_quickstart").main(
        ["--train-steps", "5", "--steps-T", "12", "--device", "cpu"])
    assert par.iters < 12 and seq.iters == 12


@pytest.mark.parametrize("name", ["torch_train_and_serve",
                                  "torch_trajectory_variation",
                                  "torch_quickstart"])
def test_examples_default_to_cuda(name, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(name).main([])
