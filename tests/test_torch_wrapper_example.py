"""``examples/torch_backbone_denoiser.py`` run as a program on the CPU: the
DiffusionWrapper trained a few steps, then ParaTAA against sequential
(split from ``tests/test_torch_wrapper.py`` to spread the test run's files
over its workers)."""
import pytest

from tests.test_torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_torch_backbone_denoiser_example_runs_on_the_cpu():
    """``examples/torch_backbone_denoiser.py --device cpu`` (2 training
    steps): ParaTAA's x0 within 2e-2 of sequential in fewer than T=50
    parallel steps."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_backbone_denoiser.py"
    spec = importlib.util.spec_from_file_location("torch_backbone_denoiser",
                                                  path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    res, err = example.main(["--arch", "h2o-danube-3-4b", "--train-steps",
                             "2", "--device", "cpu"])
    assert err < 2e-2 and res.converged and res.iters < 50
