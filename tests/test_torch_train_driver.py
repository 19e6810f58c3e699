"""The port's DiT train driver end to end on the CPU, at the reduced DiT
(``--smoke``): checkpoints, rollback after a crashed step, the arch and
device guards, and train -> checkpoint -> serve.  Split from
``tests/test_torch_train.py`` (the parity tests and the restart) so the
parallel run spreads the two files' cost."""
import numpy as np
import pytest
import torch

from repro_torch.launch import steps as TS
from repro_torch.launch import train as ttrain
from tests.test_torch_helpers import one_torch_thread  # noqa: F401
from tests.test_torch_helpers import rel_err

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _train_argv(ck, steps, every, batch=8):
    return ["--arch", "dit-xl", "--smoke", "--steps", str(steps), "--batch",
            str(batch), "--ckpt-dir", str(ck), "--ckpt-every", str(every),
            "--log-every", "100", "--device", "cpu"]


def test_train_driver_smoke(tmp_path):
    losses = ttrain.main(_train_argv(tmp_path / "ck", 12, 5))
    assert len(losses) == 12 and np.all(np.isfinite(losses))
    steps = sorted(p.name for p in (tmp_path / "ck").glob("step_*"))
    assert steps == ["step_00000005", "step_00000010", "step_00000012"]


def test_train_driver_recovers_from_a_crashed_step(tmp_path, monkeypatch):
    """A step that raises rolls the run back to the last checkpoint
    (``run_supervised``), and the rerun steps give the same losses."""
    real = TS.make_train_step
    crashed = []

    def flaky(*a, **kw):
        step_fn = real(*a, **kw)

        def wrapped(params, opt_state, batch, step, mark=None):
            if int(step) == 4 and not crashed:
                crashed.append(int(step))
                raise RuntimeError("simulated device failure")
            return step_fn(params, opt_state, batch, step, mark=mark)
        return wrapped

    monkeypatch.setattr(TS, "make_train_step", flaky)
    res = ttrain.run(_train_argv(tmp_path / "ck", 6, 3))
    assert crashed == [4]
    # steps 0-3, then back to the step-3 checkpoint: 3 again, 4, 5
    assert len(res.losses) == 7
    assert res.losses[3] == pytest.approx(res.losses[4], rel=1e-6)


def test_train_driver_refuses_an_unported_arch():
    """Every configured arch is ported; one that is not configured exits
    naming it."""
    with pytest.raises(SystemExit, match="unknown arch"):
        ttrain.main(["--arch", "mamba3-9b", "--smoke", "--device", "cpu"])


def test_train_driver_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--arch", "dit-xl", "--smoke", "--steps", "1"])


def test_port_train_then_serve_from_checkpoint(tmp_path):
    """The paper's system end to end in the port: train 30 steps, then
    serve ParaTAA and sequential from the checkpoint — the same samples in
    fewer parallel steps."""
    from repro_torch.launch.serve import main as serve_main

    ck = tmp_path / "ck"
    losses = ttrain.main(_train_argv(ck, 30, 15, batch=16))
    assert losses[-1] < losses[0]
    argv = ["--smoke", "--requests", "2", "--steps-T", "20", "--ckpt",
            str(ck), "--seed", "5", "--device", "cpu"]
    outs_par, stats = serve_main(argv + ["--solver", "taa"])
    outs_seq, _ = serve_main(argv + ["--solver", "seq"])
    assert rel_err(outs_par, outs_seq) < 2e-2
    assert all(s["iters"] < 20 for s in stats)
