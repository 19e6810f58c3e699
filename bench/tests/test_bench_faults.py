"""A run with the timed path broken underneath comes out not correct.

Each case drives the whole of a run but the look for a card (``run_cell``
on the CPU, every configuration cut to a test's size by its file), once
sound and once with each fault the cells can have, switched on when the
window opens (the warm-up solve runs sound): a solver step that returns
its state unchanged, and an answer altered where it is produced (the
harvested x0 replaced by the trajectory's middle row, an unfinished
answer)."""
import pytest
import torch

from bench.harness.catalog import Catalog
from bench.harness.cell import run_cell

CELLS = ["dit-xl-2-256.taa25.c1", "mamba2-1.3b-denoiser.taa25.c1",
         "dit-xl-2-256.taa25.c8"]
SEED = 2 ** 31 + 11
#: long enough for a few requests to finish on a CPU shared by test workers
WINDOW_S = 5.0


def run(root, cell, seconds=WINDOW_S):
    return run_cell(Catalog(root), cell, SEED, seconds, False,
                    torch.device("cpu"), 0.0, lambda _: None)


def in_window(monkeypatch):
    """A flag that is on while the window runs."""
    from bench.harness.serve import Stack

    on = {"window": False}
    window = Stack.run

    def run_window(self, *args, **kw):
        on["window"] = True
        try:
            return window(self, *args, **kw)
        finally:
            on["window"] = False

    monkeypatch.setattr(Stack, "run", run_window)
    return on


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    out = run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 1
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_state_returned_unchanged_is_not_correct(tiny_root, cell,
                                                 monkeypatch):
    from repro_torch.core import parataa

    on, step = in_window(monkeypatch), parataa.step_chunk

    def unchanged(eps_fn, coeffs, cfg, state, n, **kw):
        return state if on["window"] else step(eps_fn, coeffs, cfg, state,
                                               n, **kw)

    monkeypatch.setattr(parataa, "step_chunk", unchanged)
    assert not run(tiny_root, cell, seconds=1.0)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced_is_not_correct(tiny_root, cell,
                                                      monkeypatch):
    from repro_torch.sampling.engine import SamplingEngine

    on, harvest = in_window(monkeypatch), SamplingEngine.stepwise_harvest

    def altered(self, bank):
        out = harvest(self, bank)
        for _, result in out if on["window"] else ():
            traj = result.trajectory
            traj[0] = traj[len(traj) // 2]
        return out

    monkeypatch.setattr(SamplingEngine, "stepwise_harvest", altered)
    out = run(tiny_root, cell)
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
