"""``use_pallas`` in the port: the reference's field and ``serve.py
--use-pallas {auto,on,off}``.  On the CPU, False (the plain versions,
asked for) is bit for bit the default None; True asks for the kernels,
so a CPU tensor raises — in the staged and the fused round, in
``step_chunk`` and in the engine's stepwise programs, which shows that
the flag reaches each of them; iters/nfe with False equal the
reference's on the same noise."""
from argparse import Namespace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.sampling import SampleRequest as JRequest
from repro_torch.core import parataa
from repro_torch.kernels import ops, taa_update
from repro_torch.launch import serve as tserve
from repro_torch.sampling import SampleRequest
from repro_torch.serving import EngineKey
from tests.test_torch_helpers import (assert_same_result, label_factories,
                                      normal)

D, T = 24, 12
JAX_FACTORY, TORCH_FACTORY = label_factories(D)
REQS = [(0, 40), (3, 41), (1, 3)]           # (label, seed)
CUDA = "one CUDA device"


def _engine(fuse, use_pallas, mod="torch", solver="taa"):
    factory = TORCH_FACTORY if mod == "torch" else JAX_FACTORY
    kw = {"fuse_round": fuse}
    if use_pallas is not None:
        kw["use_pallas"] = use_pallas
    return factory(EngineKey("oracle", T, solver), kw)


@pytest.mark.parametrize("fuse", [False, True], ids=["staged", "fused"])
def test_plain_routing_is_bit_equal_to_auto_and_to_jax_iters(fuse):
    reqs = [SampleRequest(label=l, seed=s) for l, s in REQS]
    auto = _engine(fuse, None).run_batch(reqs)
    off = _engine(fuse, False).run_batch(reqs)
    want = _engine(fuse, False, "jax").run_batch(
        [JRequest(label=l, seed=s) for l, s in REQS])
    for a, b, w in zip(auto, off, want):
        assert (a.iters, a.nfe) == (b.iters, b.nfe)
        assert torch.equal(torch.as_tensor(a.trajectory),
                           torch.as_tensor(b.trajectory))
        assert_same_result(b, w)
    assert taa_update.launches == {"taa_gram": 0, "taa_apply": 0,
                                   "taa_round": 0}


@pytest.mark.parametrize("fuse", [False, True], ids=["staged", "fused"])
def test_kernel_routing_reaches_the_rounds_and_refuses_cpu_tensors(fuse):
    eng = _engine(fuse, True)
    with pytest.raises(ValueError, match=CUDA):
        eng.run_batch([SampleRequest(label=0, seed=1)])
    # the stepwise programs: the first step reaches the round
    bank = eng.stepwise_open(2, chunk_iters=1)
    eng.stepwise_refill(bank, [0], [SampleRequest(label=0, seed=1)])
    with pytest.raises(ValueError, match=CUDA):
        eng.stepwise_step(bank)
    assert taa_update._lib.cache_info().currsize == 0   # nothing built


def test_step_chunk_and_ops_take_the_flag():
    from repro_torch.core import ddim_coeffs

    coeffs = ddim_coeffs(T)
    xi = torch.from_numpy(normal(0, 2, T + 1, D))
    eps = lambda x, t: 0.1 * x
    for fuse in (False, True):
        for flag in (None, False, True):
            cfg = parataa.ParaTAAConfig(order_k=4, fuse_round=fuse,
                                        use_pallas=flag)
            state = parataa.init_state(coeffs, cfg, xi)
            if flag:
                with pytest.raises(ValueError, match=CUDA):
                    parataa.step_chunk(eps, coeffs, cfg, state, 2)
                continue
            out = parataa.step_chunk(eps, coeffs, cfg, state, 2)
            if flag is None:
                ref = out
            assert torch.equal(out.x, ref.x)
    B, m = 2, 3
    x, R = (torch.from_numpy(normal(s, B, T, D)) for s in (1, 2))
    dX, dF = (torch.from_numpy(normal(s, B, m, T, D, scale=0.1))
              for s in (3, 4))
    mask = torch.ones(B, T)
    for fn in (ops.taa_round, ops.taa_round_staged):
        assert torch.equal(fn(x, R, dX, dF, mask, use_pallas=False),
                           fn(x, R, dX, dF, mask))
        with pytest.raises(ValueError, match=CUDA):
            fn(x, R, dX, dF, mask, use_pallas=True)


def test_meta_tensors_take_the_plain_path():
    """A ``meta`` tensor (the dry-run's cost counter) takes the plain
    version, with the output's shape and no launch; an unknown device
    still raises."""
    B, m = 2, 3
    meta = torch.device("meta")
    x, R = torch.empty(B, T, D, device=meta), torch.empty(B, T, D,
                                                          device=meta)
    dX, dF = torch.empty(B, m, T, D, device=meta), \
        torch.empty(B, m, T, D, device=meta)
    out = ops.taa_round(x, R, dX, dF, torch.ones(B, T, device=meta))
    assert out.device.type == "meta" and out.shape == (B, T, D)
    assert ops.attention(torch.empty(1, 2, 8, 16, device=meta),
                         torch.empty(1, 2, 8, 16, device=meta),
                         torch.empty(1, 2, 8, 16, device=meta)).shape == \
        (1, 2, 8, 16)
    assert taa_update.launches["taa_round"] == 0
    with pytest.raises(ValueError, match="no kernel or plain path"):
        ops._on_card(SimpleNamespace(device=torch.device("xpu")))


@pytest.mark.parametrize("flags", [["--use-pallas", "off"],
                                   ["--use-pallas", "off", "--fuse-round",
                                    "--serve-async", "--chunk-iters", "2",
                                    "--batch-size", "2"]],
                         ids=["sync", "async"])
def test_serve_main_use_pallas_off_runs_on_cpu(flags):
    outs, stats = tserve.main(["--smoke", "--device", "cpu", "--requests",
                               "2", "--steps-T", "6", "--backend-tune"]
                              + flags)
    assert len(stats) == 2 and np.all(np.isfinite(outs))
    assert tserve.USE_PALLAS == {"auto": None, "on": True, "off": False}
    args = Namespace(order_k=8, history_m=3, window=0, fuse_round=False)
    for value, flag in tserve.USE_PALLAS.items():
        args.use_pallas = value
        assert tserve.resolve_spec(args, "taa").use_pallas is flag
    with pytest.raises(ValueError, match=CUDA):
        tserve.main(["--smoke", "--device", "cpu", "--requests", "1",
                     "--steps-T", "4", "--use-pallas", "on"])

