"""The port's roofline on H100 constants and its op counter: ``model_flops``
and ``taa_round_traffic`` equal to the reference's, ``roofline_terms``
bound by the same resource under both packages' constants where a term
clearly dominates, the counter's product FLOPs exact against an analytic
count of a reduced qwen3 prefill, and its peak exact on a chain of
allocations."""
import dataclasses

import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.roofline import analysis as JRA
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.launch import steps as S
from repro_torch.models import backbone as tb
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.counter import CostCounter

META = torch.device("meta")


def test_h100_constants():
    assert (RA.PEAK_FLOPS, RA.TF32_FLOPS, RA.F32_FLOPS) == \
        (989e12, 495e12, 67e12)
    assert (RA.HBM_BW, RA.HBM_PER_CHIP, RA.LINK_BW) == (3.35e12, 80e9, 450e9)
    assert RA.peak_for("bfloat16") == RA.PEAK_FLOPS
    assert RA.peak_for("float32") == RA.F32_FLOPS
    assert RA.peak_for("float32", tf32=True) == RA.TF32_FLOPS


def test_model_flops_match_jax_for_every_cell():
    for name in list(jreg.ARCHS):                     # the DiT included
        for shape_name, shape_j in jbase.SHAPES.items():
            got = RA.model_flops(treg.get_arch(name),
                                 tbase.SHAPES[shape_name])
            assert got == JRA.model_flops(jreg.ARCHS[name], shape_j), \
                (name, shape_name)


@pytest.mark.parametrize("T,D,m", [(25, 4096, 3), (100, 4096, 3),
                                   (1000, 256, 8), (7, 33, 1)])
def test_taa_round_traffic_matches_jax(T, D, m):
    got, want = RA.taa_round_traffic(T, D, m), JRA.taa_round_traffic(T, D, m)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.byte_ratio, got.launch_ratio) == \
        (want.byte_ratio, want.launch_ratio)


@pytest.mark.parametrize("flops,nbytes,coll,bound", [
    (1e15, 1e9, 0.0, "compute"), (1e9, 1e12, 0.0, "memory"),
    (1e9, 1e6, 1e12, "collective"), (5e13, 2e10, 1e8, "compute")])
def test_roofline_dominance_matches_jax(flops, nbytes, coll, bound):
    got = RA.roofline_terms(flops, nbytes, coll)
    want = JRA.roofline_terms(flops, nbytes, coll)
    assert got.dominant == want.dominant == bound
    assert got.step_time_lb == max(flops / 989e12, nbytes / 3.35e12,
                                   coll / 450e9)
    split = RA.roofline_terms(flops, nbytes, coll,
                              flops_by_dtype={"float32": flops})
    assert split.compute_s == flops / 67e12


def test_counter_products_exact_on_a_reduced_qwen3_prefill():
    """Every product of a reduced qwen3 prefill (2 x 40 tokens, dense
    attention) counted, against the analytic count: the q/k/v/o
    projections, scores and P.V over all 40 keys (the dense path scores
    every key and masks), the gated MLP and the last position's head."""
    cfg = treg.get_arch("qwen3-0.6b").reduced()
    b, s = 2, 40
    shape = tbase.ShapeConfig("p", s, b, "prefill")
    params, _ = S.abstract_model_state(cfg, with_opt=False)
    cache = S.abstract_cache(cfg, shape)
    tokens = S.input_specs(cfg, shape)["inputs"]
    with torch.no_grad(), CostCounter() as counter:
        logits, _ = tb.prefill(params, cfg, tokens, cache)
    assert logits.shape == (b, 1, cfg.vocab_size)
    d, n = cfg.d_model, b * s
    proj = 2 * n * d * (2 * cfg.q_dim + 2 * cfg.kv_dim)
    attn = 2 * 2 * b * cfg.num_heads * s * s * cfg.head_dim
    mlp = 3 * 2 * n * d * cfg.d_ff
    head = 2 * b * d * cfg.vocab_size
    assert counter.flops == cfg.num_layers * (proj + attn + mlp) + head
    assert dict(counter.flops_by_dtype) == {
        "bfloat16": cfg.num_layers * (proj + mlp) + head,
        "float32": cfg.num_layers * attn}


def test_counter_peak_exact_on_a_chain_of_allocations():
    base = torch.empty(1000, device=META)              # made before: 4000 B
    with CostCounter() as c:
        assert c.track(base) == 4000 and c.track(base) == 0
        a = base * 2                                   # 8000
        view = a[10:]                                  # a view: no storage
        del a                                          # the view keeps it
        assert c.live == 8000
        b = torch.empty(3000, device=META, dtype=torch.bfloat16)  # 14000
        c_ = b.float()                                 # 26000
        del b, view                                    # 16000
        d = c_ + 1                                     # 28000: the peak
        del c_, d                                      # 4000
    assert (c.live, c.peak) == (4000, 28000)
    assert c.bytes == (4000 + 4000) + (6000 + 12000) + (12000 + 12000)
    assert c.by_op["empty"][2] == 0 and c.by_op["slice"][2] == 0


def test_collective_bytes_take_the_hlo_parsers_kinds():
    """The port counts collective bytes where it issues them
    (``repro_torch.comm``); ``collective_bytes`` reports them under the
    kinds the reference's ``parse_collective_bytes`` reads from HLO."""
    from repro_torch import comm

    got = RA.collective_bytes({"all-gather": 4096, "all-reduce": 4,
                               "broadcast": 999})
    assert tuple(got) == tuple(JRA.parse_collective_bytes(""))
    assert got == {"all-gather": 4096, "all-reduce": 4, "reduce-scatter": 0,
                   "all-to-all": 0, "collective-permute": 0}
    comm.reset()
    assert RA.collective_bytes() == dict.fromkeys(RA.COLLECTIVES, 0)
