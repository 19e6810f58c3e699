"""The frozen FLOP formulas and the round's bytes against the program's
own counts: ``CostCounter`` over one denoiser call on ``meta`` tensors at
the published widths, and ``taa_round_traffic``."""
import pytest
import torch

from bench.harness.catalog import Catalog
from bench.harness.roofline import taa_round_bytes
from bench.tests.support import ROOT


def meta_tree(defs):
    if isinstance(defs, dict):
        return {k: meta_tree(v) for k, v in defs.items()}
    if isinstance(defs, list):
        return [meta_tree(v) for v in defs]
    return torch.empty(defs.shape, device="meta",
                       dtype=defs.dtype or torch.float32)


@pytest.mark.parametrize("name", ["dit-xl-2-256", "mamba2-1.3b-denoiser"])
def test_formula_equals_the_programs_count(name):
    from repro_torch.roofline.counter import CostCounter

    cat = Catalog(ROOT)
    conf = cat.config(name)
    den = cat.module("denoisers", conf["family"])
    formula = cat.module("flops", conf["family"]).per_sample_call(conf)
    n, lat = den.sample_shape(conf)
    batch = 3
    x = torch.empty((batch, n, lat), device="meta")
    t = torch.empty((batch,), device="meta")
    y = torch.zeros((batch,), dtype=torch.long, device="meta")
    params = meta_tree(den.param_defs(conf))
    with torch.no_grad(), CostCounter() as counter:
        den.make_eps_apply(conf)(params, x, t, y)
    assert counter.flops == batch * formula


@pytest.mark.parametrize("lanes,T,D,m", [(1, 25, 4096, 3), (8, 25, 4096, 3),
                                         (2, 1000, 4000, 8)])
def test_round_bytes_equal_the_programs_fused_count(lanes, T, D, m):
    from repro_torch.roofline.analysis import taa_round_traffic

    assert taa_round_bytes(lanes, T, D, m) == \
        lanes * taa_round_traffic(T, D, m).fused_bytes
