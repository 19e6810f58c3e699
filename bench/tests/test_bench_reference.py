"""The plain references against the program at a small size on the CPU:
the DiT, the Mamba2 denoiser and sequential DDIM.  Only this test takes
both sides."""
import pytest
import torch

from bench.harness import weights
from bench.harness.catalog import Catalog
from bench.reference import ddim
from bench.tests.support import ROOT, TINY


def tiny(name):
    cat = Catalog(ROOT)
    conf = {**cat.config(name), **TINY[name]}
    den = cat.module("denoisers", conf["family"])
    ref = cat.module("reference", conf["family"])
    params = weights.draw(den.param_defs(conf), 7, "cpu",
                          conf["weight_scales"])
    return conf, den, ref, params


@pytest.mark.parametrize("name", ["dit-xl-2-256", "mamba2-1.3b-denoiser"])
def test_denoiser_matches_the_program(name):
    conf, den, ref, params = tiny(name)
    n, lat = den.sample_shape(conf)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((3, n, lat), generator=gen)
    t = torch.tensor([999.0, 519.0, 39.0])
    y = torch.tensor([5, 0, 999])
    with torch.no_grad():
        got = den.make_eps_apply(conf)(params, x, t, y)
        want = ref.eps(params, conf, x, t, y)
    # float32 on both sides in another order of operations (the program's
    # chunked SSD over two chunks of 32 against the quadratic form, its
    # einsum attention against batched matmuls): rounding, not a formula
    scale = want.abs().max()
    assert scale > 1e-3                      # the scaled leaves shape eps
    assert (got - want).abs().max() <= 1e-5 * scale


def test_sequential_ddim_matches_the_program():
    from repro_torch.core import ddim_coeffs
    from repro_torch.sampling import sequential_sample

    conf, den, ref, params = tiny("dit-xl-2-256")
    T = 25
    n, lat = den.sample_shape(conf)
    xi = torch.randn((T + 1, n, lat), generator=torch.Generator()
                     .manual_seed(4))
    label = torch.tensor([17])

    def eps(x, t):
        return ref.eps(params, conf, x, t, label.expand(x.shape[0]))

    with torch.no_grad():
        got = sequential_sample(eps, ddim_coeffs(T), xi, return_traj=True)
        want = ddim.sample(eps, xi[None], T)[0]
    # the coefficients in float64 on both sides, applied in float32 (the
    # program rounds them to float32 first): relative rounding of x
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    a, b, c, taus = ddim.coefficients(T)
    coeffs = ddim_coeffs(T)
    assert taus == list(coeffs.taus)
    for mine, theirs in ((a, coeffs.a), (b, coeffs.b), (c, coeffs.c)):
        assert mine == pytest.approx(list(theirs), rel=1e-12, abs=1e-15)
