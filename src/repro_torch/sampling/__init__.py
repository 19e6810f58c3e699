"""repro_torch.sampling — the sampling API of the port.

  * ``SamplerSpec`` / ``get_sampler`` — strategy registry
    (seq | fp | fp+ | aa | aa+ | taa).
  * ``run(spec, eps_fn, coeffs, xi, init=..., diagnostics=...)`` — one
    request, functional.
  * ``SamplingEngine`` — batched execution of ``SampleRequest``s with the
    requests as the solver's lane axis.
"""
from repro_torch.diffusion.samplers import draw_noises
from repro_torch.sampling.api import run
from repro_torch.sampling.engine import SamplingEngine
from repro_torch.sampling.specs import (FULL_ORDER, SamplerSpec, get_sampler,
                                        register_sampler, sampler_names)
from repro_torch.sampling.types import SampleRequest, SampleResult, WarmStart

__all__ = [
    "run", "draw_noises", "SamplingEngine",
    "FULL_ORDER", "SamplerSpec", "get_sampler", "register_sampler",
    "sampler_names",
    "SampleRequest", "SampleResult", "WarmStart",
]
