"""repro_torch.sampling — the sampling API of the port.

  * ``SamplerSpec`` / ``get_sampler`` — strategy registry
    (seq | fp | fp+ | aa | aa+ | taa).
  * ``run(spec, eps_fn, coeffs, xi, init=..., diagnostics=...)`` — one
    request, functional.
  * ``sequential_sample(eps_fn, coeffs, xi, return_traj=...)`` — the eq.
    (6) reference sampler for one request, and ``draw_noises``, the noise
    convention.
  * ``SamplingEngine`` — batched execution of ``SampleRequest``s with the
    requests as the solver's lane axis.
  * ``Placement`` — where that engine runs: a rank mesh
    (``repro_torch.launch.mesh``) with the request axis over ``data`` and
    the solve window over ``time``; ``Placement.host()`` is the one-device
    identity.
"""
from repro_torch.diffusion.samplers import draw_noises
from repro_torch.sampling.api import run, sequential_sample
from repro_torch.sampling.engine import SamplingEngine
from repro_torch.sampling.placement import Placement
from repro_torch.sampling.specs import (FULL_ORDER, SamplerSpec, get_sampler,
                                        register_sampler, sampler_names)
from repro_torch.sampling.types import SampleRequest, SampleResult, WarmStart

__all__ = [
    "run", "sequential_sample", "draw_noises", "SamplingEngine", "Placement",
    "FULL_ORDER", "SamplerSpec", "get_sampler", "register_sampler",
    "sampler_names",
    "SampleRequest", "SampleResult", "WarmStart",
]
