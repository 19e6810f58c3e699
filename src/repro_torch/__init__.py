"""repro_torch — the ParaTAA sampler in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

It mirrors the module names of the JAX package ``repro`` so each piece has
an obvious counterpart, but it imports neither ``jax`` nor ``repro``: what
it needs from there (configs, schedules, solver coefficients) it keeps as
its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu`` on the CLI); without CUDA and without that request they
raise instead of falling back to the CPU.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
