"""Sampler strategy registry: one typed spec for seq | fp | fp+ | aa | aa+ | taa.

A ``SamplerSpec`` pins down every solver knob that used to be re-derived by
hand at each call site (mode-string mapping, order k, history m, window,
s_max heuristics).  Named defaults live in a registry so callers can resolve
``--solver taa`` to a full configuration with one call and override fields
explicitly where they differ.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.parataa import ParaTAAConfig

#: order_k sentinel: resolve to the full system order T at solve time.
FULL_ORDER = 0


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Declarative sampler strategy (resolved against T at solve time).

    name:      registry name ("seq", "fp", "fp+", "aa", "aa+", "taa", ...).
    solver:    underlying update rule: "seq" | "fp" | "aa" | "aa+" | "taa".
    order_k:   order of the nonlinear system (FULL_ORDER => k = T).
    history_m: Anderson history size (1 => plain fixed-point).
    window:    sliding window size w (0 => w = T).
    tau:       stopping tolerance.
    lam:       Gram regularizer (Remark 3.3).
    safeguard: Theorem 3.6 post-processing.
    s_max:     max iterations (0 => 2*T heuristic).
    fuse_round: fuse the whole Anderson round (gram + solve + apply) into
               one ``ops.taa_round`` dispatch per iteration — a single
               kernel launch on the card, the bitwise-identical staged
               composition on the CPU (``serve.py --fuse-round``).
    """
    name: str
    solver: str = "taa"
    order_k: int = 8
    history_m: int = 3
    window: int = 0
    tau: float = 1e-3
    lam: float = 1e-8
    safeguard: bool = True
    s_max: int = 0
    fuse_round: bool = False

    @property
    def is_sequential(self) -> bool:
        return self.solver == "seq"

    def check_request_flags(self, *, diagnostics: bool = False,
                            warm_start: bool = False,
                            solver_overrides: bool = False) -> None:
        """Reject request options that are solver-iteration concepts the
        sequential sampler does not have."""
        if self.is_sequential and diagnostics:
            raise ValueError("diagnostics recording is a solver-iteration "
                             "concept; the sequential sampler has none")
        if self.is_sequential and warm_start:
            raise ValueError("warm starts initialize solver iterates; the "
                             "sequential sampler has none")
        if self.is_sequential and solver_overrides:
            raise ValueError("per-request tau/max_iters/quality_steps are "
                             "solver-iteration budgets; the sequential "
                             "sampler has none")

    def s_max_for(self, T: int) -> int:
        return self.s_max if self.s_max else 2 * T

    # -- per-request solver budgets (ONE implementation for every entry
    # point: engine pack/collect, stepwise harvest, and api.run must agree)

    def iter_budget(self, T: int) -> int:
        """Run-to-convergence iteration budget (T for seq)."""
        return T if self.is_sequential else self.s_max_for(T)

    def request_iter_cap(self, request, T: int) -> int:
        """``request``'s iteration budget: s_max bounded by its own
        ``max_iters`` / ``quality_steps`` (Sec 4.1 early exit)."""
        s_max = self.iter_budget(T)
        cap = min(request.max_iters if request.max_iters is not None
                  else s_max,
                  request.quality_steps if request.quality_steps is not None
                  else s_max)
        return min(cap, s_max)

    def request_tau_sq(self, request) -> np.float32:
        """``request``'s SQUARED stopping tolerance — squared on the host
        so the default (this spec's python-float tau) packs to the exact
        f32 constant the pre-override program folded in."""
        tau = self.tau if request.tau is None else request.tau
        return np.float32(tau ** 2)

    def request_early_stopped(self, request, T: int, iters: int,
                              converged: bool) -> bool:
        """Did ``request`` exit at its OWN budget before full tolerance?"""
        cap = self.request_iter_cap(request, T)
        return not converged and cap < self.iter_budget(T) and iters >= cap

    def solver_config(self, T: int, *, t_init: int = 0) -> ParaTAAConfig:
        """Resolve this spec against a step count T."""
        if self.is_sequential:
            raise ValueError("the sequential sampler has no solver config")
        return ParaTAAConfig(
            order_k=self.order_k if self.order_k != FULL_ORDER else T,
            history_m=self.history_m, window=self.window, mode=self.solver,
            tau=self.tau, lam=self.lam, s_max=self.s_max_for(T),
            safeguard=self.safeguard, t_init=t_init,
            fuse_round=self.fuse_round)

    def stepwise_config(self, T: int) -> ParaTAAConfig:
        """Resolve this spec for the resumable stepwise solver.  Unlike
        :meth:`solver_config` this also covers "seq": the sequential sampler
        runs as mode="seq" state (one timestep per iteration, iter_cap=T)
        so serving can chunk/retire/refill it like any solver lane."""
        if self.is_sequential:
            return ParaTAAConfig(order_k=1, history_m=1, mode="seq",
                                 s_max=T, safeguard=False)
        return self.solver_config(T)


_REGISTRY: Dict[str, SamplerSpec] = {}


def register_sampler(spec: SamplerSpec) -> SamplerSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_sampler(name: str, **overrides) -> SamplerSpec:
    """Look up a named spec; keyword overrides replace individual fields."""
    try:
        spec = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown sampler {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None
    return dataclasses.replace(spec, **overrides) if overrides else spec


def sampler_names():
    return sorted(_REGISTRY)


register_sampler(SamplerSpec(name="seq", solver="seq"))
# FP (Shih et al. 2023): full-order fixed point, no acceleration
register_sampler(SamplerSpec(name="fp", solver="fp", order_k=FULL_ORDER,
                             history_m=1))
# FP+ (paper): tuned order
register_sampler(SamplerSpec(name="fp+", solver="fp", order_k=8, history_m=1))
register_sampler(SamplerSpec(name="aa", solver="aa"))
register_sampler(SamplerSpec(name="aa+", solver="aa+"))
# ParaTAA (the paper's headline method)
register_sampler(SamplerSpec(name="taa", solver="taa"))
