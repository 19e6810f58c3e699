"""Dispatch for every kernel of the port: the tensor's device decides.

A CPU tensor takes the plain PyTorch version (:mod:`repro_torch.kernels.ref`);
a CUDA tensor takes the hand-written kernel (:mod:`~repro_torch.kernels.
taa_update`, :mod:`~repro_torch.kernels.flash_attention`,
:mod:`~repro_torch.kernels.flash_decode`, :mod:`~repro_torch.kernels.
ssd_scan`, :mod:`~repro_torch.kernels.rglru_scan`), and a kernel that cannot
launch raises — there is no fallback.  The model-kernel entry points keep
the JAX package's signatures (``repro/kernels/ops.py``) without its
``interpret`` knob; the TAA functions take an optional leading lane axis
and the reference's ``use_pallas``: None (the default) chooses by the
device as above, True takes the kernel (a CPU tensor raises), False the
plain version on any device — an explicit request, never a fallback.
A ``meta`` tensor (shapes only, for the dry-run's cost counter) takes the
plain version; any other device raises.

The m x m solves of the staged round stay a PyTorch call, as the JAX
package leaves them to XLA outside its kernels: ``torch.linalg.solve_ex``
with ``check_errors=False``, the same LU solve as ``torch.linalg.solve``
without the host read of its ``info`` (which waits for the card), so the
staged round queues its work without a sync.  The fused round solves
in-kernel by pivot-free Gauss-Jordan.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import taa_update as _k


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def _use_kernel(t: torch.Tensor, use_pallas: Optional[bool]) -> bool:
    """The TAA functions' routing: by the device when ``use_pallas`` is
    None, else as asked (the kernel wrapper refuses a CPU tensor)."""
    return _on_card(t) if use_pallas is None else bool(use_pallas)


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, H, S, D); k, v (B, H, T, D) -> (B, H, S, D) in q's dtype."""
    if _on_card(q):
        return _fa.flash_attention(q, k, v, causal=causal, window=window)
    return _ref.attention_ref(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, lengths):
    """q (B, H, D); caches (B, T, KV, D); lengths (B,) -> (B, H, D)."""
    if _on_card(q):
        return _fd.flash_decode(q, k_cache, v_cache, lengths)
    return _ref.decode_ref(q, k_cache, v_cache, lengths)


def ssd(x, dt, A, B, C, *, chunk: int = 128):
    """Mamba2 SSD scan.  Returns (y, final_state)."""
    if _on_card(x):
        return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
    return _ref.ssd_ref(x, dt, A, B, C)


def rglru(a, b):
    """Linear recurrence h_t = a_t h_{t-1} + b_t over axis 1: in a's dtype
    from the kernel, float32 from the plain version (as in the JAX
    package)."""
    if _on_card(a):
        return _rg.rglru_scan_kernel(a, b)
    return _ref.rglru_ref(a, b)


def _suffix_sum(x, dim):
    """out[t] = sum_{j >= t} x[j] along ``dim``."""
    return torch.flip(torch.cumsum(torch.flip(x, [dim]), dim), [dim])


def _solve(A, b):
    """A x = b for batches of small systems, with no host read."""
    return torch.linalg.solve_ex(A, b, check_errors=False)[0]


def _eye(m: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(m, dtype=torch.float32, device=like.device)


# ``time_axis`` (the TAA functions below): the mesh axis the caller's solve
# window shards over, accepted as the JAX package's ops accept it.  Its
# replicate pins hold every cross-row reduction to the unsharded summation
# order; here the solver hands these functions operands that are already
# replicated over that axis (``repro_torch.core.parataa`` gathers the
# window's eps rows before the update), so every time rank runs the same
# round on the same bytes and the argument changes no value and adds no
# collective.


def taa_gram(dF, R, mask, *, use_pallas: Optional[bool] = None,
             time_axis: Optional[str] = None):
    """Per-row Gram blocks G_t = F_t^T F_t, u_t = F_t^T R_t (masked) — the
    memory-bound first pass every Anderson variant shares."""
    if _use_kernel(dF, use_pallas):
        return _k.taa_gram(dF, R, mask)
    return _ref.taa_gram_ref(dF, R, mask)


def taa_rowwise_gamma(dF, R, mask, *, lam: float = 1e-8,
                      use_pallas: Optional[bool] = None,
                      time_axis: Optional[str] = None):
    """Per-row TAA gammas via suffix-cumsum Grams (Theorem 3.2)."""
    G, u = taa_gram(dF, R, mask, use_pallas=use_pallas)
    m = dF.shape[-3]
    Gs = _suffix_sum(G, -3) + lam * _eye(m, G)
    us = _suffix_sum(u, -2)
    return _solve(Gs, us[..., None])[..., 0]


def taa_apply(x, R, dX, dF, gamma, mask, *,
              use_pallas: Optional[bool] = None,
              time_axis: Optional[str] = None):
    """Per-row history apply x_t + R_t - (dX_t + dF_t)^T gamma_t."""
    if _use_kernel(x, use_pallas):
        return _k.taa_apply(x, R, dX, dF, gamma, mask)
    return _ref.taa_apply_ref(x, R, dX, dF, gamma, mask)


def taa_round_staged(x, R, dX, dF, mask, *, mode: str = "taa",
                     lam: float = 1e-8, safeguard_mask=None,
                     use_pallas: Optional[bool] = None,
                     time_axis: Optional[str] = None):
    """The round as three stages — Gram pass, (suffix) reduce + solve,
    apply pass — for taa and the aa/aa+ global reductions."""
    T, m = x.shape[-2], dF.shape[-3]
    if mode == "taa":
        gamma = taa_rowwise_gamma(dF, R, mask, lam=lam,
                                  use_pallas=use_pallas)
    else:
        G, u = taa_gram(dF, R, mask, use_pallas=use_pallas)
        M = G.sum(-3) + lam * _eye(m, G)                       # (..., m, m)
        if mode == "aa":
            g = _solve(M, u.sum(-2)[..., None])[..., 0]
            gamma = g[..., None, :].expand(*g.shape[:-1], T, m)
        elif mode == "aa+":
            rhs = _suffix_sum(u, -2)                           # (..., T, m)
            gamma = _solve(M[..., None, :, :], rhs[..., None])[..., 0]
        else:
            raise ValueError(mode)
    if safeguard_mask is not None:
        gamma = torch.where(safeguard_mask[..., None], 0.0, gamma)
    return taa_apply(x, R, dX, dF, gamma, mask, use_pallas=use_pallas)


def taa_round(x, R, dX, dF, mask, *, mode: str = "taa", lam: float = 1e-8,
              safeguard_mask=None, use_pallas: Optional[bool] = None,
              time_axis: Optional[str] = None):
    """The whole Theorem-3.2 round as ONE dispatch.  On the card that is one
    ``taa_round`` kernel launch; on the CPU (or with ``use_pallas=False``)
    it is the staged composition of the plain versions
    (:func:`taa_round_staged`), so fused equals staged bit for bit there.
    ``safeguard_mask``: (..., T) bool rows forced to the plain FP update."""
    if _use_kernel(x, use_pallas):
        guard = torch.zeros_like(mask, dtype=torch.float32) \
            if safeguard_mask is None else safeguard_mask.to(torch.float32)
        return _k.taa_round(x, R, dX, dF, mask, guard, mode=mode, lam=lam)
    return taa_round_staged(x, R, dX, dF, mask, mode=mode, lam=lam,
                            safeguard_mask=safeguard_mask,
                            use_pallas=use_pallas)
