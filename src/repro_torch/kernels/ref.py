"""Plain PyTorch versions of the TAA-update kernels (the correctness ground
truth the CUDA kernels are held against, and the path a CPU tensor takes).

Every function takes an optional leading lane axis: dF/dX (..., m, T, D),
x/R (..., T, D), mask/guard (..., T), gamma (..., T, m).
"""
from __future__ import annotations

import torch


def taa_gram_ref(dF, R, mask):
    """-> (G (..., T, m, m), u (..., T, m)) float32 per-row Gram blocks of
    the mask-weighted histories (suffix sums are the caller's)."""
    f32 = torch.float32
    dFw = dF.to(f32) * mask[..., None, :, None]
    Rw = R.to(f32) * mask[..., :, None]
    G = torch.einsum("...mtd,...ntd->...tmn", dFw, dFw)
    u = torch.einsum("...mtd,...td->...tm", dFw, Rw)
    return G, u


def taa_apply_ref(x, R, dX, dF, gamma, mask):
    """x + R - (dX + dF)^T gamma on rows with mask > 0, x elsewhere; in
    x's dtype."""
    f32 = torch.float32
    corr = torch.einsum("...mtd,...tm->...td", dX.to(f32) + dF.to(f32),
                        gamma.to(f32))
    w = mask[..., None]
    x_new = x.to(f32) + R.to(f32) * w - corr * w
    return torch.where(w > 0, x_new, x.to(f32)).to(x.dtype)


def gauss_jordan_ref(A, b):
    """Batched pivot-free Gauss-Jordan solve of A x = b; A (..., m, m)
    SPD + ridge, b (..., m) -> (..., m).  The elimination order of the
    fused kernel (and of the JAX package's ``_gauss_jordan``)."""
    m = A.shape[-1]
    aug = torch.cat([A, b[..., None]], dim=-1)              # (..., m, m+1)
    rows = torch.arange(m, device=A.device)[:, None]
    for k in range(m):
        piv = aug[..., k, :] / aug[..., k, k:k + 1]           # (..., m+1)
        factor = aug[..., :, k]                               # (..., m)
        elim = aug - factor[..., None] * piv[..., None, :]
        aug = torch.where(rows == k, piv[..., None, :], elim)
    return aug[..., :, m]


def _suffix_sum(x, dim):
    return torch.flip(torch.cumsum(torch.flip(x, [dim]), dim), [dim])


def round_gamma_ref(G, u, mode: str, lam: float):
    """The fused round's reduction + solve: suffix sums (taa), global sums
    (aa), global Gram with suffix cross term (aa+), ridge, Gauss-Jordan.
    G (..., T, m, m), u (..., T, m) -> gamma (..., T, m)."""
    T, m = u.shape[-2], u.shape[-1]
    eye = torch.eye(m, dtype=torch.float32, device=G.device)
    if mode == "taa":
        Gs, us = _suffix_sum(G, -3), _suffix_sum(u, -2)
    elif mode in ("aa", "aa+"):
        Gs = G.sum(-3, keepdim=True).expand(G.shape)
        us = u.sum(-2, keepdim=True).expand(u.shape) if mode == "aa" \
            else _suffix_sum(u, -2)
    else:
        raise ValueError(mode)
    return gauss_jordan_ref(Gs + lam * eye, us)


def taa_round_ref(x, R, dX, dF, mask, guard, *, mode: str = "taa",
                  lam: float = 1e-8):
    """Plain version of the fused round: Gram blocks -> reductions + ridge
    -> pivot-free solves -> rows with guard > 0 get gamma = 0 -> apply."""
    G, u = taa_gram_ref(dF, R, mask)
    gamma = round_gamma_ref(G, u, mode, lam)
    gamma = torch.where(guard[..., None] > 0, 0.0, gamma)
    return taa_apply_ref(x, R, dX, dF, gamma, mask)
