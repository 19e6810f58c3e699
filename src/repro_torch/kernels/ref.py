"""Plain PyTorch versions of every kernel of the port (the correctness
ground truth the CUDA kernels are held against, and the path a CPU tensor
takes).  Each has the contract of its counterpart in the JAX package's
``kernels/ref.py``.

The TAA-update functions take an optional leading lane axis: dF/dX (..., m,
T, D), x/R (..., T, D), mask/guard (..., T), gamma (..., T, m).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


# --- flash attention (fwd) ---------------------------------------------------


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, H, S, D); k, v (B, H, T, D) -> (B, H, S, D) in q's dtype.
    float32 softmax; queries right-aligned (offset T - S) when S < T."""
    f32 = torch.float32
    d, s, t = q.shape[-1], q.shape[2], k.shape[2]
    scores = torch.einsum("bhsd,bhtd->bhst", q.to(f32), k.to(f32)) \
        / math.sqrt(d)
    qp = torch.arange(s, device=q.device)[:, None] + (t - s)
    kp = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, v.to(f32)).to(q.dtype)


# --- GQA flash decode --------------------------------------------------------


def decode_ref(q, k_cache, v_cache, lengths):
    """q (B, H, D) one token; k/v_cache (B, T, KV, D); lengths (B,) valid
    prefix lengths -> (B, H, D) in q's dtype.  G = H / KV query heads share
    each cache head."""
    f32 = torch.float32
    b, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    qr = q.reshape(b, kv, h // kv, d).to(f32)
    scores = torch.einsum("bkgd,btkd->bkgt", qr, k_cache.to(f32)) \
        / math.sqrt(d)
    valid = torch.arange(t, device=q.device)[None] \
        < lengths.to(q.device)[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v_cache.to(f32))
    return out.reshape(b, h, d).to(q.dtype)


def quantize_kv(x):
    """(..., D) -> int8 values and (...,) float32 absmax scales: the JAX
    package's int8 KV-cache format (``models/attention.py``)."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def decode_int8_ref(q, k_q, v_q, lengths, k_scale, v_scale):
    """The int8 cache's oracle: dequantise with the (B, T, KV) scales, then
    :func:`decode_ref`."""
    f32 = torch.float32
    return decode_ref(q, k_q.to(f32) * k_scale[..., None],
                      v_q.to(f32) * v_scale[..., None], lengths)


# --- Mamba2 SSD scan ---------------------------------------------------------


def ssd_ref(x, dt, A, B, C, init_state=None):
    """The sequential (exact) SSD recurrence.  x (b, s, h, p); dt (b, s, h);
    A (h,); B, C (b, s, n) single group -> (y (b, s, h, p) float32,
    final_state (b, h, p, n) float32)."""
    f32 = torch.float32
    bsz, s, h, p = x.shape
    n = B.shape[-1]
    x, dt, A, B, C = (t.to(f32) for t in (x, dt, A, B, C))
    state = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device) \
        if init_state is None else init_state.to(f32)
    ys = []
    for i in range(s):
        a = torch.exp(dt[:, i] * A[None, :])                    # (b, h)
        upd = torch.einsum("bhp,bn,bh->bhpn", x[:, i], B[:, i], dt[:, i])
        state = state * a[..., None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, i], state))
    return torch.stack(ys, dim=1), state


# --- RG-LRU linear scan ------------------------------------------------------


def rglru_ref(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t.  a, b (B, S, C) -> (B, S, C) float32."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0.to(torch.float32)
    hs = []
    for i in range(a.shape[1]):
        h = a[:, i] * h + b[:, i]
        hs.append(h)
    return torch.stack(hs, dim=1)


# --- TAA update --------------------------------------------------------------


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
