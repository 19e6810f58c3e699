"""The plans of the redesigned kernels, on the CPU: how the split-KV flash
decode cuts the cache (``flash_decode.split_plan``) and merges its ranges,
which attention kernel a call takes (``flash_attention.attention_path``),
and which key tiles a query tile loads (``flash_attention.live_key_tiles``).
The split decode is emulated in torch (per-range partial softmax states,
then the merge in range order) and held against the JAX package's
``decode_ref`` and its int8 oracle on the same numpy inputs."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models.attention import _dequantize_kv, _quantize_kv
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from tests.test_torch_helpers import max_abs, normal

NEG_INF = -1e30

# chip_smoke.py phase 4's decode shapes: (B, KV, T, D)
PHASE4_DECODE = [(8, 8, 4096, 128), (8, 1, 2048, 256)]


@pytest.mark.parametrize("shape", PHASE4_DECODE + [
    (1, 1, 100, 64), (2, 2, 700, 128), (3, 6, 77, 72), (1, 1, 1, 16),
    (64, 8, 4096, 128), (2, 1, 2001, 256), (1, 4, 131072, 128)])
def test_split_plan_covers_the_cache_once(shape):
    B, KV, T, D = shape
    splits, chunk = fd.split_plan(B, KV, T, D)
    ranges = [(s * chunk, min((s + 1) * chunk, T)) for s in range(splits)]
    covered = np.zeros(T, np.int64)
    for lo, hi in ranges:
        assert lo < hi                     # no empty range
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if splits > 1:
        assert chunk % fd.CHUNK_STEP == 0 and chunk <= fd.MAX_CHUNK


@pytest.mark.parametrize("shape", PHASE4_DECODE)
def test_split_plan_fills_the_card_at_phase4_shapes(shape):
    B, KV, T, D = shape
    splits, _ = fd.split_plan(B, KV, T, D)
    assert B * KV * splits >= 2 * fd.SMS


def test_split_plan_keeps_one_range_when_the_card_is_full():
    assert fd.split_plan(33, 8, 300, 64) == (1, 300)     # 264 blocks
    assert fd.split_plan(1, 1, 30, 128) == (1, 30)       # T <= least


def test_split_plan_refuses_empty_shapes():
    with pytest.raises(ValueError, match="empty"):
        fd.split_plan(0, 1, 10, 64)


def split_decode(q, k, v, lengths, k_scale=None, v_scale=None):
    """The split pass and the combine in torch: each range's partial state
    (m = max of its live scores or -1e30, l, acc; keys past the range or
    the length add exactly 0), merged in range order; acc / max(l, 1e-30)."""
    f32 = torch.float32
    B, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    splits, chunk = fd.split_plan(B, KV, T, D)
    kf, vf = k.to(f32), v.to(f32)
    if k_scale is not None:
        kf, vf = kf * k_scale[..., None], vf * v_scale[..., None]
    s = torch.einsum("bkgd,btkd->bkgt", q.to(f32).reshape(B, KV, G, D), kf) \
        / math.sqrt(D)
    pos = torch.arange(T)
    parts = []
    for sp in range(splits):
        live = (pos >= sp * chunk) & (pos < (sp + 1) * chunk) \
            & (pos[None] < lengths[:, None])                    # (B, T)
        live = live[:, None, None, :]
        m = torch.where(live, s, NEG_INF).amax(-1)              # (B, KV, G)
        p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
        parts.append((m, p.sum(-1), torch.einsum("bkgt,btkd->bkgd", p, vf)))
    mt = torch.stack([m for m, _, _ in parts]).amax(0)
    acc = torch.zeros(B, KV, G, D)
    l = torch.zeros(B, KV, G)
    for m, ls, a in parts:                                      # range order
        f = torch.exp(m - mt)
        acc = acc + a * f[..., None]
        l = l + ls * f
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype), splits, chunk


@pytest.mark.parametrize("shape", [(3, 8, 2, 300, 64), (4, 10, 1, 500, 32),
                                   (2, 4, 4, 1000, 16)])
def test_split_decode_matches_jax_decode_ref(shape):
    """Lengths ending inside a range, at a range's start, just past it, and
    before the second range; the whole cache."""
    b, h, kv, t, d = shape
    splits, chunk = fd.split_plan(b, kv, t, d)
    assert splits > 2
    q, k, v = normal(0, b, h, d), normal(1, b, t, kv, d), \
        normal(2, b, t, kv, d)
    ends = [t, 2 * chunk, 2 * chunk + 1, chunk // 2 + 1][:b]
    lengths = np.array(ends, np.int64)
    got, _, _ = split_decode(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(lengths))
    want = jref.decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(lengths))
    assert max_abs(got, want) < 1e-5


def test_split_decode_length_zero_gives_zero():
    q, k, v = normal(3, 2, 4, 32), normal(4, 2, 400, 2, 32), \
        normal(5, 2, 400, 2, 32)
    lengths = torch.tensor([0, 250])
    got, splits, _ = split_decode(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), lengths)
    assert splits > 1
    assert float(got[0].abs().max()) == 0.0
    want = jref.decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(lengths.numpy()))
    assert max_abs(got[1], np.asarray(want)[1]) < 1e-5


def test_split_decode_int8_matches_jax_int8_oracle():
    q, k, v = normal(6, 3, 8, 64), normal(7, 3, 600, 2, 64), \
        normal(8, 3, 600, 2, 64)
    lengths = np.array([600, 1, 333])
    jkq, jks = _quantize_kv(jnp.asarray(k))
    jvq, jvs = _quantize_kv(jnp.asarray(v))
    t = lambda a: torch.from_numpy(np.array(a))             # noqa: E731
    got, splits, _ = split_decode(t(q), t(jkq), t(jvq), t(lengths),
                                  k_scale=t(jks), v_scale=t(jvs))
    assert splits > 1
    want = jref.decode_ref(jnp.asarray(q),
                           _dequantize_kv(jkq, jks, jnp.float32),
                           _dequantize_kv(jvq, jvs, jnp.float32),
                           jnp.asarray(lengths))
    assert max_abs(got, want) < 2e-5


@pytest.mark.parametrize("d", [40, 64, 72, 128, 256])
def test_attention_path_bf16_whole_vectors_take_tensor_cores(d):
    assert fa.attention_path(torch.bfloat16, d) == "tensor_cores"


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 100),
                                     (torch.bfloat16, 36)] +
                         [(torch.float32, d) for d in (40, 64, 72, 128, 256)])
def test_attention_path_others_take_cuda_cores(dtype, d):
    assert fa.attention_path(dtype, d) == "cuda_cores"


@pytest.mark.parametrize("s,t,causal,window,bk", [
    (300, 1000, True, 0, 128), (300, 1000, True, 200, 128),
    (300, 1000, False, 200, 64), (100, 777, True, 64, 64),
    (1000, 300, True, 0, 128), (256, 4096, True, 2048, 64),
    (130, 130, False, 0, 128)])
def test_live_key_tiles_match_a_brute_force_mask(s, t, causal, window, bk):
    """A 128-query tile loads exactly the key tiles in which some (query,
    key) pair survives the causal and window masks."""
    qp = np.arange(s)[:, None] + (t - s)
    kp = np.arange(t)[None, :]
    mask = np.ones((s, t), bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    for qt in range(-(-s // 128)):
        rows = mask[qt * 128:(qt + 1) * 128]
        live = [kt for kt in range(-(-t // bk))
                if rows[:, kt * bk:(kt + 1) * bk].any()]
        got = fa.live_key_tiles(qt, s, t, causal, window, bk=bk)
        assert list(got) == live, (qt, got, live)
