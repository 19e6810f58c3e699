"""The plans of the redesigned kernels, on the CPU: how the split-KV flash
decode cuts the cache (``flash_decode.split_plan``) and merges its ranges,
which attention kernel a call takes (``flash_attention.attention_path``),
which key tiles a query tile loads (``flash_attention.live_key_tiles``),
how the fused TAA round tiles its cooperative grid
(``taa_update.round_plan``) and how the SSD scan cuts the sequence into
chunks (``ssd_scan.chunk_plan``).  The split decode, the tiled round and
the chunked SSD scan (with its 3xTF32 products) are emulated in torch and
held against the JAX package's references and Pallas kernels (interpret
mode) on the same numpy inputs."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import taa_update as jtaa
from repro.kernels.ssd_scan import ssd_scan as jssd
from repro.models.attention import _dequantize_kv, _quantize_kv
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import taa_update as taa
from tests.test_torch_helpers import max_abs, normal, rel_err

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


# --- K3 taa_round: the cooperative grid --------------------------------------

MODES = ["taa", "aa", "aa+"]
# the main path's round: 2 lanes, history 3, T = 25, D = 256 tokens x 16
MAIN_ROUND = (2, 3, 25, 4096)


@pytest.mark.parametrize("shape", [MAIN_ROUND, (2, 3, 25, 4000),
                                   (1, 8, 1000, 64), (3, 5, 40, 5000),
                                   (2, 8, 25, 37), (1, 1, 1, 1)])
@pytest.mark.parametrize("co_resident", [1, 7, 264, 660, 100000])
def test_round_plan_walks_every_tile_once(shape, co_resident):
    """Tile ids cover every (lane, row, d) once; CTA c walks c, c + ctas,
    ...; the grid is the tiles or what the card holds, whichever is
    fewer."""
    B, m, T, D = shape
    plan = taa.round_plan(B, m, T, D, co_resident)
    tpr = plan["tiles_per_row"]
    assert (tpr - 1) * plan["tile"] < D <= tpr * plan["tile"]
    assert plan["tiles"] == B * T * tpr
    assert plan["ctas"] == min(plan["tiles"], co_resident)
    assert plan["partials"] == (B, m * (m + 1) // 2 + m, T, tpr)
    seen = np.zeros(plan["tiles"], np.int64)
    for c in range(plan["ctas"]):
        seen[c::plan["ctas"]] += 1
    assert (seen == 1).all()
    covered = np.zeros((B, T, tpr * plan["tile"]), np.int64)
    for tile in range(plan["tiles"]):
        bt, j = divmod(tile, tpr)
        covered[bt // T, bt % T, j * plan["tile"]:(j + 1) * plan["tile"]] += 1
    assert (covered[..., :D] == 1).all()


def test_round_plan_spreads_the_main_path_over_more_ctas_than_lanes():
    B, m, T, D = MAIN_ROUND
    # at least one CTA an SM on a 132-SM card
    plan = taa.round_plan(B, m, T, D, co_resident=132)
    assert plan["ctas"] == 132 > B
    assert plan["tiles"] == 2 * 25 * 8


def test_round_plan_refuses_empty_shapes():
    with pytest.raises(ValueError, match="empty"):
        taa.round_plan(0, 3, 25, 64, 132)
    with pytest.raises(ValueError, match="empty"):
        taa.round_plan(1, 3, 25, 64, 0)


def tiled_round(x, R, dX, dF, mask, guard, *, mode, lam, co_resident):
    """The cooperative round in torch, phase by phase: per-tile Gram
    partials into a (B, NV, T, tiles_per_row) scratch; the grid barrier;
    per row the partials reduced (suffix rows s >= t for taa, every row for
    aa and for aa+'s Gram), the ridge, pivot-free Gauss-Jordan, guard rows
    gamma = 0; the apply on every tile, walked by CTA as the kernel does."""
    f32 = torch.float32
    B, m, T, D = dF.shape
    plan = taa.round_plan(B, m, T, D, co_resident)
    tile, tpr, ng = plan["tile"], plan["tiles_per_row"], m * (m + 1) // 2
    pad = tpr * tile - D
    w = mask.to(f32)
    fw = torch.nn.functional.pad(dF.to(f32), (0, pad)) * w[:, None, :, None]
    rw = torch.nn.functional.pad(R.to(f32), (0, pad)) * w[..., None]
    fw = fw.reshape(B, m, T, tpr, tile)
    rw = rw.reshape(B, T, tpr, tile)
    # phase 0: each tile's m(m+1)/2 + m partial sums
    G = torch.einsum("bitjd,bktjd->btjik", fw, fw)
    iu = torch.triu_indices(m, m)
    g_tri = G[..., iu[0], iu[1]]                                # (B,T,tpr,NG)
    u = torch.einsum("bitjd,btjd->btji", fw, rw)                # (B,T,tpr,m)
    part = torch.cat([g_tri, u], -1).permute(0, 3, 1, 2)       # (B,NV,T,tpr)
    assert tuple(part.shape) == plan["partials"]
    # phase 1: per row, its partials in (row, tile) order
    rows = part.sum(-1)                                         # (B, NV, T)
    suffix = torch.flip(torch.cumsum(torch.flip(rows, [-1]), -1), [-1])
    total = rows.sum(-1, keepdim=True).expand_as(rows)
    lo_t = torch.zeros(ng + m, dtype=torch.bool)               # suffix?
    if mode == "taa":
        lo_t[:] = True
    elif mode == "aa+":
        lo_t[ng:] = True
    red = torch.where(lo_t[None, :, None], suffix, total)       # (B, NV, T)
    A = torch.zeros(B, T, m, m)
    A[..., iu[0], iu[1]] = red[:, :ng].permute(0, 2, 1)
    A[..., iu[1], iu[0]] = red[:, :ng].permute(0, 2, 1)
    A = A + lam * torch.eye(m)
    gamma = tref.gauss_jordan_ref(A, red[:, ng:].permute(0, 2, 1))
    gamma = torch.where(guard[..., None] > 0, 0.0, gamma)
    # phase 2: the apply, tile by tile in each CTA's walk
    out = torch.empty(B, T, tpr * tile, dtype=x.dtype)
    xp, rp = (torch.nn.functional.pad(a.to(f32), (0, pad)) for a in (x, R))
    hist = torch.nn.functional.pad(dX.to(f32) + dF.to(f32), (0, pad))
    for c in range(plan["ctas"]):
        for t_id in range(c, plan["tiles"], plan["ctas"]):
            bt, j = divmod(t_id, tpr)
            b, t = divmod(bt, T)
            sl = slice(j * tile, (j + 1) * tile)
            if mask[b, t] > 0:
                corr = gamma[b, t] @ hist[b, :, t, sl]
                out[b, t, sl] = (xp[b, t, sl] + rp[b, t, sl] - corr).to(x.dtype)
            else:
                out[b, t, sl] = xp[b, t, sl].to(x.dtype)
    return out[..., :D]


def _round_case(T, m, D, B=2, seed=0):
    x = normal(seed, B, T, D)
    R = normal(seed + 1, B, T, D, scale=0.3)
    dX = normal(seed + 2, B, m, T, D, scale=0.1)
    dF = normal(seed + 3, B, m, T, D, scale=0.1)
    wmask = np.stack([np.arange(T) >= 4, np.arange(T) >= T // 3])[:B]
    guard = np.stack([np.arange(T) >= T - 3, np.arange(T) >= T - 1])[:B]
    return x, R, dX, dF, wmask, guard


@pytest.mark.parametrize("m", [3, 8])
@pytest.mark.parametrize("T", [25, 1000])
@pytest.mark.parametrize("mode", MODES)
def test_tiled_round_matches_jax(mode, T, m):
    """Ragged D over several tiles, guard rows, a grid narrower than the
    tiles: against the JAX package's Pallas taa_round in interpret mode
    (T = 25) and its staged round (Gram, reductions, LU solve, apply), per
    lane, within the JAX kernel tests' float32 bound 3e-5."""
    D = 1100 if T == 25 else 600
    B = 2 if T == 25 else 1
    x, R, dX, dF, wmask, guard = _round_case(T, m, D, B=B)
    t = torch.from_numpy
    got = tiled_round(t(x), t(R), t(dX), t(dF), t(wmask.astype(np.float32)),
                      t(guard.astype(np.float32)), mode=mode, lam=1e-6,
                      co_resident=7)
    for b in range(B):
        args = [jnp.asarray(a[b]) for a in (x, R, dX, dF)]
        staged = jops.taa_round(*args, jnp.asarray(wmask[b], jnp.float32),
                                mode=mode, lam=1e-6,
                                safeguard_mask=jnp.asarray(guard[b]),
                                use_pallas=False)
        assert max_abs(got[b], staged) < 3e-5, (mode, b)
        if T == 25:
            pallas = jtaa.taa_round(*args, jnp.asarray(wmask[b], jnp.float32),
                                    jnp.asarray(guard[b], jnp.float32),
                                    mode=mode, lam=1e-6, bd=512,
                                    interpret=True)
            assert max_abs(got[b], pallas) < 3e-5, (mode, b)


def test_tiled_round_does_not_depend_on_the_grid():
    """Each tile's partials and each row's solve are the same whichever CTA
    computes them: the result is bit for bit the same for any grid."""
    x, R, dX, dF, wmask, guard = (torch.from_numpy(np.asarray(a, np.float32))
                                  for a in _round_case(25, 3, 1100))
    runs = [tiled_round(x, R, dX, dF, wmask, guard, mode="taa", lam=1e-6,
                        co_resident=c) for c in (1, 7, 1000)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


# --- K6 ssd_scan: the chunked form in 3xTF32 ----------------------------------


def tf32_nearest(a: torch.Tensor) -> torch.Tensor:
    """float32 -> tf32 (10 mantissa bits), nearest with ties away from zero:
    the kernel's hi = (bits + 0x1000) & 0xffffe000, and cvt.rna.tf32."""
    return ((a.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def tf32_truncate(a: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 handed over as tf32."""
    return (a.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def matmul(a, b, form):
    """a @ b in float32 as the kernel's products run: "f32" plain, "tf32"
    one product of operands rounded to tf32, "3xtf32" the split hi = tf32
    (a), lo = a - hi (truncated by the tensor core): lo hi + hi lo + hi hi.
    Products of tf32 operands are exact in float32; sums are float32."""
    if form == "f32":
        return a @ b
    ah, bh = tf32_nearest(a), tf32_nearest(b)
    if form == "tf32":
        return ah @ bh
    al, bl = tf32_truncate(a - ah), tf32_truncate(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def chunked_ssd(x, dt, A, B, C, *, form="3xtf32"):
    """The kernel's chunked SSD in torch: chunks of ``ssd.CHUNK`` steps
    (the last one zero-padded), per chunk cum = inclusive sum of dt A,
    W = (C B^T) o L with j > i masked before the exp, y = W x, the local
    state (w o x)^T B; then the chunks in order: y += exp(cum) C S^T with S
    the state entering the chunk, S = exp(cum_Q) S + local."""
    f32 = torch.float32
    x, dt, A, B, C = (t.to(f32) for t in (x, dt, A, B, C))
    bsz, s, h, p = x.shape
    n = B.shape[-1]
    plan = ssd.chunk_plan(s)
    q, nc = plan["chunk"], plan["chunks"]
    pad = nc * q - s
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    B, C = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (B, C))
    xc = x.reshape(bsz, nc, q, h, p).permute(0, 3, 1, 2, 4)     # b h c q p
    dtc = dt.reshape(bsz, nc, q, h).permute(0, 3, 1, 2)         # b h c q
    Bc, Cc = (t.reshape(bsz, 1, nc, q, n) for t in (B, C))      # b 1 c q n
    cum = torch.cumsum(dtc * A[None, :, None, None], -1)
    ii = torch.arange(q)[:, None]
    jj = torch.arange(q)[None, :]
    live = jj <= ii
    diff = torch.where(live, cum[..., :, None] - cum[..., None, :], 0.0)
    L = torch.where(live, torch.exp(diff), 0.0) * dtc[..., None, :]
    cb = matmul(Cc, Bc.transpose(-1, -2), form)                 # b 1 c q q
    y = matmul(cb * L, xc, form)                                # b h c q p
    wj = torch.exp(cum[..., -1:] - cum) * dtc                   # b h c q
    local = matmul((xc * wj[..., None]).transpose(-1, -2),
                   Bc.expand(bsz, h, nc, q, n), form)           # b h c p n
    state = torch.zeros(bsz, h, p, n)
    ys = []
    for c in range(nc):
        ct = Cc[:, :, c] * torch.exp(cum[:, :, c])[..., None]   # b h q n
        ys.append(y[:, :, c] + matmul(ct, state.transpose(-1, -2), form))
        state = state * torch.exp(cum[:, :, c, -1])[..., None, None] \
            + local[:, :, c]
    y = torch.stack(ys, 2).reshape(bsz, h, nc * q, p).permute(0, 2, 1, 3)
    return y[:, :s].contiguous(), state


def _ssd_case(shape, seed=4):
    b, s, h, p, n = shape
    x = normal(seed, b, s, h, p, scale=0.5)
    dt = np.log1p(np.exp(normal(seed + 1, b, s, h))).astype(np.float32)
    A = (-np.exp(normal(seed + 2, h, scale=0.3))).astype(np.float32)
    B = normal(seed + 3, b, s, n, scale=0.5)
    C = normal(seed + 4, b, s, n, scale=0.5)
    return x, dt, A, B, C


@pytest.mark.parametrize("s", [1, 53, 64, 65, 130, 2048])
def test_chunk_plan_covers_the_sequence(s):
    plan = ssd.chunk_plan(s)
    assert plan["chunk"] == ssd.CHUNK == 64
    assert (plan["chunks"] - 1) * plan["chunk"] < s <= \
        plan["chunks"] * plan["chunk"]
    assert set(plan["launches"]) == set(ssd.launches)
    assert plan["launches"] == {"ssd_scan": 1, "ssd_state_pass": 1}


def test_chunk_plan_refuses_an_empty_sequence():
    with pytest.raises(ValueError, match="empty"):
        ssd.chunk_plan(0)


@pytest.mark.parametrize("shape,chunk", [((2, 200, 3, 16, 32), 40),
                                         ((1, 53, 2, 8, 16), 53),
                                         ((1, 130, 2, 64, 128), 65),
                                         ((2, 128, 2, 50, 100), 64)])
def test_chunked_ssd_3xtf32_matches_jax_at_ragged_s(shape, chunk):
    """s not a multiple of the kernel's chunk (one chunk, a padded last
    chunk, whole chunks; p and n below their bounds): against the JAX
    ssd_ref and the Pallas kernel in interpret mode (its own chunk), 1e-4
    relative on y and on the final state (the JAX test's bound)."""
    arrs = _ssd_case(shape)
    y, fs = chunked_ssd(*(torch.from_numpy(a) for a in arrs))
    jarrs = [jnp.asarray(a) for a in arrs]
    yr, fsr = jref.ssd_ref(*jarrs)
    yk, fsk = jssd(*jarrs, chunk=chunk, interpret=True)
    for want in ((yr, fsr), (yk, fsk)):
        assert rel_err(y, want[0]) < 1e-4
        assert rel_err(fs, want[1]) < 1e-4


def _ssd_f64(x, dt, A, B, C):
    """The per-step recurrence in float64."""
    x, dt, A, B, C = (torch.from_numpy(a).double() for a in (x, dt, A, B, C))
    bsz, s, h, p = x.shape
    state = torch.zeros(bsz, h, p, B.shape[-1], dtype=torch.float64)
    ys = []
    for i in range(s):
        a = torch.exp(dt[:, i] * A[None])
        state = state * a[..., None, None] + torch.einsum(
            "bhp,bn,bh->bhpn", x[:, i], B[:, i], dt[:, i])
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, i], state))
    return torch.stack(ys, 1), state


def test_3xtf32_holds_the_bound_and_one_tf32_product_does_not():
    """At mamba2-1.3b's head widths (p = 64, n = 128; b = 1, s = 1024, h =
    4): the chunked form with every product split 3xTF32 stays within the
    1e-4 relative bound of a float64 per-step reference, as plain float32
    does; one TF32 product per step misses it.  The 3xTF32 form also holds
    the JAX package's float32 ssd_ref to 1e-4."""
    arrs = _ssd_case((1, 1024, 4, 64, 128), seed=11)
    y64, fs64 = _ssd_f64(*arrs)
    t = [torch.from_numpy(a) for a in arrs]
    errs = {}
    for form in ("f32", "3xtf32", "tf32"):
        y, fs = chunked_ssd(*t, form=form)
        errs[form] = max(rel_err(y, y64), rel_err(fs, fs64))
    assert errs["f32"] < 1e-4 and errs["3xtf32"] < 1e-4, errs
    assert errs["tf32"] > 1e-4, errs
    yr, fsr = jref.ssd_ref(*(jnp.asarray(a) for a in arrs))
    y, fs = chunked_ssd(*t)
    assert rel_err(y, yr) < 1e-4 and rel_err(fs, fsr) < 1e-4
