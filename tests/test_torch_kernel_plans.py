"""The plans of the redesigned kernels, on the CPU: how the split-KV flash
decode cuts the cache (``flash_decode.split_plan``) and merges its ranges,
which attention kernel a call takes (``flash_attention.attention_path``),
which key tiles a query tile loads (``flash_attention.live_key_tiles``),
how the fused TAA round tiles its cooperative grid
(``taa_update.round_plan``), how the SSD scan cuts the sequence into
chunks (``ssd_scan.chunk_plan``) and how the RG-LRU scan cuts (B, S, C)
into chained tiles (``rglru_scan.tile_plan``).  The split decode, the tiled
round, the chunked SSD scan and the TF32 attention (with their 3xTF32
products) and the chained RG-LRU scan are emulated in torch and held
against the JAX package's references and Pallas kernels (interpret mode)
on the same numpy inputs."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import taa_update as jtaa
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.rglru_scan import rglru_scan_kernel as jrglru
from repro.kernels.ssd_scan import ssd_scan as jssd
from repro.models.attention import _dequantize_kv, _quantize_kv
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as rg
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
    """float32, and bf16 rows that are not whole 16-byte vectors, take the
    mma.sync TF32 kernel (once a CUDA-core kernel, hence the name)."""
    assert fa.attention_path(dtype, d) == "tensor_cores_tf32"


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


# --- K4 flash_attention: the TF32 kernel (float32 in 3xTF32) -----------------

# the A fragment's k-index j of an 8-key step holds key PV_ORDER[j]: the
# score accumulator's columns (2t, 2t + 1) taken as k-indices (t, t + 4)
PV_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]


def tiled_tf32_attention(q, k, v, *, causal, window, form="3xtf32"):
    """The TF32 kernel's attention in torch: query tiles and key tiles of
    ``flash_attention.tf32_tiles``, only the key tiles of ``live_key_tiles``
    loaded, the depth zero-padded to a multiple of 8; per key tile S = Q K^T,
    the masks (-1e30; -inf past T), the online softmax in the log2 domain,
    and O += P V with P's columns and V's rows in the fragments' permuted
    order; out = O / max(l, 1e-30).  Products as ``matmul(form=...)``."""
    f32 = torch.float32
    B, H, S, D = q.shape
    T = k.shape[2]
    bq, bk = fa.tf32_tiles(D)
    dp = -(-D // 8) * 8
    pad = lambda x, rows: torch.nn.functional.pad(                # noqa: E731
        x.to(f32), (0, dp - D, 0, rows - x.shape[2]))
    nq, nk = -(-S // bq), -(-T // bk)
    qs, ks, vs = pad(q, nq * bq), pad(k, nk * bk), pad(v, nk * bk)
    scale = torch.tensor(math.log2(math.e), dtype=f32) / math.sqrt(D)
    perm = torch.tensor([8 * (j // 8) + PV_ORDER[j % 8] for j in range(bk)])
    out = torch.zeros(B, H, nq * bq, dp)
    for qt in range(nq):
        qtile = qs[:, :, qt * bq:(qt + 1) * bq]
        qp = torch.arange(qt * bq, (qt + 1) * bq)[:, None] + (T - S)
        m = torch.full((B, H, bq, 1), NEG_INF)
        l = torch.zeros(B, H, bq, 1)
        o = torch.zeros(B, H, bq, dp)
        for kt in fa.live_key_tiles(qt, S, T, causal, window, bq=bq, bk=bk):
            sl = slice(kt * bk, (kt + 1) * bk)
            x = matmul(qtile, ks[:, :, sl].transpose(-1, -2), form) * scale
            kp = torch.arange(kt * bk, (kt + 1) * bk)[None, :]
            ok = torch.ones(bq, bk, dtype=torch.bool)
            if causal:
                ok &= kp <= qp
            if window:
                ok &= kp > qp - window
            x = torch.where(ok, x, NEG_INF)
            x = torch.where(kp >= T, -math.inf, x)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + matmul(p[..., perm], vs[:, :, sl][:, :, perm],
                                   form)
            m = m_new
        out[:, :, qt * bq:(qt + 1) * bq] = o / torch.clamp(l, min=1e-30)
    return out[:, :, :S, :D].to(q.dtype)


def test_pv_fragment_takes_the_score_accumulator_as_it_lies():
    """Lane by lane: the m16n8 score accumulator element e of lane (g, t)
    sits at (row g + 8 (e >> 1), key 2t + (e & 1)); the P V A fragment
    takes (e0, e2, e1, e3) as k-indices (t, t, t + 4, t + 4) of rows
    (g, g + 8, g, g + 8), and B reads V's rows 2t, 2t + 1 for k-indices t,
    t + 4.  So each A entry meets V's row of its own key, and every (row,
    key) of the 16 x 8 block is used once."""
    seen = np.zeros((16, 8), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        acc = {e: (g + 8 * (e >> 1), 2 * t + (e & 1)) for e in range(4)}
        frag = [(acc[0], t), (acc[2], t), (acc[1], t + 4), (acc[3], t + 4)]
        for (row, key), kidx in frag:
            assert PV_ORDER[kidx] == key         # B's row for this k-index
            seen[row, key] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("s,t,d,causal,window,jblocks", [
    (256, 256, 72, False, 0, (128, 128)),       # DiT-XL's shape, cut in B, H
    (96, 320, 72, True, 0, (32, 64)),           # ragged S < T
    (96, 320, 72, True, 100, (32, 64)),         # and a window
    (96, 320, 72, False, 150, (32, 64)),        # window without causal
    (64, 192, 136, True, 70, (64, 64)),         # D > 128: 32-key tiles
    (100, 100, 37, True, 0, (100, 100)),        # odd D, padded to 40
])
def test_tiled_tf32_attention_matches_jax(s, t, d, causal, window, jblocks):
    """Against the JAX attention_ref and the Pallas kernel in interpret mode
    (its own tiles), within the JAX kernel tests' float32 bound 3e-5."""
    q, k, v = normal(20, 1, 2, s, d), normal(21, 1, 2, t, d), \
        normal(22, 1, 2, t, d)
    got = tiled_tf32_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               window=window)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    assert max_abs(got, want) < 3e-5
    kern = jflash(jq, jk, jv, causal=causal, window=window, bq=jblocks[0],
                  bk=jblocks[1], interpret=True)
    assert max_abs(got, kern) < 3e-5


def test_3xtf32_attention_holds_the_bound_and_one_tf32_product_does_not():
    """At DiT-XL's attention shape per head (S = T = 256, D = 72; B = 1, H =
    2), inputs from numpy seed 4: both products split 3xTF32 stay within
    3e-5 of a float64 reference, as plain float32 does; one TF32 product
    each misses it."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 2, 256, 72)).astype(np.float32)
               for _ in range(3))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    want = tref.attention_ref(*(a.double() for a in t), causal=False)
    errs = {form: max_abs(tiled_tf32_attention(*t, causal=False, window=0,
                                               form=form), want)
            for form in ("f32", "3xtf32", "tf32")}
    assert errs["f32"] < 3e-5 and errs["3xtf32"] < 3e-5, errs
    assert errs["tf32"] > 3e-5, errs
    got = tiled_tf32_attention(*t, causal=False, window=0)
    jwant = jref.attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=False)
    assert max_abs(got, jwant) < 3e-5


# --- K7 rglru_scan: chained tiles, one read of a and b ------------------------


def chained_rglru(a, b, order=None, written=None):
    """The chained kernel in torch, tile by tile: per tile 32 threads' maps
    of 8 steps each (identity past S and C), a shuffle scan over them in the
    kernel's tree, the chain h_end = A h_prev + B from the predecessor's
    published state, the exclusive prefix applied to h_prev and the 8 steps
    run again.  ``order``: the order tiles are taken up in (default the
    segment-major ticket order); a tile whose predecessor has not published
    waits (goes to the back).  ``written`` counts h's writes."""
    f32 = torch.float32
    B, S, C = a.shape
    plan = rg.tile_plan(B, S, C, a.element_size())
    cb, seg_len, steps = plan["channels"], plan["steps"], rg.SUB_STEPS
    subs = seg_len // steps
    chains = plan["chains"]
    blocks = plan["channel_blocks"]
    af = torch.ones(B, plan["segments"] * seg_len, blocks * cb)
    bf = torch.zeros_like(af)
    af[:, :S, :C], bf[:, :S, :C] = a.to(f32), b.to(f32)
    h = torch.empty(B, S, C, dtype=a.dtype)
    published = {}
    todo = list(range(plan["tiles"])) if order is None else list(order)
    assert sorted(todo) == list(range(plan["tiles"]))
    while todo:
        tile = todo.pop(0)
        seg, chain = divmod(tile, chains)
        if seg > 0 and tile - chains not in published:
            todo.append(tile)
            continue
        bi, blk = divmod(chain, blocks)
        ts = slice(seg * seg_len, (seg + 1) * seg_len)
        cs = slice(blk * cb, (blk + 1) * cb)
        at = af[bi, ts, cs].reshape(subs, steps, cb)
        bt = bf[bi, ts, cs].reshape(subs, steps, cb)
        A, Bv = torch.ones(subs, cb), torch.zeros(subs, cb)
        for i in range(steps):
            Bv = at[:, i] * Bv + bt[:, i]
            A = A * at[:, i]
        d = 1
        while d < subs:                      # Hillis-Steele, lane = subseg
            Au = torch.cat([torch.ones(d, cb), A[:-d]])
            Bu = torch.cat([torch.zeros(d, cb), Bv[:-d]])
            Bv, A = A * Bu + Bv, A * Au
            d *= 2
        exA = torch.cat([torch.ones(1, cb), A[:-1]])
        exB = torch.cat([torch.zeros(1, cb), Bv[:-1]])
        h_prev = published[tile - chains] if seg > 0 else torch.zeros(cb)
        published[tile] = A[-1] * h_prev + Bv[-1]
        hv = exA * h_prev + exB
        out = torch.empty(subs, steps, cb)
        for i in range(steps):
            hv = at[:, i] * hv + bt[:, i]
            out[:, i] = hv
        out = out.reshape(seg_len, cb)
        t_hi = min(seg_len, S - seg * seg_len)
        c_hi = min(cb, C - blk * cb)
        if t_hi > 0 and c_hi > 0:
            h[bi, seg * seg_len:seg * seg_len + t_hi,
              blk * cb:blk * cb + c_hi] = out[:t_hi, :c_hi].to(a.dtype)
            if written is not None:
                written[bi, seg * seg_len:seg * seg_len + t_hi,
                        blk * cb:blk * cb + c_hi] += 1
    return h


@pytest.mark.parametrize("shape", [(2, 4096, 2560), (1, 1, 1), (3, 17, 40),
                                   (2, 999, 130), (1, 257, 64)])
@pytest.mark.parametrize("elem", [2, 4])
def test_rglru_tile_plan_covers_the_input_once(shape, elem):
    """Tiles cover (B, S, C) once, segment-major: tile = segment * chains +
    chain, and a tile's predecessor (tile - chains) holds the same batch
    and channels one segment earlier."""
    B, S, C = shape
    plan = rg.tile_plan(B, S, C, elem)
    assert plan["channels"] == 8 * 16 // elem and plan["steps"] == 256
    cov = np.zeros((B, plan["segments"] * 256, plan["channel_blocks"]
                    * plan["channels"]), np.int64)
    for tile in range(plan["tiles"]):
        seg, chain = divmod(tile, plan["chains"])
        bi, blk = divmod(chain, plan["channel_blocks"])
        cov[bi, seg * 256:(seg + 1) * 256,
            blk * plan["channels"]:(blk + 1) * plan["channels"]] += 1
    assert (cov[:, :S, :C] == 1).all()
    assert (plan["segments"] - 1) * 256 < S <= plan["segments"] * 256


@pytest.mark.parametrize("ctas", [1, 7, 132, 264, 10000])
def test_rglru_grid_walk_waits_only_on_earlier_tiles(ctas):
    """CTA c walks tiles c, c + ctas, ... in order; each tile waits only on
    a smaller one, taken up by its CTA no later than the waiting tile's
    turn (earlier, on the same CTA), so the smallest unfinished tile can
    always go on when every CTA is resident."""
    plan = rg.tile_plan(2, 4096, 2560, 4)
    n = plan["tiles"]
    grid = min(ctas, n)
    for tile in range(plan["chains"], n):
        pred = tile - plan["chains"]
        assert pred // grid <= tile // grid
        if pred % grid == tile % grid:
            assert pred // grid < tile // grid


def test_rglru_tile_plan_refuses_empty_shapes():
    with pytest.raises(ValueError, match="empty"):
        rg.tile_plan(0, 10, 10, 4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("shape,blocks", [((2, 600, 100), (200, 50)),
                                          ((1, 300, 200), (100, 40))])
def test_chained_rglru_matches_jax_at_ragged_s_and_c(dtype, tol, shape,
                                                     blocks):
    """S and C no multiples of the kernel's 256 steps and 32 / 64 channels:
    against the JAX rglru_ref and the Pallas kernel in interpret mode (its
    own tiles), every (b, t, c) written once."""
    B, S, C = shape
    a = 1 / (1 + np.exp(-normal(30, B, S, C)))
    b = normal(31, B, S, C, scale=0.3)
    at = torch.from_numpy(a.astype(np.float32)).to(dtype)
    bt = torch.from_numpy(b).to(dtype)
    written = torch.zeros(B, S, C, dtype=torch.int64)
    got = chained_rglru(at, bt, written=written)
    assert got.dtype == dtype and bool((written == 1).all())
    ja, jb = jnp.asarray(at.float().numpy()), jnp.asarray(bt.float().numpy())
    assert max_abs(got, jref.rglru_ref(ja, jb)) < tol
    kern = jrglru(ja, jb, bt=blocks[0], bc=blocks[1], interpret=True)
    assert max_abs(got, kern) < tol


def test_chained_rglru_does_not_depend_on_the_order_tiles_finish_in():
    """Whatever order the tiles are taken up in (tickets, reversed,
    shuffled), each tile waits for its predecessor and the result is the
    same bit for bit."""
    a = torch.from_numpy(1 / (1 + np.exp(-normal(32, 2, 700, 90))))
    b = torch.from_numpy(normal(33, 2, 700, 90, scale=0.3))
    n = rg.tile_plan(2, 700, 90, 4)["tiles"]
    orders = [None, list(range(n))[::-1],
              list(np.random.default_rng(0).permutation(n))]
    runs = [chained_rglru(a, b, order=o) for o in orders]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
