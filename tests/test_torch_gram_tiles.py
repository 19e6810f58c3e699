"""K1 ``taa_gram``'s tiles on the CPU: ``taa_update.gram_plan`` covers
every (lane, row, D-tile) once, and ``tiled_gram``, a torch emulation of
the kernel (a row's tiles in one cluster of CTAs: per-thread vectors, the
block's fixed-order sum, each tile's sums gathered in the first CTA, their
sum in tile order), agrees with the JAX package's Pallas ``taa_gram`` in
interpret mode and its ``taa_gram_ref``, and gives the same bits whatever
order its tiles finish in."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import taa_update as jtaa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import taa_update as taa
from tests.test_torch_helpers import gram_tol, max_abs, normal


@pytest.mark.parametrize("shape", [(2, 3, 25, 4096), (2, 3, 25, 4000),
                                   (1, 8, 1000, 64), (2, 1, 7, 1037),
                                   (3, 5, 40, 5000), (1, 2, 3, 9000),
                                   (1, 1, 1, 1)])
@pytest.mark.parametrize("elem_size", [4, 2])
def test_gram_plan_covers_every_tile_once(shape, elem_size):
    """A row's tiles in one cluster of min(tiles_per_row, 8) CTAs, CTA c
    of the cluster taking tiles c, c + cluster, ...: every (lane, row, d)
    once; a thread's vector is 16 bytes and a CTA's threads cover a
    tile."""
    B, m, T, D = shape
    plan = taa.gram_plan(B, m, T, D, elem_size)
    tpr, cl = plan["tiles_per_row"], plan["cluster"]
    assert (tpr - 1) * plan["tile"] < D <= tpr * plan["tile"]
    assert plan["tiles"] == B * T * tpr
    assert cl == min(tpr, taa.GRAM_CLUSTER)
    assert plan["ctas"] == B * T * cl
    assert plan["vector"] * elem_size == taa.GRAM_VEC_BYTES
    assert plan["threads"] * plan["vector"] == plan["tile"]
    assert plan["sums_bytes"] == 4 * tpr * (m * (m + 1) // 2 + m)
    covered = np.zeros((B, T, tpr * plan["tile"]), np.int64)
    for cta in range(plan["ctas"]):
        bt, c = divmod(cta, cl)
        for j in range(c, tpr, cl):
            covered[bt // T, bt % T,
                    j * plan["tile"]:(j + 1) * plan["tile"]] += 1
    assert (covered[..., :D] == 1).all()


def test_gram_plan_fills_the_card_at_the_main_path_shape():
    """B=2, T=25, D=4096: 400 CTAs, one a tile, about three for each of 132
    SMs (the earlier one-CTA-per-row design launched 50)."""
    plan = taa.gram_plan(2, 3, 25, 4096)
    assert plan["ctas"] == plan["tiles"] == 400 > 2 * 132
    assert (plan["cluster"], plan["threads"], plan["vector"]) == (8, 128, 4)
    assert taa.gram_plan(2, 3, 25, 4096, elem_size=2)["threads"] == 64


def test_gram_plan_refuses_empty_shapes():
    with pytest.raises(ValueError, match="empty"):
        taa.gram_plan(0, 3, 25, 64)
    with pytest.raises(ValueError, match="element size"):
        taa.gram_plan(1, 3, 25, 64, elem_size=8)


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """(threads, NV) per-thread values -> (NV,): the kernel's block_sum, a
    shuffle-down tree in each warp of 32, then the warps in order."""
    w = v.reshape(-1, 32, v.shape[-1]).clone()
    for off in (16, 8, 4, 2, 1):
        w[:, :32 - off] = w[:, :32 - off] + w[:, off:]
    out = torch.zeros(v.shape[-1], dtype=torch.float32)
    for k in range(w.shape[0]):
        out = out + w[k, 0]
    return out


def tiled_gram(dF, R, mask, *, order=None):
    """taa_gram as the kernel computes it, its tiles finishing in the order
    ``order`` (tile ids (b T + t) tiles_per_row + j; default 0, 1, ...): a
    masked row's first CTA writes zeros; every other tile sums its threads'
    vectors (VEC consecutive elements each, in element order) and reduces
    them with block_sum into the row's gathered sums; once all of a row's
    tiles are in (the cluster barrier), its first CTA adds them in tile
    order.  Returns (G, u)."""
    f32 = torch.float32
    B, m, T, D = dF.shape
    plan = taa.gram_plan(B, m, T, D, dF.element_size())
    tile, tpr = plan["tile"], plan["tiles_per_row"]
    nt, vec = plan["threads"], plan["vector"]
    iu = torch.triu_indices(m, m)
    ng = iu.shape[1]
    pad = tpr * tile - D
    fp = torch.nn.functional.pad(dF.to(f32), (0, pad))
    rp = torch.nn.functional.pad(R.to(f32), (0, pad))
    gathered = torch.full((B * T, tpr, ng + m), float("nan"))
    G = torch.full((B, T, m, m), float("nan"))
    u = torch.full((B, T, m), float("nan"))

    def write(b, t, total):
        G[b, t, iu[0], iu[1]] = total[:ng]
        G[b, t, iu[1], iu[0]] = total[:ng]
        u[b, t] = total[ng:]

    for tile_id in (range(plan["tiles"]) if order is None else order):
        bt, j = divmod(int(tile_id), tpr)
        b, t = divmod(bt, T)
        w = mask[b, t].to(f32)
        if w == 0:
            if j == 0:
                write(b, t, torch.zeros(ng + m))
            continue
        sl = slice(j * tile, (j + 1) * tile)
        f = (fp[b, :, t, sl] * w).reshape(m, nt, vec)     # (m, threads, vec)
        r = (rp[b, t, sl] * w).reshape(nt, vec)
        acc = torch.zeros(nt, ng + m)
        for v in range(vec):                              # element order
            acc[:, :ng] += f[iu[0], :, v].T * f[iu[1], :, v].T
            acc[:, ng:] += f[:, :, v].T * r[:, v, None]
        gathered[bt, j] = _block_sum(acc)
    for bt in range(B * T):                               # after the barrier
        if mask.reshape(-1)[bt] != 0:
            sums = torch.zeros(ng + m)
            for jj in range(tpr):                         # tile order
                sums = sums + gathered[bt, jj]
            write(*divmod(bt, T), sums)
    return G, u


def _gram_case(m, T, D, seed=0):
    dF = normal(seed, 2, m, T, D, scale=0.1)
    R = normal(seed + 1, 2, T, D, scale=0.3)
    mask = np.stack([(np.arange(T) >= T // 3).astype(np.float32),
                     np.where(np.arange(T) % 3 == 1, 0.0, 0.5
                              ).astype(np.float32)])
    return dF, R, mask


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("T,D", [(6, 1037), (5, 512), (9, 37)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_gram_matches_jax(m, T, D, dtype):
    """Ragged D (1037: a multiple of neither 512 nor 4; 37 below one tile),
    masked rows and fractional weights, m = 1, 3 and 8, float32 and bf16:
    against the Pallas taa_gram in interpret mode and taa_gram_ref, per
    lane, within the bound of a Gram block summed in another order."""
    dF, R, mask = _gram_case(m, T, D)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    dFt, Rt = torch.from_numpy(dF).to(tdt), torch.from_numpy(R).to(tdt)
    maskt = torch.from_numpy(mask)
    G, u = tiled_gram(dFt, Rt, maskt)
    Gp, up = tref.taa_gram_ref(dFt, Rt, maskt)
    for b in range(2):
        tol = gram_tol(dFt[b], Rt[b], maskt[b])
        dFj, Rj = jnp.asarray(dF[b]).astype(jdt), jnp.asarray(R[b]).astype(jdt)
        mj = jnp.asarray(mask[b])
        Gk, uk = jtaa.taa_gram(dFj, Rj, mj, bd=512, interpret=True)
        Gr, ur = jref.taa_gram_ref(dFj, Rj, mj)
        for want_G, want_u in ((Gk, uk), (Gr, ur), (Gp[b], up[b])):
            assert max_abs(G[b], want_G) < tol and max_abs(u[b], want_u) < tol
        masked = mask[b] == 0
        assert (G[b][masked] == 0).all() and (u[b][masked] == 0).all()


def test_tiled_gram_gives_the_same_bits_in_any_tile_order():
    """The row's first CTA adds the gathered sums in tile order: the bits
    do not depend on the order the tiles finish in."""
    dF, R, mask = (torch.from_numpy(a) for a in _gram_case(3, 6, 2100))
    n = taa.gram_plan(2, 3, 6, 2100)["tiles"]
    orders = [None, list(reversed(range(n))),
              np.random.default_rng(3).permutation(n)]
    runs = [tiled_gram(dF, R, mask, order=o) for o in orders]
    for G, u in runs:
        assert torch.equal(G, runs[0][0]) and torch.equal(u, runs[0][1])
