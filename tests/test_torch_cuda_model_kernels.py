"""The port's model kernels (flash attention, GQA flash decode, Mamba2 SSD
scan, RG-LRU scan) on the card, against their plain PyTorch versions, at
ragged shapes.  Every test needs a CUDA device and skips without one.

This file imports neither jax nor the JAX package, so it also runs on a
GPU machine without JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_cuda_model_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ssd

DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _t(rng, shape, cuda, dtype=torch.float32, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(cuda, dtype)


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 3, 100, 100, 72), (1, 2, 64, 200, 128),
                                   (1, 1, 130, 130, 256), (2, 2, 37, 53, 40)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 50), (False, 0),
                                           (False, 40)])
def test_flash_attention_matches_plain(dtype, shape, causal, window, cuda):
    b, h, s, t, d = shape
    rng = np.random.default_rng(0)
    q, k, v = (_t(rng, (b, h, n, d), cuda, dtype) for n in (s, t, t))
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    assert _err(out, want) < TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 8, 4, 512, 64), (3, 16, 2, 1000, 128),
                                   (2, 10, 1, 300, 256), (2, 6, 6, 77, 72)])
def test_flash_decode_matches_plain(dtype, shape, cuda):
    b, h, kv, t, d = shape
    rng = np.random.default_rng(1)
    q = _t(rng, (b, h, d), cuda, dtype)
    k, v = (_t(rng, (b, t, kv, d), cuda, dtype) for _ in range(2))
    lengths = torch.from_numpy(rng.integers(1, t + 1, size=b)).to(cuda)
    lengths[0] = t
    out = fd.flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert _err(out, ref.decode_ref(q, k, v, lengths)) < TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", DTYPES)
def test_flash_decode_int8_matches_dequant_oracle(qdtype, cuda):
    b, h, kv, t, d = 2, 8, 4, 600, 64
    rng = np.random.default_rng(2)
    q = _t(rng, (b, h, d), cuda, qdtype)
    kq, ks = ref.quantize_kv(_t(rng, (b, t, kv, d), cuda))
    vq, vs = ref.quantize_kv(_t(rng, (b, t, kv, d), cuda))
    lengths = torch.tensor([300, 600], device=cuda)
    out = fd.flash_decode(q, kq, vq, lengths, k_scale=ks, v_scale=vs)
    want = ref.decode_int8_ref(q, kq, vq, lengths, ks, vs)
    assert _err(out, want) < (2e-5 if qdtype == torch.float32 else 2e-2)


@pytest.mark.gpu
def test_flash_decode_length_zero_gives_zero(cuda):
    rng = np.random.default_rng(3)
    q = _t(rng, (2, 4, 64), cuda)
    k, v = (_t(rng, (2, 256, 2, 64), cuda) for _ in range(2))
    out = fd.flash_decode(q, k, v, torch.tensor([0, 5], device=cuda))
    assert float(out[0].abs().max()) == 0.0
    want = ref.decode_ref(q, k, v, torch.tensor([0, 5], device=cuda))
    assert _err(out[1], want[1]) < 3e-5


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 256, 4, 32, 64), (1, 200, 2, 64, 128),
                                   (1, 100, 3, 16, 32), (2, 53, 2, 50, 100)])
def test_ssd_scan_matches_plain(shape, cuda):
    b, s, h, p, n = shape
    rng = np.random.default_rng(4)
    x = _t(rng, (b, s, h, p), cuda, scale=0.5)
    dt = torch.nn.functional.softplus(_t(rng, (b, s, h), cuda))
    A = -torch.exp(_t(rng, (h,), cuda, scale=0.3))
    B, C = (_t(rng, (b, s, n), cuda, scale=0.5) for _ in range(2))
    y, fs = ssd.ssd_scan(x, dt, A, B, C)
    yr, fsr = ref.ssd_ref(x, dt, A, B, C)
    assert _err(y, yr) / float(yr.abs().max()) < 1e-4
    assert _err(fs, fsr) / float(fsr.abs().max()) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 300, 5, 64, 128), (2, 300, 5, 20, 36),
                                   (1, 129, 3, 50, 100), (2, 2048, 4, 64, 128)])
def test_ssd_scan_chunked_paths_match_plain(shape, cuda):
    """The chunked kernel across several chunks with a padded last one, a
    head count that is no multiple of the chunk kernel's 4 heads, both the
    16-byte (p, n multiples of 4) and the 4-byte staging, against the plain
    scan; the launches of ``chunk_plan``."""
    b, s, h, p, n = shape
    rng = np.random.default_rng(7)
    x = _t(rng, (b, s, h, p), cuda, scale=0.5)
    dt = torch.nn.functional.softplus(_t(rng, (b, s, h), cuda))
    A = -torch.exp(_t(rng, (h,), cuda, scale=0.3))
    B, C = (_t(rng, (b, s, n), cuda, scale=0.5) for _ in range(2))
    ssd.reset_launches()
    y, fs = ssd.ssd_scan(x, dt, A, B, C)
    assert ssd.launches == ssd.chunk_plan(s)["launches"]
    yr, fsr = ref.ssd_ref(x, dt, A, B, C)
    assert _err(y, yr) / float(yr.abs().max()) < 1e-4
    assert _err(fs, fsr) / float(fsr.abs().max()) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 512, 256), (1, 1000, 300), (3, 17, 40),
                                   (2, 4096, 64), (2, 999, 130),
                                   (2, 4096, 2560)])
def test_rglru_scan_matches_plain(dtype, shape, cuda):
    """Ragged S and C (C not a multiple of a 16-byte vector takes the
    element-wise loads), recurrentgemma-2b's width; the cooperative grid
    walks ``tile_plan``'s tiles; two runs bit for bit."""
    rng = np.random.default_rng(5)
    a = torch.sigmoid(_t(rng, shape, cuda)).to(dtype)
    b = _t(rng, shape, cuda, dtype, scale=0.3)
    h = rg.rglru_scan_kernel(a, b)
    assert h.dtype == dtype
    assert _err(h, ref.rglru_ref(a, b)) < (5e-2 if dtype == torch.bfloat16
                                           else 1e-4)
    plan = rg.tile_plan(*shape, a.element_size())
    grid = dict(rg.last_grid)
    assert grid["tiles"] == plan["tiles"]
    assert grid["ctas"] == min(plan["tiles"], grid["co_resident"])
    assert torch.equal(h, rg.rglru_scan_kernel(a, b))


@pytest.mark.gpu
def test_kernels_repeat_bit_for_bit_and_ops_count_launches(cuda):
    """No kernel uses float atomics: two runs give the same bits.  Each ops
    entry point on a CUDA tensor launches its kernel once (the decode's
    split pass and, with more than one split, its combine; attention's
    tensor-core kernel for bf16, counted also under "flash_attention"; the
    SSD scan's chunk pass and its state pass)."""
    rng = np.random.default_rng(6)
    q, k, v = (_t(rng, (1, 2, 150, 72), cuda) for _ in range(3))
    qb, kb, vb = (_t(rng, (1, 2, 300, 128), cuda, torch.bfloat16)
                  for _ in range(3))
    qd = _t(rng, (2, 8, 128), cuda)
    kc, vc = (_t(rng, (2, 700, 2, 128), cuda) for _ in range(2))
    lengths = torch.tensor([700, 333], device=cuda)
    x = _t(rng, (1, 300, 2, 64), cuda, scale=0.5)
    dt = torch.nn.functional.softplus(_t(rng, (1, 300, 2), cuda))
    A = -torch.exp(_t(rng, (2,), cuda, scale=0.3))
    B, C = (_t(rng, (1, 300, 128), cuda, scale=0.5) for _ in range(2))
    a = torch.sigmoid(_t(rng, (2, 999, 130), cuda))
    bb = _t(rng, (2, 999, 130), cuda, scale=0.3)
    assert fd.split_plan(2, 2, 700, 128)[0] > 1
    calls = [
        (fa, lambda: ops.attention(q, k, v, causal=True, window=64),
         {"flash_attention": 2, "flash_attention_tc": 0}),
        (fa, lambda: ops.attention(qb, kb, vb, causal=True, window=100),
         {"flash_attention": 2, "flash_attention_tc": 2}),
        (fd, lambda: ops.decode_attention(qd, kc, vc, lengths),
         {"flash_decode": 2, "flash_decode_combine": 2}),
        (ssd, lambda: ops.ssd(x, dt, A, B, C),
         {"ssd_scan": 2, "ssd_state_pass": 2}),
        (rg, lambda: ops.rglru(a, bb), {"rglru_scan": 2}),
    ]
    for mod, fn, want in calls:
        mod.reset_launches()
        first, second = fn(), fn()
        for u, w in zip(first if isinstance(first, tuple) else (first,),
                        second if isinstance(second, tuple) else (second,)):
            assert torch.equal(u, w), mod.__name__
        assert mod.launches == want, mod.__name__


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 72, 128, 256])
@pytest.mark.parametrize("s,t,causal,window", [
    (200, 200, True, 0),       # S, T not multiples of 128
    (100, 333, True, 0),       # S < T: right-aligned queries
    (300, 300, False, 0),
    (333, 333, True, 70),      # a window that kills whole key tiles
    (64, 700, False, 150),     # window without causal, S < T
])
def test_flash_attention_tensor_cores_match_plain(d, s, t, causal, window,
                                                  cuda):
    assert fa.attention_path(torch.bfloat16, d) == "tensor_cores"
    rng = np.random.default_rng(8)
    q, k, v = (_t(rng, (2, 3, n, d), cuda, torch.bfloat16) for n in (s, t, t))
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == {"flash_attention": 1, "flash_attention_tc": 1}
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    assert _err(out, want) < TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.float32, d) for d in (
    8, 37, 64, 72, 100, 128, 136, 256)] + [(torch.bfloat16, d)
                                          for d in (4, 36, 100, 250)])
@pytest.mark.parametrize("s,t,causal,window", [
    (200, 200, True, 0),       # S, T not multiples of the 64-query tile
    (100, 333, True, 0),       # S < T: right-aligned queries
    (300, 300, False, 0),
    (333, 333, True, 70),      # a window that kills whole key tiles
    (64, 700, False, 150),     # window without causal, S < T
])
def test_flash_attention_tf32_matches_plain(dtype, d, s, t, causal, window,
                                            cuda):
    """The mma.sync TF32 kernel: float32 (3xTF32) at every head dim, odd
    ones padded in shared memory; bf16 rows that are not whole 16-byte
    vectors; one launch, two runs bit for bit."""
    assert fa.attention_path(dtype, d) == "tensor_cores_tf32"
    rng = np.random.default_rng(14)
    q, k, v = (_t(rng, (2, 3, n, d), cuda, dtype) for n in (s, t, t))
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == {"flash_attention": 1, "flash_attention_tc": 0}
    assert out.dtype == dtype and out.shape == q.shape
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    assert _err(out, want) < TOL[dtype]
    again = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(out, again)


@pytest.mark.gpu
def test_flash_attention_bf16_odd_head_dim_takes_cuda_cores(cuda):
    """bf16 at D % 8 != 0 takes the mma.sync TF32 kernel (once the CUDA-core
    one), not the wgmma one."""
    rng = np.random.default_rng(9)
    q, k, v = (_t(rng, (1, 2, 90, 100), cuda, torch.bfloat16)
               for _ in range(3))
    fa.reset_launches()
    out = fa.flash_attention(q, k, v, causal=True)
    assert fa.launches == {"flash_attention": 1, "flash_attention_tc": 0}
    assert _err(out, ref.attention_ref(q, k, v)) < TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,lengths", [
    # lengths shorter than one range, T not a multiple of the range
    ((3, 8, 2, 1000, 128), [5, 1000, 37]),
    # the MQA shape (G = 10, D = 256), a length ending at a range's start
    ((4, 10, 1, 2001, 256), [2001, 48, 49, 1]),
    ((2, 16, 1, 999, 64), [999, 40]),       # G = 16
])
def test_flash_decode_splits_match_plain(dtype, shape, lengths, cuda):
    b, h, kv, t, d = shape
    splits, chunk = fd.split_plan(b, kv, t, d)
    assert splits > 1 and t % chunk and min(lengths) < chunk
    rng = np.random.default_rng(10)
    q = _t(rng, (b, h, d), cuda, dtype)
    k, v = (_t(rng, (b, t, kv, d), cuda, dtype) for _ in range(2))
    lengths = torch.tensor(lengths, device=cuda)
    fd.reset_launches()
    out = fd.flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    assert fd.launches == {"flash_decode": 1, "flash_decode_combine": 1}
    assert _err(out, ref.decode_ref(q, k, v, lengths)) < TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_one_split_writes_out_without_combine(dtype, cuda):
    b, h, kv, t, d = 33, 16, 8, 300, 64
    assert fd.split_plan(b, kv, t, d) == (1, t)
    rng = np.random.default_rng(13)
    q = _t(rng, (b, h, d), cuda, dtype)
    k, v = (_t(rng, (b, t, kv, d), cuda, dtype) for _ in range(2))
    lengths = torch.from_numpy(rng.integers(1, t + 1, size=b)).to(cuda)
    lengths[1] = 0
    fd.reset_launches()
    out = fd.flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    assert fd.launches == {"flash_decode": 1, "flash_decode_combine": 0}
    assert float(out[1].abs().max()) == 0.0
    keep = torch.arange(b, device=cuda) != 1
    want = ref.decode_ref(q, k, v, lengths)
    assert _err(out[keep], want[keep]) < TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", DTYPES)
def test_flash_decode_int8_splits_match_dequant_oracle(qdtype, cuda):
    b, h, kv, t, d = 3, 16, 2, 1500, 128
    assert fd.split_plan(b, kv, t, d)[0] > 1
    rng = np.random.default_rng(11)
    q = _t(rng, (b, h, d), cuda, qdtype)
    kq, ks = ref.quantize_kv(_t(rng, (b, t, kv, d), cuda))
    vq, vs = ref.quantize_kv(_t(rng, (b, t, kv, d), cuda))
    lengths = torch.tensor([1500, 3, 801], device=cuda)
    fd.reset_launches()
    out = fd.flash_decode(q, kq, vq, lengths, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert fd.launches == {"flash_decode": 1, "flash_decode_combine": 1}
    want = ref.decode_int8_ref(q, kq, vq, lengths, ks, vs)
    assert _err(out, want) < (2e-5 if qdtype == torch.float32 else 2e-2)
    again = fd.flash_decode(q, kq, vq, lengths, k_scale=ks, v_scale=vs)
    assert torch.equal(out, again)


@pytest.mark.gpu
def test_flash_decode_length_zero_gives_zero_with_splits(cuda):
    rng = np.random.default_rng(12)
    q = _t(rng, (2, 4, 64), cuda)
    k, v = (_t(rng, (2, 2000, 1, 64), cuda) for _ in range(2))
    assert fd.split_plan(2, 1, 2000, 64)[0] > 1
    lengths = torch.tensor([0, 1200], device=cuda)
    out = fd.flash_decode(q, k, v, lengths)
    assert float(out[0].abs().max()) == 0.0
    want = ref.decode_ref(q, k, v, lengths)
    assert _err(out[1], want[1]) < 3e-5


@pytest.mark.gpu
def test_attention_row_masked_in_first_tile_is_finite(cuda):
    """Causal + window with S < T: some rows' first live tile is fully
    masked for them; finite NEG_INF keeps them finite and right."""
    rng = np.random.default_rng(7)
    q = _t(rng, (1, 1, 64, 64), cuda)
    k, v = (_t(rng, (1, 1, 256, 64), cuda) for _ in range(2))
    out = fa.flash_attention(q, k, v, causal=True, window=10)
    assert bool(torch.isfinite(out).all())
    want = ref.attention_ref(q, k, v, causal=True, window=10)
    assert _err(out, want) < 3e-5
