"""Port parity for the model kernels' entry points — flash attention, GQA
flash decode (int8 cache included), the Mamba2 SSD scan and the RG-LRU
scan: the port's plain versions and ``repro_torch.kernels.ops`` on the CPU
against the JAX package's references and its Pallas kernels in interpret
mode, on the same numpy inputs, with the JAX tests' tolerances.  Also the
wrappers' validation, which runs on the CPU up to the device check.  The
CUDA kernels themselves are tested on the card by
tests/test_torch_cuda_model_kernels.py."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_decode import flash_decode as jdecode
from repro.kernels.rglru_scan import rglru_scan_kernel as jrglru
from repro.kernels.ssd_scan import ssd_scan as jssd
from repro.models.attention import _dequantize_kv, _quantize_kv
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ssd
from tests.test_torch_helpers import _tol, both, max_abs, normal, rel_err

DTYPES = ["float32", "bfloat16"]
KERNEL_MODULES = [fa, fd, ssd, rg]


def _t(a, dtype="float32"):
    return both(a, dtype)[1]


def _j(a, dtype="float32"):
    return both(a, dtype)[0]


@pytest.mark.parametrize("shape", [(1, 2, 128, 128, 32), (1, 1, 64, 192, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 50), (False, 0),
                                           (False, 40)])
def test_attention_matches_jax_ref_and_pallas(shape, dtype, causal, window):
    b, h, s, t, d = shape
    q, k, v = (normal(0, b, h, s, d), normal(1, b, h, t, d),
               normal(2, b, h, t, d))
    got = tref.attention_ref(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                             causal=causal, window=window)
    via_ops = tops.attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                             causal=causal, window=window)
    assert got.dtype == via_ops.dtype == _t(q, dtype).dtype
    assert torch.equal(got, via_ops)
    jq, jk, jv = _j(q, dtype), _j(k, dtype), _j(v, dtype)
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    kern = jflash(jq, jk, jv, causal=causal, window=window, bq=64, bk=64,
                  interpret=True)
    tol = _tol(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert max_abs(got, want) < tol
    assert max_abs(got, kern) < tol


def test_attention_ops_matches_jax_ops_and_window_changes_output():
    q, k, v = (normal(s, 1, 2, 128, 64) for s in (3, 4, 5))
    got = tops.attention(_t(q), _t(k), _t(v), causal=True, window=32)
    want = jops.attention(_j(q), _j(k), _j(v), causal=True, window=32,
                          use_pallas=True, interpret=True)
    assert max_abs(got, want) < 3e-5
    full = tops.attention(_t(q), _t(k), _t(v), causal=True, window=0)
    assert max_abs(full, got) > 1e-3


def _decode_inputs(shape, seed=0):
    b, h, kv, t, d = shape
    q, k, v = normal(seed, b, h, d), normal(seed + 1, b, t, kv, d), \
        normal(seed + 2, b, t, kv, d)
    lengths = np.random.default_rng(seed).integers(1, t + 1, size=b)
    lengths[0] = t
    return q, k, v, lengths


@pytest.mark.parametrize("shape", [(2, 8, 4, 256, 32), (3, 4, 1, 256, 64),
                                   (2, 8, 8, 128, 16)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_jax_ref_and_pallas(shape, dtype):
    """GQA, MQA and plain multi-head, ragged lengths in [1, T]."""
    q, k, v, lengths = _decode_inputs(shape)
    got = tref.decode_ref(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                          torch.from_numpy(lengths))
    via_ops = tops.decode_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                    torch.from_numpy(lengths))
    assert got.dtype == _t(q, dtype).dtype and torch.equal(got, via_ops)
    jq, jk, jv, jl = _j(q, dtype), _j(k, dtype), _j(v, dtype), \
        jnp.asarray(lengths)
    tol = _tol(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert max_abs(got, jref.decode_ref(jq, jk, jv, jl)) < tol
    assert max_abs(got, jdecode(jq, jk, jv, jl, bk=128, interpret=True)) < tol
    assert max_abs(got, jops.decode_attention(jq, jk, jv, jl, use_pallas=False)
                   ) < tol


def test_int8_decode_oracle_matches_jax_kernel_and_oracle():
    """The int8 cache: the port quantises as the JAX package does, and its
    dequantise-then-decode oracle meets the Pallas int8 kernel within the
    JAX test's 2e-5 (tests/test_kv_quant.py)."""
    q, k, v, _ = _decode_inputs((2, 8, 4, 512, 64), seed=4)
    lengths = np.array([300, 512])
    kq, ks = tref.quantize_kv(_t(k))
    vq, vs = tref.quantize_kv(_t(v))
    jkq, jks = _quantize_kv(_j(k))
    jvq, jvs = _quantize_kv(_j(v))
    assert np.array_equal(kq.numpy(), np.asarray(jkq))
    assert np.array_equal(vq.numpy(), np.asarray(jvq))
    assert max_abs(ks, jks) == 0.0 and max_abs(vs, jvs) == 0.0
    got = tref.decode_int8_ref(_t(q), kq, vq, torch.from_numpy(lengths), ks,
                               vs)
    jl = jnp.asarray(lengths)
    kern = jdecode(_j(q), jkq, jvq, jl, k_scale=jks, v_scale=jvs, bk=256,
                   interpret=True)
    want = jref.decode_ref(_j(q), _dequantize_kv(jkq, jks, jnp.float32),
                           _dequantize_kv(jvq, jvs, jnp.float32), jl)
    assert max_abs(got, kern) < 2e-5
    assert max_abs(got, want) < 2e-5


def _ssd_inputs(shape, seed=0):
    b, s, h, p, n = shape
    x = normal(seed, b, s, h, p, scale=0.5)
    dt = np.log1p(np.exp(normal(seed + 1, b, s, h))).astype(np.float32)
    A = (-np.exp(normal(seed + 2, h, scale=0.3))).astype(np.float32)
    B = normal(seed + 3, b, s, n, scale=0.5)
    C = normal(seed + 4, b, s, n, scale=0.5)
    return x, dt, A, B, C


@pytest.mark.parametrize("shape,chunk", [((2, 128, 2, 16, 32), 64),
                                         ((1, 64, 3, 32, 64), 32)])
def test_ssd_matches_jax_ref_and_pallas(shape, chunk):
    arrs = _ssd_inputs(shape)
    y, fs = tref.ssd_ref(*(_t(a) for a in arrs))
    y_ops, fs_ops = tops.ssd(*(_t(a) for a in arrs), chunk=chunk)
    assert y.dtype == fs.dtype == torch.float32
    assert torch.equal(y, y_ops) and torch.equal(fs, fs_ops)
    jarrs = [_j(a) for a in arrs]
    yr, fsr = jref.ssd_ref(*jarrs)
    yk, fsk = jssd(*jarrs, chunk=chunk, interpret=True)
    for mine, theirs in ((y, yr), (fs, fsr), (y, yk), (fs, fsk)):
        assert rel_err(mine, theirs) < 1e-4


def test_ssd_ref_init_state_matches_jax():
    x, dt, A, B, C = _ssd_inputs((1, 40, 2, 8, 16), seed=7)
    init = normal(9, 1, 2, 8, 16)
    y, fs = tref.ssd_ref(*(_t(a) for a in (x, dt, A, B, C)),
                         init_state=_t(init))
    yr, fsr = jref.ssd_ref(*(_j(a) for a in (x, dt, A, B, C)),
                           init_state=_j(init))
    assert rel_err(y, yr) < 1e-4 and rel_err(fs, fsr) < 1e-4


@pytest.mark.parametrize("shape,bt,bc", [((2, 256, 128), 128, 128),
                                         ((3, 128, 128), 64, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_matches_jax_ref_and_pallas(shape, bt, bc, dtype):
    a = (1.0 / (1.0 + np.exp(-normal(0, *shape)))).astype(np.float32)
    b = normal(1, *shape, scale=0.3)
    got = tref.rglru_ref(_t(a, dtype), _t(b, dtype))
    via_ops = tops.rglru(_t(a, dtype), _t(b, dtype))
    assert got.dtype == torch.float32 and torch.equal(got, via_ops)
    ja, jb = _j(a, dtype), _j(b, dtype)
    tol = 5e-2 if dtype == "bfloat16" else 1e-4
    assert max_abs(got, jref.rglru_ref(ja, jb)) < 1e-4   # both float32
    assert max_abs(got, jrglru(ja, jb, bt=bt, bc=bc, interpret=True)) < tol


def test_rglru_ref_h0_matches_jax():
    a = (1.0 / (1.0 + np.exp(-normal(2, 2, 50, 24)))).astype(np.float32)
    b, h0 = normal(3, 2, 50, 24, scale=0.3), normal(4, 2, 24)
    got = tref.rglru_ref(_t(a), _t(b), h0=_t(h0))
    assert max_abs(got, jref.rglru_ref(_j(a), _j(b), h0=_j(h0))) < 1e-4


# --- the wrappers on the CPU: validation up to the device check -------------


def test_ops_on_cpu_tensors_launch_and_build_nothing():
    for mod in KERNEL_MODULES:
        mod.reset_launches()
    q, k, v = (torch.from_numpy(normal(s, 1, 2, 16, 8)) for s in (0, 1, 2))
    tops.attention(q, k, v)
    tops.decode_attention(q[:, :, 0], k.transpose(1, 2), v.transpose(1, 2),
                          torch.tensor([5]))
    tops.ssd(*(_t(a) for a in _ssd_inputs((1, 8, 2, 4, 8))))
    tops.rglru(q[0], k[0])
    for mod in KERNEL_MODULES:
        assert set(mod.launches.values()) == {0}, mod.__name__
        assert mod._lib.cache_info().currsize == 0, mod.__name__
    assert fa._lib_tc.cache_info().currsize == 0


def test_ops_refuse_other_devices():
    """A device with neither a kernel nor a plain path raises (a ``meta``
    tensor takes the plain path since the dry-run counts on it:
    tests/test_torch_use_pallas.py)."""
    other = SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no kernel or plain path"):
        tops.attention(other, other, other)


CUDA = "one CUDA device"


def test_flash_attention_wrapper_validates_then_refuses_cpu():
    q, k = torch.zeros(2, 3, 10, 72), torch.zeros(2, 3, 20, 72)
    with pytest.raises(ValueError, match=CUDA):
        fa.flash_attention(q, k, k, causal=False, window=5)
    with pytest.raises(ValueError, match=CUDA):
        fa.flash_attention(q.bfloat16(), k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="alike"):
        fa.flash_attention(q, k, k[:, :, :-1])
    with pytest.raises(ValueError, match="head dim"):
        wide = torch.zeros(1, 1, 4, 300)
        fa.flash_attention(wide, wide, wide)
    with pytest.raises(TypeError, match="dtypes"):
        fa.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, k, window=-1)
    with pytest.raises(ValueError, match="contiguous"):
        strided = q.transpose(2, 3).contiguous().transpose(2, 3)
        fa.flash_attention(strided, k, k)
    assert fa.launches["flash_attention"] == 0
    assert fa._lib.cache_info().currsize == 0


def test_flash_decode_wrapper_validates_then_refuses_cpu():
    q, k = torch.zeros(2, 8, 64), torch.zeros(2, 100, 4, 64)
    lengths = torch.tensor([3, 100])
    with pytest.raises(ValueError, match=CUDA):
        fd.flash_decode(q, k, k, lengths)                   # int64 -> int32
    kq, ks = tref.quantize_kv(k)
    with pytest.raises(ValueError, match=CUDA):
        fd.flash_decode(q, kq, kq, lengths, k_scale=ks, v_scale=ks)
    with pytest.raises(ValueError, match="needs k_scale"):
        fd.flash_decode(q, kq, kq, lengths)
    with pytest.raises(ValueError, match="scales must be"):
        fd.flash_decode(q, kq, kq, lengths, k_scale=ks[:, :-1], v_scale=ks)
    with pytest.raises(ValueError, match="int8 cache only"):
        fd.flash_decode(q, k, k, lengths, k_scale=ks, v_scale=ks)
    with pytest.raises(TypeError, match="neither"):
        fd.flash_decode(q, k.bfloat16(), k.bfloat16(), lengths)
    with pytest.raises(ValueError, match="multiple G"):
        fd.flash_decode(torch.zeros(2, 6, 64), k, k, lengths)
    with pytest.raises(ValueError, match="lengths"):
        fd.flash_decode(q, k, k, lengths.float())
    with pytest.raises(ValueError, match="alike"):
        fd.flash_decode(q, k, k[:, :-1], lengths)
    assert fd.launches["flash_decode"] == 0
    assert fd._lib.cache_info().currsize == 0


def test_ssd_scan_wrapper_validates_then_refuses_cpu():
    x, dt, A, B, C = (_t(a) for a in _ssd_inputs((1, 20, 2, 64, 128)))
    with pytest.raises(ValueError, match=CUDA):
        ssd.ssd_scan(x, dt, A, B, C, chunk=256)
    with pytest.raises(ValueError, match="dt must be"):
        ssd.ssd_scan(x, dt[:, :-1], A, B, C)
    with pytest.raises(ValueError, match=r"p=\d+, n=\d+"):
        ssd.ssd_scan(torch.zeros(1, 20, 2, 65), dt, A, B, C)
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_scan(x.double(), dt, A, B, C)
    assert ssd.launches["ssd_scan"] == 0
    assert ssd._lib.cache_info().currsize == 0


def test_rglru_scan_wrapper_validates_then_refuses_cpu():
    a = torch.zeros(2, 30, 40)
    with pytest.raises(ValueError, match=CUDA):
        rg.rglru_scan_kernel(a, a, bt=8, bc=8)
    with pytest.raises(ValueError, match=CUDA):
        rg.rglru_scan_kernel(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match=r"\(B, S, C\)"):
        rg.rglru_scan_kernel(a, a[:, :-1])
    with pytest.raises(TypeError, match="bfloat16"):
        rg.rglru_scan_kernel(a, a.bfloat16())
    assert rg.launches["rglru_scan"] == 0
    assert rg._lib.cache_info().currsize == 0

