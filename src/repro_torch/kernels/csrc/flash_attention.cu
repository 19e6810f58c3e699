// Flash attention (forward) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package's
// src/repro/kernels/flash_attention.py: flash_attention (_flash_kernel).
// That kernel walks the kv blocks in grid order and carries its online
// softmax (acc, m, l) in VMEM scratch; here one block owns one (batch*head,
// 64-query tile) and walks the kv tiles in a loop, with the carry in
// registers.
//
// Shapes (row-major, contiguous): q, out (B, H, S, D); k, v (B, H, T, D);
// float32 or bfloat16, every product and sum in float32, out in q's type.
// D <= 256; S, T and D need not be multiples of anything (ragged tiles are
// masked, nothing is padded in memory).  Queries are right-aligned: query
// i sits at position i + T - S.  causal keeps k <= q; window > 0 keeps
// k > q - window (with or without causal).
//
// What bounds it on the card: operations.  It does 4*S*T*D flops per head
// (half that under a causal mask) on 2*(S+T)*D elements: hundreds of flops
// per byte at S = T = 4096.  The least time is the flops over the tensor
// cores' peak (989 TFLOP/s bf16) or, for float32, the 67 TFLOP/s of the
// CUDA cores.  This first kernel runs on the CUDA cores in float32 for both
// types (no wgmma, no TMA), so it sits far from the bf16 bound; what its
// design does about the work it has:
//   * Q (64 x D), K and V tiles (64 x D) and P (64 x 64) live in shared
//     memory as float32 with an odd row stride, so the 16 x 16 threads' reads
//     are free of bank conflicts; each thread computes a 4 x 4 block of
//     scores (rows ty + 16i, columns tx + 16j) and owns 4 rows x ceil(D/16)
//     columns of the output accumulator in registers.
//   * kv tiles that the causal or window test kills for every row of the
//     query tile are not loaded at all (flash_attention.py:46-54).
//   * NEG_INF is the finite -1e30 of the JAX kernel, so a row whose first
//     live tile is fully masked (m = -1e30) is wiped by the next real tile
//     through alpha = exp(m_prev - m_new) = 0 instead of turning into NaN.
//     Columns past T (the ragged tail, which the TPU kernel never has) get
//     -inf, so they add exactly 0 even to such a row.
//   * Shared memory above 48 KB (73 KB at D = 72, 116 KB at 128, 214 KB at
//     256) is dynamic, set with cudaFuncSetAttribute.
// No atomics: results are the same from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPS = kBK + 1;   // P row stride
constexpr float kNegInf = -1e30f;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Reductions over the 16 lanes (tx) that share a row: lanes tx and tx ^ off
// stay in the same half-warp for off <= 8.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Odd row stride covering 16 * NJ columns.
template <int NJ>
__host__ __device__ constexpr int row_stride() {
  return (16 * NJ) | 1;
}

template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* dst,
                                          int row0, int rows, int nrows, int D,
                                          int stride) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    dst[r * stride + d] =
        row0 + r < nrows ? to_f32(src[(size_t)(row0 + r) * D + d]) : 0.f;
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int Tn,
                 int D, int causal, int window, float scale) {
  constexpr int DP = row_stride<NJ>();
  extern __shared__ float smem[];  // Q (BQ, DP) | K (BK, DP) | V (BK, DP) | P (BQ, kPS)
  float* Qs = smem;
  float* Ks = Qs + kBQ * DP;
  float* Vs = Ks + kBK * DP;
  float* Ps = Vs + kBK * DP;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + bh * S * D;
  const T* kb = k + bh * Tn * D;
  const T* vb = v + bh * Tn * D;

  load_tile(qb, Qs, q0, kBQ, S, D, DP);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  const int off = Tn - S;  // right-aligned query positions
  const int q_min = q0 + off;
  const int q_max = min(q0 + kBQ, S) - 1 + off;
  const int nk = (Tn + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    const int k_max = min(k0 + kBK, Tn) - 1;
    // block-level skip: is any (q, k) pair of this tile alive?
    if (causal && k0 > q_max) break;  // and so is every later tile
    if (window && k_max <= q_min - window) continue;
    __syncthreads();  // the previous tile's K, V, P reads are done
    load_tile(kb, Ks, k0, kBK, Tn, D, DP);
    load_tile(vb, Vs, k0, kBK, Tn, D, DP);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i + off;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = true;
        if (causal) ok = ok && kp <= qp;
        if (window) ok = ok && kp > qp - window;
        const float x = kp >= Tn ? -INFINITY : (ok ? s[i][j] * scale : kNegInf);
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * kPS + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    const int kn = min(kBK, Tn - k0);
    for (int c = 0; c < kn; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float vv = Vs[c * DP + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] += pv[i] * vv;
      }
    }
  }

  T* ob = out + bh * S * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < D) ob[(size_t)r * D + d] = from_f32<T>(acc[i][jj] * inv);
    }
  }
}

template <typename T, int NJ>
cudaError_t flash_impl(const void* q, const void* k, const void* v, void* out,
                       int BH, int S, int Tn, int D, int causal, int window,
                       cudaStream_t s) {
  constexpr int DP = row_stride<NJ>();
  const size_t smem = (size_t)((kBQ + 2 * kBK) * DP + kBQ * kPS) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_kernel<T, NJ><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tn, D, causal, window,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t flash_dispatch(const void* q, const void* k, const void* v,
                           void* out, int BH, int S, int Tn, int D, int causal,
                           int window, cudaStream_t s) {
#define FLASH(NJ) flash_impl<T, NJ>(q, k, v, out, BH, S, Tn, D, causal, window, s)
  if (D <= 32) return FLASH(2);
  if (D <= 64) return FLASH(4);
  if (D <= 80) return FLASH(5);
  if (D <= 128) return FLASH(8);
  if (D <= 256) return FLASH(16);
#undef FLASH
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH, int S,
                                      int Tn, int D, int causal, int window,
                                      int dtype, int device, void* stream) {
  if (BH < 1 || BH > 65535 || S < 1 || Tn < 1 || D < 1 || D > 256 ||
      window < 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? flash_dispatch<float>(q, k, v, out, BH, S, Tn, D, causal,
                                            window, s)
                    : flash_dispatch<__nv_bfloat16>(q, k, v, out, BH, S, Tn, D,
                                                    causal, window, s);
}
