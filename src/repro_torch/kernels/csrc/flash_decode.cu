// GQA flash decode (one new token against a KV cache) for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package's
// src/repro/kernels/flash_decode.py: flash_decode (_decode_kernel).  That
// kernel walks the cache's blocks in grid order and carries its online
// softmax (acc, m, l) in VMEM; here one block owns one (batch row, KV head)
// and walks the cache in a loop, so the carry stays in shared memory.
//
// Shapes (row-major, contiguous): q, out (B, H, D); k, v (B, T, KV, D);
// k_scale, v_scale (B, T, KV) float32 for an int8 cache; lengths (B,) int32.
// q is float32 or bfloat16; the cache is q's type or int8.  G = H / KV query
// heads share each cache head, q head kv*G + g reading cache head kv, as
// the JAX kernel groups them.  Scores, softmax and sums are float32; out is
// in q's type.
//
// What bounds it on the card: bytes.  Every live key and value is read once
// and used for G heads: about 2G flops per byte of a float32 cache (4G for
// int8), below the ~20 flops/byte float32 ridge for every G <= 16 taken
// here, so the least time is the cache bytes of the live prefix over
// 3.35 TB/s.  What the design does about it:
//   * The cache is never repeated per query head: a block reads each of its
//     KV head's key/value rows once, for all G heads (q sits in shared
//     memory, pre-loaded once).
//   * An int8 cache is read as int8 and dequantised in registers with its
//     (t, kv) scale: the stream stays at 1 byte per element.
//   * Tiles of 256 keys (one per thread for the scores), then an online
//     softmax in float32 with m, l and the (G, D) accumulator in shared
//     memory.  Tiles at or beyond the row's length are not visited, as the
//     TPU kernel skips blocks with base >= length.
//   * NEG_INF is the finite -1e30 of the JAX kernel.  The first tile always
//     holds a live key, so the running max is finite from the start and a
//     masked score's exp(-1e30 - m) is exactly 0.
//   * lengths == 0: every tile is skipped and out is 0 (acc / max(l, 1e-30)),
//     as in the TPU kernel; the plain decode_ref instead returns the mean of
//     v (softmax of all-masked scores).  Callers pass lengths >= 1.
// One block per (b, kv) is only B*KV blocks (64 at qwen3-0.6b's B=8, KV=8,
// on 132 SMs): the card is under-filled, and a split over T with a second,
// fixed-order combine pass is the next step.  No atomics: results are the
// same from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;  // keys per tile, one per thread for scores
constexpr int kMaxG = 16;
constexpr float kNegInf = -1e30f;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // lane 0 holds the sum
}

// ks, vs are null for a float cache.
template <typename Q, typename KVT>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const Q* __restrict__ q, const KVT* __restrict__ k,
                  const KVT* __restrict__ v, const float* __restrict__ ks,
                  const float* __restrict__ vs,
                  const int* __restrict__ lengths, Q* __restrict__ out, int T,
                  int KV, int G, int D, float scale) {
  extern __shared__ float smem[];  // q | acc (G, D) | p (G, kTile) | m, l, alpha (G)
  const int GD = G * D;
  float* q_s = smem;
  float* acc_s = q_s + GD;
  float* p_s = acc_s + GD;
  float* m_s = p_s + G * kTile;
  float* l_s = m_s + G;
  float* al_s = l_s + G;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t H = (size_t)KV * G;
  const size_t head0 = ((size_t)b * H + (size_t)kvh * G) * D;  // q/out heads kvh*G..

  for (int i = tid; i < GD; i += kThreads) {
    q_s[i] = to_f32(q[head0 + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int len = min(lengths[b], T);
  const size_t row = (size_t)KV * D;  // elements between cache rows t, t+1
  const size_t cache0 = (size_t)b * T * row + (size_t)kvh * D;
  const size_t scale0 = (size_t)b * T * KV + kvh;

  for (int base = 0; base < len; base += kTile) {
    const int n = min(kTile, len - base);  // live keys in this tile

    // scores: thread j takes key base + j for all G heads
    {
      float s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
      if (tid < n) {
        const KVT* kr = k + cache0 + (size_t)(base + tid) * row;
        for (int d = 0; d < D; ++d) {
          const float kd = to_f32(kr[d]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) s[g] += q_s[g * D + d] * kd;
        }
        const float sc =
            ks ? ks[scale0 + (size_t)(base + tid) * KV] * scale : scale;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) p_s[g * kTile + tid] = s[g] * sc;
      } else {
        for (int g = 0; g < G; ++g) p_s[g * kTile + tid] = kNegInf;
      }
    }
    __syncthreads();

    // online softmax statistics, one warp per head
    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * kTile;
      float mx = kNegInf;
      for (int j = lane; j < kTile; j += 32) mx = fmaxf(mx, pg[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        const float e = expf(pg[j] - m_new);
        pg[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        al_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v, one (head, d) pair per thread at a time
    for (int i = tid; i < GD; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = p_s + g * kTile;
      const KVT* vc = v + cache0 + (size_t)base * row + d;
      float s = 0.f;
      if (vs) {
        const float* vsc = vs + scale0 + (size_t)base * KV;
        for (int j = 0; j < n; ++j)
          s += pg[j] * (to_f32(vc[(size_t)j * row]) * vsc[(size_t)j * KV]);
      } else {
        for (int j = 0; j < n; ++j) s += pg[j] * to_f32(vc[(size_t)j * row]);
      }
      acc_s[i] = acc_s[i] * al_s[g] + s;
    }
    __syncthreads();
  }

  for (int i = tid; i < GD; i += kThreads)
    out[head0 + i] = from_f32<Q>(acc_s[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename Q, typename KVT>
cudaError_t decode_impl(const void* q, const void* k, const void* v,
                        const void* ks, const void* vs, const void* lengths,
                        void* out, int B, int KV, int G, int T, int D,
                        cudaStream_t s) {
  const size_t smem =
      (size_t)(2 * G * D + G * kTile + 3 * G) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<Q, KVT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  decode_kernel<Q, KVT><<<dim3(KV, B), kThreads, smem, s>>>(
      static_cast<const Q*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lengths),
      static_cast<Q*>(out), T, KV, G, D, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  q_dtype: 0 = float32, 1 = bfloat16;
// kv_dtype: 0 = float32, 1 = bfloat16, 2 = int8 (k_scale/v_scale given,
// else they are null).  Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* lengths, void* out, int B,
                                   int H, int KV, int T, int D, int q_dtype,
                                   int kv_dtype, int device, void* stream) {
  if (B < 1 || KV < 1 || H < KV || H % KV != 0 || H / KV > kMaxG || T < 1 ||
      D < 1 || B > 65535 || KV > 65535)
    return cudaErrorInvalidValue;
  const bool quant = kv_dtype == 2;
  if (quant != (k_scale != nullptr && v_scale != nullptr))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
#define DECODE(QT, KT) \
  decode_impl<QT, KT>(q, k, v, k_scale, v_scale, lengths, out, B, KV, G, T, D, s)
  if (q_dtype == 0 && kv_dtype == 0) return DECODE(float, float);
  if (q_dtype == 1 && kv_dtype == 1) return DECODE(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 0 && kv_dtype == 2) return DECODE(float, int8_t);
  if (q_dtype == 1 && kv_dtype == 2) return DECODE(__nv_bfloat16, int8_t);
#undef DECODE
  return cudaErrorInvalidValue;
}
