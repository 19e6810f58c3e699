// RG-LRU linear scan h_t = a_t * h_{t-1} + b_t (h_{-1} = 0) for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package's
// src/repro/kernels/rglru_scan.py: rglru_scan_kernel (_rglru_kernel).  That
// kernel walks the time blocks in grid order and carries a (1, bc) state in
// VMEM; CUDA runs blocks in no order, so here the carry stays inside one
// block.
//
// Shapes (row-major, contiguous): a, b, h (B, S, C); float32 or bfloat16,
// the state and all arithmetic in float32, h written in a's type.  S and C
// need not be multiples of anything: the ragged edges are masked.
//
// What bounds it on the card: bytes.  It does 2 flops per element read
// (a, b) and written (h), far below the ~20 float32 flops/byte ridge, so
// the least time is 3 * B*S*C * elem bytes over 3.35 TB/s.  The risk is
// latency: one thread per channel, sequential in S, gives only B*C threads
// (5,120 at recurrentgemma-2b width), too few to keep HBM busy.  What the
// design does about it: a two-pass chunked scan inside one block of 32
// channels x 16 warps.  Warp w owns time chunk w: pass 1 composes its
// chunk's affine map (A_w = prod a, B_w = the chunk's scan from 0) into
// shared memory; after a __syncthreads each warp composes the earlier
// chunks' maps in order to get its carry-in (at most 15 steps), then pass 2
// runs its chunk again from that carry and writes h.  That is 16x the
// threads of the plain design at the price of reading a and b twice (the
// second read of a chunk comes soon after the first and mostly hits L2).
// Lanes run over consecutive channels, so every load and store is
// coalesced.  No atomics: results are the same from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kChannels = 32;  // one warp's lanes, consecutive channels
constexpr int kChunks = 16;    // warps per block, one time chunk each
constexpr int kThreads = kChannels * kChunks;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ h, int S, int C) {
  __shared__ float sA[kChunks][kChannels];
  __shared__ float sB[kChunks][kChannels];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int c = blockIdx.x * kChannels + lane;
  const bool live = c < C;
  const int len = (S + kChunks - 1) / kChunks;
  const int t0 = min(w * len, S);
  const int t1 = min(t0 + len, S);
  const size_t base = (size_t)blockIdx.y * S * C + c;

  // pass 1: this chunk's affine map h -> A h + B
  float ca = 1.f, cb = 0.f;
  if (live) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) {
      const float at = to_f32(a[base + (size_t)t * C]);
      const float bt = to_f32(b[base + (size_t)t * C]);
      ca *= at;
      cb = at * cb + bt;
    }
  }
  sA[w][lane] = ca;
  sB[w][lane] = cb;
  __syncthreads();
  if (!live) return;

  // carry-in: the earlier chunks' maps composed in order from h = 0
  float hv = 0.f;
  for (int k = 0; k < w; ++k) hv = sA[k][lane] * hv + sB[k][lane];

  // pass 2: the recurrence again from the carry, writing h
#pragma unroll 8
  for (int t = t0; t < t1; ++t) {
    const size_t i = base + (size_t)t * C;
    hv = to_f32(a[i]) * hv + to_f32(b[i]);
    h[i] = from_f32<T>(hv);
  }
}

template <typename T>
cudaError_t rglru_impl(const void* a, const void* b, void* h, int B, int S,
                       int C, cudaStream_t s) {
  const dim3 grid((C + kChannels - 1) / kChannels, B);
  rglru_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(a),
                                            static_cast<const T*>(b),
                                            static_cast<T*>(h), S, C);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int rglru_scan_launch(const void* a, const void* b, void* h, int B,
                                 int S, int C, int dtype, int device,
                                 void* stream) {
  if (B < 1 || S < 1 || C < 1 || B > 65535 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? rglru_impl<float>(a, b, h, B, S, C, s)
                    : rglru_impl<__nv_bfloat16>(a, b, h, B, S, C, s);
}
