// Mamba2 SSD scan (single group) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package's
// src/repro/kernels/ssd_scan.py: ssd_scan (_ssd_kernel).  That kernel walks
// the chunks in grid order with the (P, N) state in VMEM scratch, and per
// chunk does the quadratic intra-chunk form on the MXU.  This kernel
// computes the same function by its per-step recurrence, the form of the
// plain ssd_ref:
//   state_t = exp(dt_t A) state_{t-1} + dt_t x_t B_t^T,   y_t = state_t C_t
// per (batch, head), with state_{-1} = 0.
//
// Shapes (row-major, contiguous, float32): x, y (b, s, h, p); dt (b, s, h);
// A (h,); B, C (b, s, n); final state (b, h, p, n).  p <= 64, n <= 128; s
// need not be a multiple of the chunk.
//
// What bounds it on the card: operations, by a small margin.  Per (b, h,
// step) it does 5 p n flops (state decay and update, 3; y, 2) on at most
// p + 2n + 1 input floats: at p = 64, n = 128 some 40k flops on 1.3 KB, 32
// flops per byte or more (B and C serve every head), above the ~20 float32
// flops/byte ridge, so the least time is 5 b s h p n flops over
// 67 TFLOP/s.  What the design does about it:
//   * One block per (b, h), 256 threads: 4 threads per row of the state,
//     each holding 32 of its n entries in registers for the whole scan, so
//     the state never leaves registers (the TPU kernel's VMEM carry).  y_t
//     is a sum over n: 4 register partials, then two shuffles.
//   * Inputs are staged through shared memory 16 steps at a time, so the
//     sequential loop reads only shared memory; B and C are read once per
//     (b, h) from their (b, s, n) layout (the JAX wrapper broadcasts them to
//     every head first).  y is staged and written back row by row,
//     coalesced.
//   * No exp of a positive number can occur (the TPU kernel's exp(cum_i -
//     cum_j) with j > i can overflow to inf and, times 0, give NaN in CUDA;
//     the per-step form only takes exp(dt A) with dt A <= 0).
//   * At mamba2-1.3b (b = 2, h = 64) that is 128 blocks, one wave on 132
//     SMs; the sequential chain per step (smem loads, 8 dependent FMAs, two
//     shuffles) sets the time, not the bandwidth.  The chunked (matmul) form
//     on the tensor cores is the later, faster design.
// No atomics: results are the same from run to run.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;         // threads per state row
constexpr int kMaxP = kThreads / kLanes;
constexpr int kMaxN = 128;
constexpr int kPerThread = kMaxN / kLanes;
constexpr int kSteps = 16;        // steps staged per pass

__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, float* __restrict__ y,
               float* __restrict__ fs, int S, int H, int P, int N) {
  __shared__ float xs[kSteps * kMaxP];
  __shared__ float ys[kSteps * kMaxP];
  __shared__ float bs[kSteps * kMaxN];
  __shared__ float cs[kSteps * kMaxN];
  __shared__ float dts[kSteps];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int row = tid / kLanes;  // p index
  const int g = tid % kLanes;    // owns n = g + kLanes * k
  const bool live = row < P;
  const float a_h = A[h];

  float st[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) st[k] = 0.f;

  for (int c0 = 0; c0 < S; c0 += kSteps) {
    const int len = min(kSteps, S - c0);
    for (int i = tid; i < len * P; i += kThreads) {
      const int r = i / P;
      xs[r * kMaxP + (i - r * P)] =
          x[(((size_t)b * S + c0 + r) * H + h) * P + (i - r * P)];
    }
    for (int i = tid; i < len * N; i += kThreads) {
      const int r = i / N;
      const size_t src = ((size_t)b * S + c0 + r) * N + (i - r * N);
      bs[r * kMaxN + (i - r * N)] = Bm[src];
      cs[r * kMaxN + (i - r * N)] = Cm[src];
    }
    for (int i = tid; i < len; i += kThreads)
      dts[i] = dt[((size_t)b * S + c0 + i) * H + h];
    __syncthreads();

    for (int r = 0; r < len; ++r) {
      const float d = dts[r];
      const float decay = expf(d * a_h);
      const float xdt = live ? xs[r * kMaxP + row] * d : 0.f;
      const float* br = bs + r * kMaxN;
      const float* cr = cs + r * kMaxN;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int n = g + kLanes * k;
        if (n < N) {
          st[k] = st[k] * decay + xdt * br[n];
          part[k & 3] += cr[n] * st[k];
        }
      }
      float yv = (part[0] + part[1]) + (part[2] + part[3]);
      yv += __shfl_xor_sync(0xffffffffu, yv, 1);
      yv += __shfl_xor_sync(0xffffffffu, yv, 2);
      if (live && g == 0) ys[r * kMaxP + row] = yv;
    }
    __syncthreads();

    for (int i = tid; i < len * P; i += kThreads) {
      const int r = i / P;
      y[(((size_t)b * S + c0 + r) * H + h) * P + (i - r * P)] =
          ys[r * kMaxP + (i - r * P)];
    }
  }

  if (live) {
    float* out = fs + (((size_t)b * H + h) * P + row) * N;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int n = g + kLanes * k;
      if (n < N) out[n] = st[k];
    }
  }
}

}  // namespace

// C interface, loaded with ctypes.  float32 only.  Returns the cudaError_t
// of the launch (0 = launched).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               void* final_state, int batch, int S, int H,
                               int P, int N, int device, void* stream) {
  if (batch < 1 || batch > 65535 || S < 1 || H < 1 || P < 1 || P > kMaxP ||
      N < 1 || N > kMaxN)
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  ssd_kernel<<<dim3(H, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y),
      static_cast<float*>(final_state), S, H, P, N);
  return cudaGetLastError();
}
