// Anderson/TAA update kernels for NVIDIA Hopper (sm_90a), lane axis native.
//
// Replaces the Pallas TPU kernels of the JAX package's
// src/repro/kernels/taa_update.py:
//   taa_gram   <- taa_gram  (_gram_kernel)
//   taa_apply  <- taa_apply (_apply_kernel)
//   taa_round  <- taa_round (_round_kernel + _gauss_jordan)
//
// Shapes (row-major, contiguous): dF, dX (B, m, T, D); x, R, out (B, T, D);
// mask, guard (B, T) float32; gamma (B, T, m) float32; G (B, T, m, m);
// u (B, T, m).  Inputs float32 or bfloat16, accumulation in float32,
// output in x's type.  1 <= m <= 8 (templated).  D need not be a multiple
// of anything: threads stride over it and the edge is simply not visited.
//
// What bounds them on the card: bytes.  Each one streams the (m, T, D)
// histories and (T, D) rows once and does O(m^2) flops per element (about
// 2-5 flops/byte, far below the H100's ~20 f32 flops/byte ridge), so the
// least time is the bytes over 3.35 TB/s.  What the designs do about it:
//   * taa_gram: one CTA per (lane, row), threads stride over D keeping the
//     m(m+1)/2 + m partial sums in registers, then a fixed-order block
//     reduction (warp shuffles, then shared memory, no float atomics) so a
//     result is the same from run to run.  Rows with mask 0 skip the loads.
//   * taa_apply: one streaming pass over a (lane, row, D-chunk) grid with
//     the row's gamma in registers; masked-off rows copy x and never read
//     the histories.
//   * taa_round: the Pallas kernel relies on the TPU running its (2, T,
//     d_blocks) grid in order so the Gram phase ends before the solve;
//     CUDA does not order CTAs, so this kernel gives each lane ONE CTA that
//     runs the Gram sweep (block reduction per row into shared G[T][m][m],
//     u[T][m]), a __syncthreads, the T suffix/global-sum + ridge +
//     pivot-free Gauss-Jordan solves (one thread per row), another
//     __syncthreads, and the apply sweep.  One launch per round; the cost
//     is one SM per lane, so it is slow at large T*D (a later change can
//     split the sweeps over a cluster or a cooperative grid).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 8;
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

// Index of (i, j), i <= j, in the row-major upper-triangle enumeration.
template <int M>
__host__ __device__ constexpr int tri(int i, int j) {
  return i * M - i * (i - 1) / 2 + (j - i);
}

// Deterministic block sum of NV per-thread values: a shuffle tree in each
// warp, then one thread per value adds the warps' partials in warp order.
// On return every thread may read out[0..NV).  All threads must call it.
template <int NV>
__device__ void block_sum(float (&v)[NV], float* scratch, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float s = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    v[k] = s;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) scratch[warp * NV + k] = v[k];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < NV; k += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += scratch[w * NV + k];
    out[k] = s;
  }
  __syncthreads();
}

// Per-thread partial Gram sums of row t of lane b over this thread's d's.
// acc[0..M(M+1)/2) holds sum f_i f_j (i <= j), acc[M(M+1)/2 + i] sum f_i r.
template <typename T, int M, int NV>
__device__ __forceinline__ void gram_partials(const T* __restrict__ dF,
                                              const T* __restrict__ R, float w,
                                              int b, int t, int Tn, int D,
                                              float (&acc)[NV]) {
  constexpr int NG = M * (M + 1) / 2;
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.f;
  if (w == 0.f) return;  // uniform over the block: the row contributes 0
  const T* r_row = R + ((size_t)b * Tn + t) * D;
  const T* f_row = dF + ((size_t)b * M * Tn + t) * D;
  const size_t hist_stride = (size_t)Tn * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float f[M];
#pragma unroll
    for (int j = 0; j < M; ++j) f[j] = to_f32(f_row[j * hist_stride + d]) * w;
    const float r = to_f32(r_row[d]) * w;
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = i; j < M; ++j) acc[tri<M>(i, j)] += f[i] * f[j];
      acc[NG + i] += f[i] * r;
    }
  }
}

// out_t = x_t + R_t - sum_j gamma_j (dX_j + dF_j)_t, for this thread's d.
template <typename T, int M>
__device__ __forceinline__ float apply_one(const T* __restrict__ x,
                                           const T* __restrict__ R,
                                           const T* __restrict__ dX,
                                           const T* __restrict__ dF,
                                           const float (&g)[M], int b, int t,
                                           int Tn, int D, int d) {
  const size_t row = ((size_t)b * Tn + t) * D + d;
  const size_t hist = ((size_t)b * M * Tn + t) * D + d;
  const size_t hist_stride = (size_t)Tn * D;
  float corr = 0.f;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const size_t h = hist + j * hist_stride;
    corr += g[j] * (to_f32(dX[h]) + to_f32(dF[h]));
  }
  return to_f32(x[row]) + to_f32(R[row]) - corr;
}

// ---------------------------------------------------------------- taa_gram
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    gram_kernel(const T* __restrict__ dF, const T* __restrict__ R,
                const float* __restrict__ mask, float* __restrict__ G,
                float* __restrict__ u, int Tn, int D) {
  constexpr int NG = M * (M + 1) / 2;
  constexpr int NV = NG + M;
  __shared__ float scratch[kWarps * NV];
  __shared__ float total[NV];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  float acc[NV];
  gram_partials<T, M, NV>(dF, R, mask[b * Tn + t], b, t, Tn, D, acc);
  block_sum<NV>(acc, scratch, total);
  float* g = G + ((size_t)b * Tn + t) * M * M;
  for (int k = threadIdx.x; k < M * M; k += kThreads) {
    const int i = k / M, j = k % M;
    g[k] = total[i <= j ? tri<M>(i, j) : tri<M>(j, i)];
  }
  for (int i = threadIdx.x; i < M; i += kThreads)
    u[((size_t)b * Tn + t) * M + i] = total[NG + i];
}

// --------------------------------------------------------------- taa_apply
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ x, const T* __restrict__ R,
                 const T* __restrict__ dX, const T* __restrict__ dF,
                 const float* __restrict__ gamma,
                 const float* __restrict__ mask, T* __restrict__ out, int Tn,
                 int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  if (d >= D) return;
  const size_t row = ((size_t)b * Tn + t) * D + d;
  if (!(mask[b * Tn + t] > 0.f)) {
    out[row] = x[row];
    return;
  }
  float g[M];
#pragma unroll
  for (int j = 0; j < M; ++j) g[j] = gamma[((size_t)b * Tn + t) * M + j];
  out[row] = from_f32<T>(apply_one<T, M>(x, R, dX, dF, g, b, t, Tn, D, d));
}

// --------------------------------------------------------------- taa_round
// mode 0 = taa (suffix Gram, suffix rhs), 1 = aa (global, global),
// 2 = aa+ (global Gram, suffix rhs).
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    round_kernel(const T* __restrict__ x, const T* __restrict__ R,
                 const T* __restrict__ dX, const T* __restrict__ dF,
                 const float* __restrict__ mask,
                 const float* __restrict__ guard, T* __restrict__ out, int Tn,
                 int D, int mode, float lam) {
  constexpr int NG = M * (M + 1) / 2;
  constexpr int NV = NG + M;
  extern __shared__ float smem[];  // G[Tn][M][M] | u[Tn][M] | gamma[Tn][M]
  float* sG = smem;
  float* su = sG + (size_t)Tn * M * M;
  float* sgam = su + (size_t)Tn * M;
  __shared__ float scratch[kWarps * NV];
  __shared__ float total[NV];
  const int b = blockIdx.x;

  // phase 0: the Gram sweep, one deterministic block reduction per row
  for (int t = 0; t < Tn; ++t) {
    float acc[NV];
    gram_partials<T, M, NV>(dF, R, mask[b * Tn + t], b, t, Tn, D, acc);
    block_sum<NV>(acc, scratch, total);
    for (int k = threadIdx.x; k < M * M; k += kThreads) {
      const int i = k / M, j = k % M;
      sG[(size_t)t * M * M + k] = total[i <= j ? tri<M>(i, j) : tri<M>(j, i)];
    }
    for (int i = threadIdx.x; i < M; i += kThreads) su[t * M + i] = total[NG + i];
  }
  __syncthreads();

  // phase 1: per-row reductions + ridge + pivot-free Gauss-Jordan
  for (int t = threadIdx.x; t < Tn; t += kThreads) {
    float A[M][M + 1];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j <= M; ++j) A[i][j] = 0.f;
    const int g_lo = mode == 0 ? t : 0;
    const int u_lo = mode == 1 ? 0 : t;
    for (int s = g_lo; s < Tn; ++s)
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int j = 0; j < M; ++j) A[i][j] += sG[(size_t)s * M * M + i * M + j];
    for (int s = u_lo; s < Tn; ++s)
#pragma unroll
      for (int i = 0; i < M; ++i) A[i][M] += su[s * M + i];
#pragma unroll
    for (int i = 0; i < M; ++i) A[i][i] += lam;
#pragma unroll
    for (int k = 0; k < M; ++k) {
      float piv[M + 1];
#pragma unroll
      for (int c = 0; c <= M; ++c) piv[c] = A[k][c] / A[k][k];
#pragma unroll
      for (int r = 0; r < M; ++r) {
        const float f = A[r][k];
#pragma unroll
        for (int c = 0; c <= M; ++c) A[r][c] = r == k ? piv[c] : A[r][c] - f * piv[c];
      }
    }
    const bool zero = guard[b * Tn + t] > 0.f;
#pragma unroll
    for (int i = 0; i < M; ++i) sgam[t * M + i] = zero ? 0.f : A[i][M];
  }
  __syncthreads();

  // phase 2: the apply sweep
  for (int t = 0; t < Tn; ++t) {
    const size_t row = ((size_t)b * Tn + t) * D;
    if (!(mask[b * Tn + t] > 0.f)) {
      for (int d = threadIdx.x; d < D; d += kThreads) out[row + d] = x[row + d];
      continue;
    }
    float g[M];
#pragma unroll
    for (int j = 0; j < M; ++j) g[j] = sgam[t * M + j];
    for (int d = threadIdx.x; d < D; d += kThreads)
      out[row + d] = from_f32<T>(apply_one<T, M>(x, R, dX, dF, g, b, t, Tn, D, d));
  }
}

// ------------------------------------------------------------ host side
template <typename T, int M>
cudaError_t gram_impl(const void* dF, const void* R, const void* mask, void* G,
                      void* u, int B, int Tn, int D, cudaStream_t s) {
  gram_kernel<T, M><<<dim3(Tn, B), kThreads, 0, s>>>(
      static_cast<const T*>(dF), static_cast<const T*>(R),
      static_cast<const float*>(mask), static_cast<float*>(G),
      static_cast<float*>(u), Tn, D);
  return cudaGetLastError();
}

template <typename T, int M>
cudaError_t apply_impl(const void* x, const void* R, const void* dX,
                       const void* dF, const void* gamma, const void* mask,
                       void* out, int B, int Tn, int D, cudaStream_t s) {
  const dim3 grid((D + kThreads - 1) / kThreads, Tn, B);
  apply_kernel<T, M><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(R),
      static_cast<const T*>(dX), static_cast<const T*>(dF),
      static_cast<const float*>(gamma), static_cast<const float*>(mask),
      static_cast<T*>(out), Tn, D);
  return cudaGetLastError();
}

template <typename T, int M>
cudaError_t round_impl(const void* x, const void* R, const void* dX,
                       const void* dF, const void* mask, const void* guard,
                       void* out, int B, int Tn, int D, int mode, float lam,
                       cudaStream_t s) {
  const size_t smem = (size_t)Tn * (M * M + 2 * M) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        round_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  round_kernel<T, M><<<B, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(R),
      static_cast<const T*>(dX), static_cast<const T*>(dF),
      static_cast<const float*>(mask), static_cast<const float*>(guard),
      static_cast<T*>(out), Tn, D, mode, lam);
  return cudaGetLastError();
}

#define TAA_M_CASES(CALL) \
  case 1:                 \
    CALL(1);              \
  case 2:                 \
    CALL(2);              \
  case 3:                 \
    CALL(3);              \
  case 4:                 \
    CALL(4);              \
  case 5:                 \
    CALL(5);              \
  case 6:                 \
    CALL(6);              \
  case 7:                 \
    CALL(7);              \
  case 8:                 \
    CALL(8);

template <typename T>
cudaError_t gram_dispatch(const void* dF, const void* R, const void* mask,
                          void* G, void* u, int B, int m, int Tn, int D,
                          cudaStream_t s) {
#define CALL(MM) return gram_impl<T, MM>(dF, R, mask, G, u, B, Tn, D, s)
  switch (m) {
    TAA_M_CASES(CALL)
    default:
      return cudaErrorInvalidValue;
  }
#undef CALL
}

template <typename T>
cudaError_t apply_dispatch(const void* x, const void* R, const void* dX,
                           const void* dF, const void* gamma, const void* mask,
                           void* out, int B, int m, int Tn, int D,
                           cudaStream_t s) {
#define CALL(MM) \
  return apply_impl<T, MM>(x, R, dX, dF, gamma, mask, out, B, Tn, D, s)
  switch (m) {
    TAA_M_CASES(CALL)
    default:
      return cudaErrorInvalidValue;
  }
#undef CALL
}

template <typename T>
cudaError_t round_dispatch(const void* x, const void* R, const void* dX,
                           const void* dF, const void* mask, const void* guard,
                           void* out, int B, int m, int Tn, int D, int mode,
                           float lam, cudaStream_t s) {
#define CALL(MM)                                                          \
  return round_impl<T, MM>(x, R, dX, dF, mask, guard, out, B, Tn, D, mode, \
                           lam, s)
  switch (m) {
    TAA_M_CASES(CALL)
    default:
      return cudaErrorInvalidValue;
  }
#undef CALL
}

bool bad_shape(int B, int m, int Tn, int D, int dtype) {
  return B < 1 || m < 1 || m > kMaxM || Tn < 1 || D < 1 || B > 65535 ||
         Tn > 65535 || (dtype != 0 && dtype != 1);
}

}  // namespace

// C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Each returns the cudaError_t of its launch (0 = launched).
extern "C" {

int taa_gram_launch(const void* dF, const void* R, const void* mask, void* G,
                    void* u, int B, int m, int Tn, int D, int dtype,
                    int device, void* stream) {
  if (bad_shape(B, m, Tn, D, dtype)) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? gram_dispatch<float>(dF, R, mask, G, u, B, m, Tn, D, s)
             : gram_dispatch<__nv_bfloat16>(dF, R, mask, G, u, B, m, Tn, D, s);
}

int taa_apply_launch(const void* x, const void* R, const void* dX,
                     const void* dF, const void* gamma, const void* mask,
                     void* out, int B, int m, int Tn, int D, int dtype,
                     int device, void* stream) {
  if (bad_shape(B, m, Tn, D, dtype)) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? apply_dispatch<float>(x, R, dX, dF, gamma, mask, out, B,
                                            m, Tn, D, s)
                    : apply_dispatch<__nv_bfloat16>(x, R, dX, dF, gamma, mask,
                                                    out, B, m, Tn, D, s);
}

int taa_round_launch(const void* x, const void* R, const void* dX,
                     const void* dF, const void* mask, const void* guard,
                     void* out, int B, int m, int Tn, int D, int dtype,
                     int mode, float lam, int device, void* stream) {
  if (bad_shape(B, m, Tn, D, dtype) || mode < 0 || mode > 2)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? round_dispatch<float>(x, R, dX, dF, mask, guard, out, B,
                                            m, Tn, D, mode, lam, s)
                    : round_dispatch<__nv_bfloat16>(x, R, dX, dF, mask, guard,
                                                    out, B, m, Tn, D, mode,
                                                    lam, s);
}

}  // extern "C"
