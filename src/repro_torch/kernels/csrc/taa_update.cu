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
//     d_blocks) grid in order so the Gram phase ends before the solve.
//     CUDA does not order CTAs; an earlier version got the order by giving
//     each lane ONE CTA, so 7.4 MB went through 2 of the 132 SMs (79x its
//     bound).  This kernel is ONE cooperative launch
//     (cudaLaunchCooperativeKernel) over (lane, row, 512-float D tile)
//     tiles, as many CTAs as the card holds at once (occupancy x SMs) or
//     as there are tiles; CTAs walk the tiles grid-stride.
//       phase 0: each CTA loads its tiles of dF and R (rows with mask 0
//         skip the loads), forms the m(m+1)/2 + m Gram partial sums, and
//         reduces them in a fixed order (block_sum) into a float32 scratch
//         partials (B, NV, T, tiles_per_row) in device memory: no
//         shared-memory cap on T, and no float atomics;
//       grid.sync() (cooperative_groups): the TPU's phase order;
//       phase 1: each CTA reduces the partials of its row in a fixed
//         order (the suffix over rows s >= t for taa, every row for aa and
//         for aa+'s Gram), adds the ridge and solves the m x m system by
//         pivot-free Gauss-Jordan.  Every CTA of a row solves it
//         redundantly: they read the same partials in the same order, so
//         they hold the same bits, and a second grid barrier (or a launch)
//         is saved; guard rows get gamma = 0;
//       phase 2: the apply on the same tiles.  The CTA's first tile of dF
//         and R stays in registers across the barrier (phase 0 walks its
//         tiles last to first), so the apply reads only x and dX again;
//         further tiles re-read dF and R, from L2 at these sizes.
//     A cooperative launch the card refuses returns its error and the
//     wrapper raises: nothing falls back.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 8;
constexpr int kRoundVec = 2;                      // d's per thread a tile
constexpr int kRoundTile = kThreads * kRoundVec;  // floats of D a tile
constexpr int kMaxDevices = 64;

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
// This thread's d's of tile j of row t of lane b: raw dF and R (not
// weighted), zeros past D and on rows whose weight w is 0.
template <typename T, int M>
__device__ __forceinline__ void load_tile(const T* __restrict__ dF,
                                          const T* __restrict__ R, float w,
                                          int b, int t, int j, int Tn, int D,
                                          float (&f)[M][kRoundVec],
                                          float (&r)[kRoundVec]) {
  const size_t row = ((size_t)b * Tn + t) * D;
  const size_t hist = ((size_t)b * M * Tn + t) * D;
  const size_t hist_stride = (size_t)Tn * D;
#pragma unroll
  for (int v = 0; v < kRoundVec; ++v) {
    const int d = j * kRoundTile + v * kThreads + threadIdx.x;
    const bool live = w != 0.f && d < D;
#pragma unroll
    for (int i = 0; i < M; ++i)
      f[i][v] = live ? to_f32(dF[hist + i * hist_stride + d]) : 0.f;
    r[v] = live ? to_f32(R[row + d]) : 0.f;
  }
}

// mode 0 = taa (suffix Gram, suffix rhs), 1 = aa (global, global),
// 2 = aa+ (global Gram, suffix rhs).  part: (B, NV, Tn, tiles_row) scratch.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    round_kernel(const T* __restrict__ x, const T* __restrict__ R,
                 const T* __restrict__ dX, const T* __restrict__ dF,
                 const float* __restrict__ mask,
                 const float* __restrict__ guard, T* __restrict__ out,
                 float* part, int B, int Tn, int D, int tiles_row, int mode,
                 float lam) {
  constexpr int NG = M * (M + 1) / 2;
  constexpr int NV = NG + M;
  __shared__ float scratch[kWarps * NV];
  __shared__ float total[NV];
  __shared__ float gam[M];
  const int n_tiles = B * Tn * tiles_row;
  // tiles of this CTA: blockIdx.x + k * gridDim.x, k < nk (the grid never
  // exceeds the tiles, so nk >= 1)
  const int nk = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;

  // phase 0: Gram partials, the CTA's tiles last to first so that the
  // registers hold its first tile afterwards
  float f[M][kRoundVec], r[kRoundVec];
  for (int k = nk - 1; k >= 0; --k) {
    const int tile = blockIdx.x + k * gridDim.x;
    const int j = tile % tiles_row;
    const int bt = tile / tiles_row;  // b * Tn + t
    const int b = bt / Tn, t = bt % Tn;
    const float w = mask[bt];
    load_tile<T, M>(dF, R, w, b, t, j, Tn, D, f, r);
    float acc[NV];
#pragma unroll
    for (int q = 0; q < NV; ++q) acc[q] = 0.f;
#pragma unroll
    for (int v = 0; v < kRoundVec; ++v) {
      const float rw = r[v] * w;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const float fi = f[i][v] * w;
#pragma unroll
        for (int jj = i; jj < M; ++jj) acc[tri<M>(i, jj)] += fi * (f[jj][v] * w);
        acc[NG + i] += fi * rw;
      }
    }
    block_sum<NV>(acc, scratch, total);
    for (int q = threadIdx.x; q < NV; q += kThreads)
      part[(((size_t)b * NV + q) * Tn + t) * tiles_row + j] = total[q];
  }

  cooperative_groups::this_grid().sync();

  // phases 1 and 2: per tile, its row's solve (once per run of tiles of
  // one row), then the apply
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int solved = -1;
  for (int k = 0; k < nk; ++k) {
    const int tile = blockIdx.x + k * gridDim.x;
    const int j = tile % tiles_row;
    const int bt = tile / tiles_row;
    const int b = bt / Tn, t = bt % Tn;
    const float w = mask[bt];
    const size_t row = (size_t)bt * D;
    if (!(w > 0.f)) {  // uniform over the CTA: the row copies x
#pragma unroll
      for (int v = 0; v < kRoundVec; ++v) {
        const int d = j * kRoundTile + v * kThreads + threadIdx.x;
        if (d < D) out[row + d] = x[row + d];
      }
      continue;
    }
    if (bt != solved) {
      // fixed-order reduction of the row's partials: warp per value, lanes
      // stride over (row s >= lo, tile) in order, then an xor tree
      for (int q = warp; q < NV; q += kWarps) {
        const int lo = mode == 0 || (mode == 2 && q >= NG) ? t : 0;
        const float* src = part + (((size_t)b * NV + q) * Tn + lo) * tiles_row;
        const int count = (Tn - lo) * tiles_row;
        float sum = 0.f;
        for (int idx = lane; idx < count; idx += 32) sum += __ldcg(src + idx);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) total[q] = sum;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        float A[M][M + 1];
#pragma unroll
        for (int i = 0; i < M; ++i) {
#pragma unroll
          for (int c = 0; c < M; ++c)
            A[i][c] = total[i <= c ? tri<M>(i, c) : tri<M>(c, i)];
          A[i][i] += lam;
          A[i][M] = total[NG + i];
        }
#pragma unroll
        for (int kk = 0; kk < M; ++kk) {
          float piv[M + 1];
#pragma unroll
          for (int c = 0; c <= M; ++c) piv[c] = A[kk][c] / A[kk][kk];
#pragma unroll
          for (int rr = 0; rr < M; ++rr) {
            const float fac = A[rr][kk];
#pragma unroll
            for (int c = 0; c <= M; ++c)
              A[rr][c] = rr == kk ? piv[c] : A[rr][c] - fac * piv[c];
          }
        }
        const bool zero = guard[bt] > 0.f;
#pragma unroll
        for (int i = 0; i < M; ++i) gam[i] = zero ? 0.f : A[i][M];
      }
      __syncthreads();
      solved = bt;
    }
    if (k > 0) load_tile<T, M>(dF, R, w, b, t, j, Tn, D, f, r);
    float g[M];
#pragma unroll
    for (int i = 0; i < M; ++i) g[i] = gam[i];
    const size_t hist = ((size_t)b * M * Tn + t) * D;
    const size_t hist_stride = (size_t)Tn * D;
#pragma unroll
    for (int v = 0; v < kRoundVec; ++v) {
      const int d = j * kRoundTile + v * kThreads + threadIdx.x;
      if (d < D) {
        float corr = 0.f;
#pragma unroll
        for (int i = 0; i < M; ++i)
          corr += g[i] * (to_f32(dX[hist + i * hist_stride + d]) + f[i][v]);
        out[row + d] = from_f32<T>(to_f32(x[row + d]) + r[v] - corr);
      }
    }
    __syncthreads();  // gam and total are reused by the next tile's solve
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

// info[0..3) <- CTAs launched, tiles, CTAs the card holds at once.
template <typename T, int M>
cudaError_t round_impl(const void* x, const void* R, const void* dX,
                       const void* dF, const void* mask, const void* guard,
                       void* out, void* part, int* info, int B, int Tn, int D,
                       int mode, float lam, cudaStream_t s) {
  static int resident[kMaxDevices] = {};  // per device, per instantiation
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    if (!coop) return cudaErrorNotSupported;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, round_kernel<T, M>, kThreads, 0);
    if (e != cudaSuccess) return e;
    resident[dev] = sms * per_sm;
  }
  int tiles_row = (D + kRoundTile - 1) / kRoundTile;
  const long long tiles = (long long)B * Tn * tiles_row;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < resident[dev] ? tiles : resident[dev]);
  info[0] = grid;
  info[1] = static_cast<int>(tiles);
  info[2] = resident[dev];
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(R);
  const T* dxp = static_cast<const T*>(dX);
  const T* dfp = static_cast<const T*>(dF);
  const float* mp = static_cast<const float*>(mask);
  const float* gp = static_cast<const float*>(guard);
  T* op = static_cast<T*>(out);
  float* pp = static_cast<float*>(part);
  void* args[] = {&xp, &rp, &dxp, &dfp, &mp, &gp, &op, &pp,
                  &B, &Tn, &D, &tiles_row, &mode, &lam};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(round_kernel<T, M>),
                                     dim3(grid), dim3(kThreads), args, 0, s);
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
                           void* out, void* part, int* info, int B, int m,
                           int Tn, int D, int mode, float lam,
                           cudaStream_t s) {
#define CALL(MM)                                                      \
  return round_impl<T, MM>(x, R, dX, dF, mask, guard, out, part, info, B, \
                           Tn, D, mode, lam, s)
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

// part: float32 scratch (B, m(m+1)/2 + m, Tn, ceil(D / 512)); info: 3 ints
// out (CTAs launched, tiles, CTAs co-resident).
int taa_round_launch(const void* x, const void* R, const void* dX,
                     const void* dF, const void* mask, const void* guard,
                     void* out, void* part, int* info, int B, int m, int Tn,
                     int D, int dtype, int mode, float lam, int device,
                     void* stream) {
  if (bad_shape(B, m, Tn, D, dtype) || mode < 0 || mode > 2)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? round_dispatch<float>(x, R, dX, dF, mask, guard, out,
                                            part, info, B, m, Tn, D, mode, lam,
                                            s)
                    : round_dispatch<__nv_bfloat16>(x, R, dX, dF, mask, guard,
                                                    out, part, info, B, m, Tn,
                                                    D, mode, lam, s);
}

}  // extern "C"
