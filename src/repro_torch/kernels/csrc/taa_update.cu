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
// of anything: elements past D are not visited, and where D is not a
// multiple of a kernel's vector (or a pointer is not aligned to it) the
// kernel loads element by element.
//
// What bounds them on the card: bytes.  Each one streams the (m, T, D)
// histories and (T, D) rows once and does O(m^2) flops per element (about
// 2-5 flops/byte, far below the H100's ~20 f32 flops/byte ridge), so the
// least time is the bytes over 3.35 TB/s.  What the designs do about it:
//   * The Gram sweep, one code path for taa_gram and taa_round's phase 0:
//     a CTA takes a (lane, row, 512-element D tile) tile, loads the m+1
//     streams of dF and R for it, each thread VEC consecutive elements of
//     each stream (load_tile: one vector load a stream where D and the
//     pointers allow, element by element otherwise; every load issued
//     before any use; rows with mask 0 skip them), forms the m(m+1)/2 + m
//     partial sums (tile_gram) and reduces them in a fixed order
//     (block_sum: warp shuffles, then shared memory; no float atomics).
//   * taa_gram: the tiles over every SM, a 16-byte vector a stream per
//     thread (4 float32 or 8 bf16: 128 or 64 threads a CTA).  A row's tiles
//     go to one thread block cluster of up to 8 CTAs (kGramCluster; one CTA
//     a tile at D <= 4096): B T min(tiles_row, 8) CTAs, 400 at B=2, T=25,
//     D=4096, about three an SM, all resident at once.  Each CTA puts its
//     tiles' sums into the first CTA's shared memory (distributed shared
//     memory); after the cluster barrier that CTA adds them in tile order
//     (the same bits whichever CTA finished first) and writes the
//     symmetric G and u.  An earlier version took one 256-thread CTA per
//     (lane, row) with strided scalar loads: 50 CTAs on 132 SMs, each
//     bound by the latency of its few loads in flight.  Reducing a row
//     through a device scratch, a fence and an integer arrival counter
//     (the last CTA to arrive sums) was tried and cost more than the loads
//     (PERF.md section 6).
//   * taa_apply: one streaming pass over a (lane, row, D-chunk) grid with
//     the row's gamma in registers; masked-off rows copy x and never read
//     the histories.
//   * taa_round: the Pallas kernel relies on the TPU running its (2, T,
//     d_blocks) grid in order so the Gram phase ends before the solve.
//     CUDA does not order CTAs; an earlier version got the order by giving
//     each lane ONE CTA, so 7.4 MB went through 2 of the 132 SMs (79x its
//     bound).  This kernel is ONE cooperative launch
//     (cudaLaunchCooperativeKernel) over the same tiles, as many CTAs as
//     the card holds at once (occupancy x SMs) or as there are tiles; CTAs
//     walk the tiles grid-stride.
//       phase 0: the Gram sweep on each of the CTA's tiles (two
//         consecutive elements a thread), each tile's sums into a float32
//         scratch partials (B, NV, T, tiles_per_row) in device memory: no
//         shared-memory cap on T;
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

#include <climits>
#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;                     // taa_apply, taa_round
constexpr int kMaxM = 8;
constexpr int kRoundVec = 2;                      // d's per thread a tile
constexpr int kRoundTile = kThreads * kRoundVec;  // elements of D a tile
constexpr int kMaxDevices = 64;
constexpr int kGramVecBytes = 16;                 // taa_gram's vector loads
constexpr int kGramCluster = 8;                   // taa_gram's CTAs a row, at most

// taa_gram's vector and threads: a 16-byte vector a thread, one tile a CTA
template <typename T>
__host__ __device__ constexpr int gram_vec() {
  return kGramVecBytes / static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int gram_threads() {
  return kRoundTile / gram_vec<T>();
}

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

// N consecutive elements, loaded or stored as one vector.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// Whether D is a multiple of N and every pointer is aligned to a vector of
// N elements of T, so that the vectors of every row are aligned.
template <typename T, int N>
bool whole_vectors(int D, std::initializer_list<const void*> ptrs) {
  if (D % N != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % (sizeof(T) * N) != 0) return false;
  return true;
}

// Elements d .. d+N-1 of p (d a multiple of N) as float, zeros past D: one
// vector load when `whole` (the vector is then all in or all out), element
// by element otherwise.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, int d, int D,
                                         bool whole, float (&out)[N]) {
  if (whole) {
    if (d < D) {
      const Pack<T, N> x = *reinterpret_cast<const Pack<T, N>*>(p + d);
#pragma unroll
      for (int v = 0; v < N; ++v) out[v] = to_f32(x.v[v]);
    } else {
#pragma unroll
      for (int v = 0; v < N; ++v) out[v] = 0.f;
    }
  } else {
#pragma unroll
    for (int v = 0; v < N; ++v) out[v] = d + v < D ? to_f32(p[d + v]) : 0.f;
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* __restrict__ p, int d, int D,
                                          bool whole, const float (&in)[N]) {
  if (whole) {
    if (d < D) {
      Pack<T, N> x;
#pragma unroll
      for (int v = 0; v < N; ++v) x.v[v] = from_f32<T>(in[v]);
      *reinterpret_cast<Pack<T, N>*>(p + d) = x;
    }
  } else {
#pragma unroll
    for (int v = 0; v < N; ++v)
      if (d + v < D) p[d + v] = from_f32<T>(in[v]);
  }
}

// Index of (i, j), i <= j, in the row-major upper-triangle enumeration.
template <int M>
__host__ __device__ constexpr int tri(int i, int j) {
  return i * M - i * (i - 1) / 2 + (j - i);
}

// Deterministic block sum of NV per-thread values over NT threads: a
// shuffle tree in each warp, then one thread per value adds the warps'
// partials in warp order.  On return every thread may read out[0..NV).
// All threads must call it.
template <int NV, int NT>
__device__ void block_sum(float (&v)[NV], float* scratch, float* out) {
  constexpr int kW = NT / 32;
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
  for (int k = threadIdx.x; k < NV; k += NT) {
    float s = 0.f;
    for (int w = 0; w < kW; ++w) s += scratch[w * NV + k];
    out[k] = s;
  }
  __syncthreads();
}

// ------------------------------------------------------------ Gram sweep
// The first element of D this thread holds in tile j: the CTA's threads,
// VEC consecutive elements each, cover the tile.
template <int VEC>
__device__ __forceinline__ int tile_d(int j) {
  return j * kRoundTile + static_cast<int>(threadIdx.x) * VEC;
}

// This thread's elements of tile j of row t of lane b: raw dF and R (not
// weighted), zeros past D and on rows whose weight w is 0 (no loads).
// Every load is issued before any is used.
template <typename T, int M, int VEC>
__device__ __forceinline__ void load_tile(const T* __restrict__ dF,
                                          const T* __restrict__ R, float w,
                                          int b, int t, int j, int Tn, int D,
                                          bool whole, float (&f)[M][VEC],
                                          float (&r)[VEC]) {
  const int d = w != 0.f ? tile_d<VEC>(j) : D;  // uniform over the CTA
  const T* f_row = dF + ((size_t)b * M * Tn + t) * D;
  const size_t hist_stride = (size_t)Tn * D;
#pragma unroll
  for (int i = 0; i < M; ++i)
    load_vec<T, VEC>(f_row + i * hist_stride, d, D, whole, f[i]);
  load_vec<T, VEC>(R + ((size_t)b * Tn + t) * D, d, D, whole, r);
}

// The tile's m(m+1)/2 + m partial sums over this thread's elements:
// acc[tri(i, j)] = sum w f_i w f_j (i <= j), acc[M(M+1)/2 + i] = sum w f_i w r.
template <int M, int NV, int VEC>
__device__ __forceinline__ void tile_gram(const float (&f)[M][VEC],
                                          const float (&r)[VEC], float w,
                                          float (&acc)[NV]) {
  constexpr int NG = M * (M + 1) / 2;
#pragma unroll
  for (int q = 0; q < NV; ++q) acc[q] = 0.f;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const float rw = r[v] * w;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float fi = f[i][v] * w;
#pragma unroll
      for (int jj = i; jj < M; ++jj) acc[tri<M>(i, jj)] += fi * (f[jj][v] * w);
      acc[NG + i] += fi * rw;
    }
  }
}

// Writes a row's symmetric (M, M) G and (M,) u from its NV sums.
template <int M>
__device__ __forceinline__ void write_gram(const float* total, float* g,
                                           float* u) {
  constexpr int NG = M * (M + 1) / 2;
  for (int k = threadIdx.x; k < M * M; k += blockDim.x) {
    const int i = k / M, j = k % M;
    g[k] = total[i <= j ? tri<M>(i, j) : tri<M>(j, i)];
  }
  for (int i = threadIdx.x; i < M; i += blockDim.x) u[i] = total[NG + i];
}

// ---------------------------------------------------------------- taa_gram
// One cluster of C = min(tiles_row, kGramCluster) CTAs per (lane, row):
// cluster CTA `rank` takes the row's tiles rank, rank + C, ..., and puts
// each tile's NV sums into the shared memory of the cluster's first CTA
// (sums: (tiles_row, NV), dynamic), which after the cluster barrier sums
// them in tile order and writes the row's G and u.
template <typename T, int M>
__global__ void __launch_bounds__(gram_threads<T>())
    gram_kernel(const T* __restrict__ dF, const T* __restrict__ R,
                const float* __restrict__ mask, float* __restrict__ G,
                float* __restrict__ u, int Tn, int D, int tiles_row,
                bool whole) {
  constexpr int NT = gram_threads<T>();
  constexpr int VEC = gram_vec<T>();
  constexpr int NV = M * (M + 1) / 2 + M;
  extern __shared__ float sums[];
  __shared__ float scratch[(NT / 32) * NV];
  __shared__ float total[NV];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int bt = blockIdx.x / C;  // b * Tn + t
  const int b = bt / Tn, t = bt % Tn;
  const float w = mask[bt];
  float* g = G + (size_t)bt * M * M;
  float* ur = u + (size_t)bt * M;
  if (w == 0.f) {  // uniform over the cluster: no CTA reaches the barrier
    if (rank == 0) {
      for (int k = threadIdx.x; k < M * M; k += NT) g[k] = 0.f;
      for (int i = threadIdx.x; i < M; i += NT) ur[i] = 0.f;
    }
    return;
  }
  float* root = cluster.map_shared_rank(sums, 0);
  for (int j = rank; j < tiles_row; j += C) {
    float f[M][VEC], r[VEC], acc[NV];
    load_tile<T, M, VEC>(dF, R, w, b, t, j, Tn, D, whole, f, r);
    tile_gram<M, NV, VEC>(f, r, w, acc);
    block_sum<NV, NT>(acc, scratch, total);
    for (int q = threadIdx.x; q < NV; q += NT) root[j * NV + q] = total[q];
  }
  cluster.sync();  // every tile's sums are in the first CTA's shared memory
  if (rank != 0) return;
  // the row's sums in tile order: the same bits whichever CTA finished last
  for (int q = threadIdx.x; q < NV; q += NT) {
    float s = 0.f;
    for (int jj = 0; jj < tiles_row; ++jj) s += sums[jj * NV + q];
    total[q] = s;
  }
  __syncthreads();
  write_gram<M>(total, g, ur);
}

// --------------------------------------------------------------- taa_apply
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
// 2 = aa+ (global Gram, suffix rhs).  part: (B, NV, Tn, tiles_row) scratch.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    round_kernel(const T* __restrict__ x, const T* __restrict__ R,
                 const T* __restrict__ dX, const T* __restrict__ dF,
                 const float* __restrict__ mask,
                 const float* __restrict__ guard, T* __restrict__ out,
                 float* part, int B, int Tn, int D, int tiles_row, int mode,
                 float lam, bool whole) {
  constexpr int NG = M * (M + 1) / 2;
  constexpr int NV = NG + M;
  constexpr int kWarps = kThreads / 32;
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
    load_tile<T, M, kRoundVec>(dF, R, w, b, t, j, Tn, D, whole, f, r);
    float acc[NV];
    tile_gram<M, NV, kRoundVec>(f, r, w, acc);
    block_sum<NV, kThreads>(acc, scratch, total);
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
    const int d = tile_d<kRoundVec>(j);
    float xv[kRoundVec];
    load_vec<T, kRoundVec>(x + row, d, D, whole, xv);
    if (!(w > 0.f)) {  // uniform over the CTA: the row copies x
      store_vec<T, kRoundVec>(out + row, d, D, whole, xv);
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
    if (k > 0) load_tile<T, M, kRoundVec>(dF, R, w, b, t, j, Tn, D, whole, f, r);
    const T* dx_row = dX + ((size_t)b * M * Tn + t) * D;
    const size_t hist_stride = (size_t)Tn * D;
    float corr[kRoundVec] = {};
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float gi = gam[i];
      float dx[kRoundVec];
      load_vec<T, kRoundVec>(dx_row + i * hist_stride, d, D, whole, dx);
#pragma unroll
      for (int v = 0; v < kRoundVec; ++v) corr[v] += gi * (dx[v] + f[i][v]);
    }
    float o[kRoundVec];
#pragma unroll
    for (int v = 0; v < kRoundVec; ++v) o[v] = xv[v] + r[v] - corr[v];
    store_vec<T, kRoundVec>(out + row, d, D, whole, o);
    __syncthreads();  // gam and total are reused by the next tile's solve
  }
}

// ------------------------------------------------------------ host side
// info[0..4) <- CTAs launched, tiles per row, threads a CTA, CTAs a cluster.
template <typename T, int M>
cudaError_t gram_impl(const void* dF, const void* R, const void* mask, void* G,
                      void* u, int* info, int B, int Tn, int D,
                      cudaStream_t s) {
  constexpr int NT = gram_threads<T>();
  constexpr int NV = M * (M + 1) / 2 + M;
  const int tiles_row = (D + kRoundTile - 1) / kRoundTile;
  const int C = tiles_row < kGramCluster ? tiles_row : kGramCluster;
  const long long ctas = (long long)B * Tn * C;
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = (size_t)tiles_row * NV * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gram_kernel<T, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  info[0] = static_cast<int>(ctas);
  info[1] = tiles_row;
  info[2] = NT;
  info[3] = C;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned>(C);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const bool whole = whole_vectors<T, gram_vec<T>()>(D, {dF, R});
  return cudaLaunchKernelEx(&cfg, gram_kernel<T, M>, static_cast<const T*>(dF),
                            static_cast<const T*>(R),
                            static_cast<const float*>(mask),
                            static_cast<float*>(G), static_cast<float*>(u), Tn,
                            D, tiles_row, whole);
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
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < resident[dev] ? tiles : resident[dev]);
  info[0] = grid;
  info[1] = static_cast<int>(tiles);
  info[2] = resident[dev];
  bool whole = whole_vectors<T, kRoundVec>(D, {x, R, dX, dF, out});
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(R);
  const T* dxp = static_cast<const T*>(dX);
  const T* dfp = static_cast<const T*>(dF);
  const float* mp = static_cast<const float*>(mask);
  const float* gp = static_cast<const float*>(guard);
  T* op = static_cast<T*>(out);
  float* pp = static_cast<float*>(part);
  void* args[] = {&xp, &rp, &dxp, &dfp, &mp, &gp, &op, &pp,
                  &B, &Tn, &D, &tiles_row, &mode, &lam, &whole};
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
                          void* G, void* u, int* info, int B, int m, int Tn,
                          int D, cudaStream_t s) {
#define CALL(MM) return gram_impl<T, MM>(dF, R, mask, G, u, info, B, Tn, D, s)
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

// info: 4 ints out (CTAs launched, tiles per row, threads a CTA, CTAs a
// cluster).
int taa_gram_launch(const void* dF, const void* R, const void* mask, void* G,
                    void* u, int* info, int B, int m, int Tn, int D, int dtype,
                    int device, void* stream) {
  if (bad_shape(B, m, Tn, D, dtype)) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? gram_dispatch<float>(dF, R, mask, G, u, info, B, m, Tn,
                                           D, s)
                    : gram_dispatch<__nv_bfloat16>(dF, R, mask, G, u, info, B,
                                                   m, Tn, D, s);
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
