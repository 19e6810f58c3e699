// Mamba2 SSD scan (single group) for NVIDIA Hopper (sm_90a), chunked on the
// tensor cores.
//
// Replaces the Pallas TPU kernel of the JAX package's
// src/repro/kernels/ssd_scan.py: ssd_scan (_ssd_kernel).  That kernel walks
// the chunks in grid order with the (P, N) state in VMEM scratch and does
// each chunk's quadratic form on the MXU.  The function, per (batch, head):
//   state_t = exp(dt_t A) state_{t-1} + dt_t x_t B_t^T,   y_t = state_t C_t
// with state_{-1} = 0.  Shapes (row-major, contiguous, float32): x, y (b, s,
// h, p); dt (b, s, h); A (h,); B, C (b, s, n); final state (b, h, p, n).
// p <= 64, n <= 128; s need not be a multiple of the chunk.
//
// An earlier version ran the per-step recurrence, one CTA per (b, h): a
// chain of s dependent steps (0.63 us each on the H100), 128 CTAs, the
// tensor cores idle.  This version is Mamba2's chunked form over chunks of
// Q = 64 steps, in two launches:
//   1. chunk_kernel, grid (chunks, h / 4, b), every chunk in parallel: S =
//      C B^T once for 4 heads (B and C are shared by every head), then per
//      head, with cum_i the inclusive sum of dt A over the chunk, W = S o L,
//      L_ij = exp(cum_i - cum_j) dt_j for j <= i (0 above), y = W x (the
//      intra-chunk output), and the chunk-local state sum_j exp(cum_Q -
//      cum_j) dt_j x_j B_j^T.  Writes y, the local states (b, h, chunks, p,
//      n) and cum (b, h, chunks, Q).  The next head's x is staged while
//      this one computes.
//   2. pass_kernel, grid (p / 32, h, b): the chunk-to-chunk pass.  A CTA
//      carries 32 rows of one head's state in registers through the chunks
//      in order; per chunk it adds the inter-chunk output y_i += exp(cum_i)
//      C_i state_{c-1}^T for its 32 columns of y, then state_c =
//      exp(cum_Q) state_{c-1} + local_c.  The next chunk's C, y tile and
//      local state are loaded while this one computes.  Writes the final
//      state.
//      The local states are read once and never written back.
// The products (C B^T, W x, the local state, the inter-chunk output) run on
// the tensor cores as mma.sync m16n8k8 TF32 with the 3xTF32 split: each
// float32 operand v = hi + lo with hi = tf32(v) (nearest, ties away from
// zero), lo = v - hi truncated to tf32 by the tensor core, and a product is
// lo*hi + hi*lo + hi*hi accumulated in float32.  One TF32 product keeps ~3
// digits and misses the 1e-4 relative bound by ~5x; the split keeps the
// chunked float32 form's error (~1e-6).  Tiles are staged into shared
// memory with cp.async (16 bytes a copy where p, n and the pointers allow);
// row strides are padded (72 = 8 mod 32, 132 and 68 = 4 mod 32) so that a
// fragment's 32 loads fall in 32 banks.
//
// Numerics the TPU kernel gets away with: exp is only taken of non-positive
// arguments (cum is non-increasing; j > i is masked BEFORE the exp, since
// exp(cum_i - cum_j) for j > i can overflow to inf and inf * 0 = NaN).
// Padded steps of a ragged last chunk have x = B = C = dt = 0: they add 0
// to the state and decay it by exp(0) = 1.
//
// What bounds it: in this form, the tensor cores.  Per (b, chunk) C B^T is
// 2 Q^2 n flops; per (b, h, chunk) W x is ~Q^2 p (causal), the local state
// 2 Q p n and the inter-chunk output 2 Q p n; three products each for the
// split, over 495 TFLOP/s of TF32 (mma.sync reaches less than wgmma).  The
// bytes (x, y, B, C once; the local states written once and read once) take
// less at mamba2-1.3b.
// No atomics: results are the same from run to run.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kQ = 64;          // steps a chunk
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kThreads = 256;   // 8 warps
constexpr int kXS = kMaxP + 8;  // row stride of x tiles
constexpr int kNS = kMaxN + 4;  // row stride of B, C and state tiles
constexpr int kWS = kQ + 4;     // row stride of W
constexpr int kHeads = 4;       // heads a chunk CTA serves (C B^T shared)
constexpr int kSlice = 32;      // state rows (p) a pass CTA carries
constexpr int kMaxDevices = 64;

constexpr int kYS = kSlice + 4;  // row stride of a pass CTA's y tile

// chunk_kernel: x (two buffers) | B | C, then W in C's place | per head:
// dt | cum | state weights
constexpr size_t kChunkSmem =
    sizeof(float) * (2 * kQ * kXS + 2 * kQ * kNS + 3 * kHeads * kQ);
// pass_kernel: C, cum and y (two buffers each) | state slice
constexpr size_t kPassSmem =
    sizeof(float) * (2 * (kQ * kNS + kQ + kQ * kYS) + kSlice * kNS);

// v = hi + lo: hi = tf32(v) rounded to nearest (ties away from zero) by
// integer ops; lo = v - hi exactly, handed over whole: the tensor core reads
// the top 19 bits of a tf32 operand, so lo is truncated to tf32 there.
// Three ALU ops instead of two cvt.rna.tf32 (a slow conversion unit).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// A fragment of m16n8k8 (16 x 8, row-major): a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); g = lane / 4, t = lane % 4.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(int k, float v) { split(v, hi[k], lo[k]); }
};
// B fragment (8 x 8, K x N): b0 (k = t, n = g), b1 (k = t + 4, n = g).
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(int k, float v) { split(v, hi[k], lo[k]); }
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// The same into two accumulators, big (hi hi) and small (lo hi + hi lo)
// terms: two dependency chains instead of one; the caller adds them.
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const FragA& a, const FragB& b) {
  mma(small, a.lo, b.hi);
  mma(small, a.hi, b.lo);
  mma(big, a.hi, b.hi);
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Waits for every cp.async this thread issued (wait_all commits first).
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage rows x cols of a matrix with leading dimension ld into dst (row
// stride ds), zero-padded to kRows x kCols.  V: 16-byte copies (cols, ld
// and src 16-byte aligned, as the host checks), else 4-byte ones.
template <bool V, int kRows, int kCols>
__device__ __forceinline__ void stage(float* dst, int ds, const float* src,
                                      size_t ld, int rows, int cols) {
  constexpr int W = V ? 4 : 1;
  constexpr int kPer = kCols / W;
  for (int i = threadIdx.x; i < kRows * kPer; i += kThreads) {
    const int r = i / kPer, col = (i % kPer) * W;
    float* d = dst + r * ds + col;
    if (r < rows && col < cols) {
      if (V)
        cp16(d, src + r * ld + col);
      else
        cp4(d, src + r * ld + col);
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) d[w] = 0.f;
    }
  }
}


// ------------------------------------------------------------ 1. chunks
template <bool V>
__global__ void __launch_bounds__(kThreads, 2)
    chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ cums, int S,
                 int H, int P, int N, int nc) {
  extern __shared__ float sm[];
  float* xs = sm;                  // [2][kQ][kXS]
  float* bs = xs + 2 * kQ * kXS;   // [kQ][kNS]
  float* cs = bs + kQ * kNS;       // [kQ][kNS]; then W [kQ][kWS]
  float* ws = cs;
  float* dts = cs + kQ * kNS;      // [kHeads][kQ]
  float* cum = dts + kHeads * kQ;  // [kHeads][kQ]
  float* wj = cum + kHeads * kQ;   // [kHeads][kQ]
  const int c = blockIdx.x, h0 = blockIdx.y * kHeads, b = blockIdx.z;
  const int nh = min(kHeads, H - h0);
  const int tid = threadIdx.x;
  const int s0 = c * kQ;
  const int len = min(kQ, S - s0);
  const size_t x_ld = (size_t)H * P;
  const float* x0 = x + ((size_t)b * S + s0) * x_ld;

  stage<V, kQ, kMaxN>(bs, kNS, Bm + ((size_t)b * S + s0) * N, N, len, N);
  stage<V, kQ, kMaxN>(cs, kNS, Cm + ((size_t)b * S + s0) * N, N, len, N);
  stage<V, kQ, kMaxP>(xs, kXS, x0 + (size_t)h0 * P, x_ld, len, P);
  for (int i = tid; i < kHeads * kQ; i += kThreads) {
    const int hi = i / kQ, r = i % kQ;
    if (hi < nh && r < len)
      cp4(dts + i, dt + ((size_t)b * S + s0 + r) * H + h0 + hi);
    else
      dts[i] = 0.f;
  }
  cp_wait_all();
  __syncthreads();
  if (tid < nh) {  // one thread a head, in order: cum is non-increasing
    const float a_h = A[h0 + tid];
    const float* d = dts + tid * kQ;
    float* cu = cum + tid * kQ;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      acc += d[i] * a_h;
      cu[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < nh * kQ; i += kThreads) {
    const int hi = i / kQ, r = i % kQ;
    wj[i] = expf(cum[hi * kQ + kQ - 1] - cum[i]) * dts[i];
    cums[(((size_t)b * H + h0 + hi) * nc + c) * kQ + r] = cum[i];
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 3;  // 16-row tile of this warp

  // S = C B^T, kept in registers for every head: this warp's rows
  // mt*16.., columns (warp / 4) * 32..
  float sc[4][4] = {};
  {
    const int nt0 = (warp >> 2) * 4;
    for (int k0 = 0; k0 < N; k0 += 8) {
      FragA a;
      const float* cr = cs + (mt * 16 + g) * kNS + k0 + t;
      a.set(0, cr[0]);
      a.set(1, cr[8 * kNS]);
      a.set(2, cr[4]);
      a.set(3, cr[8 * kNS + 4]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        FragB fb;
        const float* br = bs + ((nt0 + q) * 8 + g) * kNS + k0 + t;
        fb.set(0, br[0]);
        fb.set(1, br[4]);
        mma3(sc[q], a, fb);
      }
    }
  }

  for (int hi = 0; hi < nh; ++hi) {
    const int h = h0 + hi;
    const float* xh = xs + (hi & 1) * kQ * kXS;
    const float* dth = dts + hi * kQ;
    const float* cuh = cum + hi * kQ;
    const float* wjh = wj + hi * kQ;
    cp_wait_all();    // this head's x
    __syncthreads();  // and every warp is done with C (hi = 0) or with the
                      // previous head's W and x buffer
    if (hi + 1 < nh)  // the next head's x, into the other buffer
      stage<V, kQ, kMaxP>(xs + ((hi + 1) & 1) * kQ * kXS, kXS,
                          x0 + (size_t)(h + 1) * P, x_ld, len, P);
    {  // W = S o L
      const int nt0 = (warp >> 2) * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = mt * 16 + g + (e >> 1) * 8;
          const int j = (nt0 + q) * 8 + 2 * t + (e & 1);
          ws[i * kWS + j] =
              j <= i ? sc[q][e] * expf(cuh[i] - cuh[j]) * dth[j] : 0.f;
        }
    }
    __syncthreads();

    // y = W x: rows mt*16.., columns (warp / 4) * 32..; W is 0 above the
    // diagonal, so the k loop stops at the tile's last row
    {
      float acc[4][4] = {};
      const int nt0 = (warp >> 2) * 4;
      for (int k0 = 0; k0 < (mt + 1) * 16; k0 += 8) {
        FragA a;
        const float* wr = ws + (mt * 16 + g) * kWS + k0 + t;
        a.set(0, wr[0]);
        a.set(1, wr[8 * kWS]);
        a.set(2, wr[4]);
        a.set(3, wr[8 * kWS + 4]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          FragB fb;
          const float* xr = xh + (k0 + t) * kXS + (nt0 + q) * 8 + g;
          fb.set(0, xr[0]);
          fb.set(1, xr[4 * kXS]);
          mma3(acc[q], a, fb);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = mt * 16 + g + (e >> 1) * 8;
          const int p = (nt0 + q) * 8 + 2 * t + (e & 1);
          if (i < len && p < P)
            y[(((size_t)b * S + s0 + i) * H + h) * P + p] = acc[q][e];
        }
    }

    // local state = (w o x)^T B: rows p = mt*16.., columns n = (warp/4)*64..
    {
      float acc[8][4] = {};
      const int nt0 = (warp >> 2) * 8;
      for (int k0 = 0; k0 < len; k0 += 8) {
        FragA a;
        const float* xr = xh + (k0 + t) * kXS + mt * 16 + g;
        const float w0 = wjh[k0 + t], w4 = wjh[k0 + t + 4];
        a.set(0, xr[0] * w0);
        a.set(1, xr[8] * w0);
        a.set(2, xr[4 * kXS] * w4);
        a.set(3, xr[4 * kXS + 8] * w4);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          FragB fb;
          const float* br = bs + (k0 + t) * kNS + (nt0 + q) * 8 + g;
          fb.set(0, br[0]);
          fb.set(1, br[4 * kNS]);
          mma3(acc[q], a, fb);
        }
      }
      float* st = states + (((size_t)b * H + h) * nc + c) * P * N;
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = mt * 16 + g + (e >> 1) * 8;
          const int n = (nt0 + q) * 8 + 2 * t + (e & 1);
          if (p < P && n < N) st[p * N + n] = acc[q][e];
        }
    }
  }
}

// ------------------------------------ 2. state passing + inter-chunk output
template <bool V>
__global__ void __launch_bounds__(kThreads, 2)
    pass_kernel(const float* __restrict__ Cm,
                const float* __restrict__ states,
                const float* __restrict__ cums, float* __restrict__ y,
                float* __restrict__ fs, int S, int H, int P, int N, int nc) {
  constexpr int kEl = kSlice * kMaxN / kThreads;  // state entries a thread
  extern __shared__ float sm[];
  float* cbuf = sm;                    // [2][kQ][kNS]
  float* ss = cbuf + 2 * kQ * kNS;     // [kSlice][kNS]: state entering c
  float* cumb = ss + kSlice * kNS;     // [2][kQ]
  float* ybuf = cumb + 2 * kQ;         // [2][kQ][kYS]: y's tile, intra part
  const int p0 = blockIdx.x * kSlice, h = blockIdx.y, b = blockIdx.z;
  const int rows = min(kSlice, P - p0);
  const int tid = threadIdx.x;
  const size_t bh = (size_t)b * H + h;

  // this thread's entries: (r, n) = divmod(tid + e * kThreads, kMaxN)
  auto load_local = [&](int c, float (&v)[kEl]) {
    const float* src = states + (bh * nc + c) * P * N + (size_t)p0 * N;
#pragma unroll
    for (int e = 0; e < kEl; ++e) {
      const int idx = tid + e * kThreads;
      const int r = idx / kMaxN, n = idx % kMaxN;
      v[e] = r < rows && n < N ? src[r * N + n] : 0.f;
    }
  };
  auto stage_chunk = [&](int c) {
    const int buf = c & 1;
    const int len = min(kQ, S - c * kQ);
    stage<V, kQ, kMaxN>(cbuf + buf * kQ * kNS, kNS,
                        Cm + ((size_t)b * S + c * kQ) * N, N, len, N);
    if (tid < kQ) cp4(cumb + buf * kQ + tid, cums + (bh * nc + c) * kQ + tid);
    if (c > 0)
      stage<V, kQ, kSlice>(ybuf + buf * kQ * kYS, kYS,
                           y + (((size_t)b * S + c * kQ) * H + h) * P + p0,
                           (size_t)H * P, len, rows);
  };

  float st[kEl], cur[kEl], nxt[kEl];
#pragma unroll
  for (int e = 0; e < kEl; ++e) st[e] = 0.f;
  for (int i = tid; i < kSlice * kNS; i += kThreads) ss[i] = 0.f;
  load_local(0, nxt);
  stage_chunk(0);

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 3;
  const int nt0 = (warp >> 2) * 2;  // this warp's 16 of the slice's columns
  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1;
    cp_wait_all();    // chunk c's C and cum
    __syncthreads();  // and the state entering c is in ss
    if (c + 1 < nc) stage_chunk(c + 1);
#pragma unroll
    for (int e = 0; e < kEl; ++e) cur[e] = nxt[e];
    if (c + 1 < nc) load_local(c + 1, nxt);
    const float* cb = cbuf + buf * kQ * kNS;
    const float* cm = cumb + buf * kQ;
    const int len = min(kQ, S - c * kQ);
    if (c > 0) {  // chunk 0 enters with state 0
      float acc[2][4] = {}, small[2][4] = {};
      const float e0 = expf(cm[mt * 16 + g]), e8 = expf(cm[mt * 16 + g + 8]);
      for (int k0 = 0; k0 < N; k0 += 8) {
        FragA a;
        const float* cr = cb + (mt * 16 + g) * kNS + k0 + t;
        a.set(0, cr[0] * e0);
        a.set(1, cr[8 * kNS] * e8);
        a.set(2, cr[4] * e0);
        a.set(3, cr[8 * kNS + 4] * e8);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          FragB fb;
          const float* sr = ss + ((nt0 + q) * 8 + g) * kNS + k0 + t;
          fb.set(0, sr[0]);
          fb.set(1, sr[4]);
          mma3(acc[q], small[q], a, fb);
        }
      }
      const float* yb = ybuf + buf * kQ * kYS;
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = mt * 16 + g + (e >> 1) * 8;
          const int col = (nt0 + q) * 8 + 2 * t + (e & 1);
          if (i < len && col < rows)
            y[(((size_t)b * S + c * kQ + i) * H + h) * P + p0 + col] =
                yb[i * kYS + col] + (acc[q][e] + small[q][e]);
        }
    }
    __syncthreads();  // every warp is done reading ss
    const float decay = expf(cm[kQ - 1]);
#pragma unroll
    for (int e = 0; e < kEl; ++e) {
      const int idx = tid + e * kThreads;
      st[e] = st[e] * decay + cur[e];
      ss[(idx / kMaxN) * kNS + idx % kMaxN] = st[e];
    }
  }
  float* out = fs + bh * P * N + (size_t)p0 * N;
#pragma unroll
  for (int e = 0; e < kEl; ++e) {
    const int idx = tid + e * kThreads;
    const int r = idx / kMaxN, n = idx % kMaxN;
    if (r < rows && n < N) out[r * N + n] = st[e];
  }
}

// Raise the kernels' shared-memory limits once per device.
cudaError_t ensure_smem(int device) {
  static bool done[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  const void* fns[] = {reinterpret_cast<const void*>(chunk_kernel<true>),
                       reinterpret_cast<const void*>(chunk_kernel<false>),
                       reinterpret_cast<const void*>(pass_kernel<true>),
                       reinterpret_cast<const void*>(pass_kernel<false>)};
  const size_t smem[] = {kChunkSmem, kChunkSmem, kPassSmem, kPassSmem};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t e = cudaFuncSetAttribute(
        fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem[i]));
    if (e != cudaSuccess) return e;
  }
  done[device] = true;
  return cudaSuccess;
}

bool bad_shape(int batch, int S, int H, int P, int N) {
  return batch < 1 || batch > 65535 || S < 1 || H < 1 || H > 65535 ||
         P < 1 || P > kMaxP || N < 1 || N > kMaxN;
}

}  // namespace

// C interface, loaded with ctypes.  float32 only.  Each returns the
// cudaError_t of its launch (0 = launched).  Scratch from the wrapper:
// states (b, h, chunks, p, n) and cums (b, h, chunks, 64), chunks =
// ceil(s / 64).  vec = 1: p and n multiples of 4 and x, B, C 16-byte
// aligned, so tiles are staged with 16-byte copies.
extern "C" {

int ssd_chunk_size() { return kQ; }

int ssd_chunk_launch(const void* x, const void* dt, const void* A,
                     const void* B, const void* C, void* y, void* states,
                     void* cums, int batch, int S, int H, int P, int N,
                     int vec, int device, void* stream) {
  if (bad_shape(batch, S, H, P, N)) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  e = ensure_smem(device);
  if (e != cudaSuccess) return e;
  const int nc = (S + kQ - 1) / kQ;
  auto kernel = vec ? chunk_kernel<true> : chunk_kernel<false>;
  kernel<<<dim3(nc, (H + kHeads - 1) / kHeads, batch), kThreads, kChunkSmem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y),
      static_cast<float*>(states), static_cast<float*>(cums), S, H, P, N, nc);
  return cudaGetLastError();
}

int ssd_pass_launch(const void* C, const void* states, const void* cums,
                    void* y, void* final_state, int batch, int S, int H,
                    int P, int N, int vec, int device, void* stream) {
  if (bad_shape(batch, S, H, P, N)) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  e = ensure_smem(device);
  if (e != cudaSuccess) return e;
  const int nc = (S + kQ - 1) / kQ;
  auto kernel = vec ? pass_kernel<true> : pass_kernel<false>;
  kernel<<<dim3((P + kSlice - 1) / kSlice, H, batch), kThreads, kPassSmem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(C), static_cast<const float*>(states),
      static_cast<const float*>(cums), static_cast<float*>(y),
      static_cast<float*>(final_state), S, H, P, N, nc);
  return cudaGetLastError();
}

}  // extern "C"
