// Flash attention (forward) for NVIDIA Hopper (sm_90a) on the tensor cores in
// TF32: float32 at any head dim, and bfloat16 at head dims the wgmma kernel
// (flash_attention_tc.cu) does not take (D % 8 != 0).
//
// Replaces the Pallas TPU kernel of the JAX package's
// src/repro/kernels/flash_attention.py: flash_attention (_flash_kernel).
// That kernel walks the kv blocks in grid order and carries its online
// softmax (acc, m, l) in VMEM scratch; here one CTA owns one (batch*head,
// 64-query tile) and walks the kv tiles in a loop, with the carry in
// registers.
//
// Shapes (row-major, contiguous): q, out (B, H, S, D); k, v (B, H, T, D);
// float32 or bfloat16, every sum in float32, out in q's type.  D <= 256;
// S, T and D need not be multiples of anything (ragged tiles are masked,
// the depth is zero-padded to a multiple of 8 in shared memory only).
// Queries are right-aligned: query i sits at position i + T - S.  causal
// keeps k <= q; window > 0 keeps k > q - window (with or without causal).
//
// What bounds it on the card: operations.  It does 4*S*T*D flops per head
// (fewer under a mask) on 2*(S+T)*D elements; on the CUDA cores float32
// could not pass their 67 TFLOP/s, so both products (S = Q K^T and
// O += P V) run as mma.sync m16n8k8 TF32 on the tensor cores.  One TF32 product keeps ~3 digits and misses
// the 3e-5 float32 agreement ~10-fold, so float32 operands are split 3xTF32
// as in ssd_scan.cu: v = hi + lo, hi = tf32(v) rounded to nearest, lo the
// exact rest (truncated by the tensor core), a b = lo hi + hi lo + hi hi.
// bfloat16 values are exact in TF32: Q K^T takes one product, P V two
// (P is float32, V exact).  Bound: 3 TF32 products a flop over 495 TFLOP/s.
// The design:
//   * 4 warps a CTA; a warp holds two 16-row m-tiles up to D = 72 (128
//     queries a CTA), so each K and V fragment, loaded and split once,
//     feeds two products; one above (64 queries), for registers.  Q, and
//     K and V tiles of 32 keys double-buffered, are staged in shared
//     memory with cp.async (16 bytes a copy where D and the pointers
//     allow), rows padded to a stride of 8 * NJ + 4 floats (= 4 mod 8,
//     stride / 4 odd), so a fragment's 32 loads fall in 32 banks.
//   * The online softmax runs on the score accumulators in registers, in
//     the log2 domain (scores scaled by log2(e) / sqrt(D), ex2.approx).
//   * P never leaves registers: an m16n8 accumulator holds columns (2t,
//     2t+1) of rows g and g + 8, and the A fragment of the next product
//     wants k-indices (t, t + 4).  The kernel takes columns 2t and 2t + 1
//     AS k-indices t and t + 4, and reads V's rows 2t and 2t + 1 for B's
//     k-indices t and t + 4: the same 8 keys summed in another order.
//   * kv tiles that the causal or window test kills for every row of the
//     query tile are not loaded at all (flash_attention.py:46-54);
//     flash_attention.live_key_tiles computes the same range.
//   * NEG_INF is the finite -1e30 of the JAX kernel, so a row whose first
//     live tile is fully masked (m = -1e30) is wiped by the next real tile
//     through alpha = exp(m_prev - m_new) = 0 instead of turning into NaN.
//     Columns past T (the ragged tail, which the TPU kernel never has) get
//     -inf, so they add exactly 0 even to such a row; V's rows past T are
//     zero in shared memory.
// No atomics: results are the same from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 4;        // 16 query rows (one m-tile) or 32 each
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// NJ = 8-wide depth steps the output accumulator holds (D <= 8 NJ).
// A warp holds two 16-row m-tiles up to D = 72 (a K or V fragment then
// serves two products), one above (registers).
template <int NJ>
__host__ __device__ constexpr int m_tiles() {
  return NJ <= 9 ? 2 : 1;
}
template <int NJ>
__host__ __device__ constexpr int query_tile() {
  return 16 * kWarps * m_tiles<NJ>();
}
template <int NJ>
__host__ __device__ constexpr int key_tile() {
  return 32;
}
template <int NJ>
__host__ __device__ constexpr int row_stride() {
  return 8 * NJ + 4;
}
template <int NJ>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(query_tile<NJ>() +
                                  4 * key_tile<NJ>()) *
         row_stride<NJ>();
}

// v = hi + lo: hi = tf32(v) rounded to nearest (ties away from zero) by
// integer ops; lo = v - hi exactly, handed over whole: the tensor core reads
// the top 19 bits of a tf32 operand, so lo is truncated to tf32 there.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// A fragment of m16n8k8 (16 x 8, row-major): a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); g = lane / 4, t = lane % 4.  For an
// operand exact in tf32 (bf16 inputs) only hi is set and used.
template <bool kExact>
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(int k, float v) {
    if constexpr (kExact)
      hi[k] = __float_as_uint(v);
    else
      split(v, hi[k], lo[k]);
  }
};
// B fragment (8 x 8, K x N): b0 (k = t, n = g), b1 (k = t + 4, n = g).
template <bool kExact>
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(int k, float v) {
    if constexpr (kExact)
      hi[k] = __float_as_uint(v);
    else
      split(v, hi[k], lo[k]);
  }
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b with the terms that are not zero: lo hi + hi lo + hi hi (the
// small ones first), without lo of an exact operand.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA<kExactA>& a,
                                     const FragB<kExactB>& b) {
  if constexpr (!kExactA) mma(d, a.lo, b.hi);
  if constexpr (!kExactB) mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
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
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [row0, row0 + kRows) of a (nrows, D) matrix into dst (row
// stride DS), columns [0, kCols); rows past nrows and columns past D are
// zero.  float: cp.async (16 bytes a copy when V: D % 4 == 0 and the
// pointer 16-byte aligned), bf16: converted on the way.  The trip count and
// the divisor are compile-time constants; the loop stays rolled (unrolled,
// it made the D > 128 kernels spill).
template <typename T, bool V, int kRows, int DS, int kCols>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int row0, int nrows, int D) {
  constexpr int W = V ? 4 : 1;
  constexpr int kPer = kCols / W;
  constexpr int kTrips = (kRows * kPer + kThreads - 1) / kThreads;
#pragma unroll 1
  for (int it = 0; it < kTrips; ++it) {
    const int i = it * kThreads + threadIdx.x;
    if (kRows * kPer % kThreads && i >= kRows * kPer) break;
    const int r = i / kPer, c = (i - r * kPer) * W;
    float* d = dst + r * DS + c;
    const bool live = row0 + r < nrows && c < D;
    const size_t at = (size_t)(row0 + r) * D + c;
    if constexpr (sizeof(T) == 4) {
      if (live) {
        if (V)
          cp16(d, reinterpret_cast<const float*>(src) + at);
        else
          cp4(d, reinterpret_cast<const float*>(src) + at);
        continue;
      }
    } else {
      if (live) {
        *d = __bfloat162float(src[at]);
        continue;
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) d[w] = 0.f;
  }
}

// 2^x from the SFU (ex2.approx, relative error ~2^-22; -inf -> 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ void store(T* p, float v);
template <>
__device__ __forceinline__ void store<float>(float* p, float v) {
  *p = v;
}
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* p,
                                                     float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int NJ, bool V>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int Tn,
                 int D, int causal, int window, float scale_log2) {
  constexpr bool kExact = sizeof(T) == 2;  // bf16: exact in tf32
  constexpr int MT = m_tiles<NJ>();        // 16-row m-tiles a warp
  constexpr int BQ = query_tile<NJ>();
  constexpr int BK = key_tile<NJ>();
  constexpr int NT = BK / 8;  // score n-tiles, and P V k-steps, a tile
  constexpr int DS = row_stride<NJ>();
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [BQ][DS]
  float* Ks = Qs + BQ * DS;      // [2][BK][DS]
  float* Vs = Ks + 2 * BK * DS;  // [2][BK][DS]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int dk = (D + 7) / 8;  // 8-wide depth steps
  const T* qb = q + bh * S * D;
  const T* kb = k + bh * Tn * D;
  const T* vb = v + bh * Tn * D;

  // the live key tiles (flash_attention.live_key_tiles)
  const int off = Tn - S;  // right-aligned query positions
  const int q_min = q0 + off;
  const int q_max = min(q0 + BQ, S) - 1 + off;
  int kt_end = (Tn + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_max < 0 ? 0 : q_max / BK + 1);
  const int kt_begin =
      window && q_min - window + 1 > 0 ? (q_min - window + 1) / BK : 0;

  stage<T, V, BQ, DS, 8 * NJ>(Qs, qb, q0, S, D);
  if (kt_begin < kt_end) {
    stage<T, V, BK, DS, 8 * NJ>(Ks, kb, kt_begin * BK, Tn, D);
    stage<T, V, BK, DS, 8 * NJ>(Vs, vb, kt_begin * BK, Tn, D);
  }
  cp_commit();

  // m-tile mt of this warp holds the tile's rows row0 + 16 mt + g (+ 8)
  const int row0 = warp * 16 * MT + g;
  float m[MT][2], l[MT][2];  // rows g, g + 8 (log2 domain); l: this
  float o[MT][NJ][4];        // thread's columns, summed at the end
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
  }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {  // the next tile into the other buffer
      stage<T, V, BK, DS, 8 * NJ>(Ks + (buf ^ 1) * BK * DS, kb,
                                  (kt + 1) * BK, Tn, D);
      stage<T, V, BK, DS, 8 * NJ>(Vs + (buf ^ 1) * BK * DS, vb,
                                  (kt + 1) * BK, Tn, D);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    // S = Q K^T, 16 MT rows x BK keys a warp; a K fragment serves every
    // m-tile
    const float* kt_s = Ks + buf * BK * DS;
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < dk; ++kk) {
      const int c = kk * 8 + t;
      FragA<kExact> a[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* qr = Qs + (row0 + 16 * mt) * DS + c;
        a[mt].set(0, qr[0]);
        a[mt].set(1, qr[8 * DS]);
        a[mt].set(2, qr[4]);
        a[mt].set(3, qr[8 * DS + 4]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* kr = kt_s + (n * 8 + g) * DS + c;
        FragB<kExact> b;
        b.set(0, kr[0]);
        b.set(1, kr[4]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma3(s[mt][n], a[mt], b);
      }
    }

    // masks and the online softmax; accumulator element e of m-tile mt
    // sits at row row0 + 16 mt + 8 (e >> 1), key k0 + 8 n + 2 t + (e & 1)
    const int k0 = kt * BK;
    const bool masked = k0 + BK > Tn || (causal && k0 + BK - 1 > q_min) ||
                        (window && k0 <= q_max - window);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][n][e] * scale_log2;
          if (masked) {
            const int kp = k0 + n * 8 + 2 * t + (e & 1);
            const int qp = q0 + row0 + 16 * mt + 8 * (e >> 1) + off;
            bool ok = true;
            if (causal) ok = ok && kp <= qp;
            if (window) ok = ok && kp > qp - window;
            x = kp >= Tn ? -INFINITY : (ok ? x : kNegInf);
          }
          s[mt][n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2_approx(m[mt][r] - mx[r]);
        m[mt][r] = mx[r];
        l[mt][r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(s[mt][n][e] - m[mt][e >> 1]);
          s[mt][n][e] = p;
          l[mt][e >> 1] += p;
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][j][e] *= alpha[e >> 1];
    }

    // O += P V: k-step n is score n-tile n; P's columns (2t, 2t + 1) are
    // the A fragment's k-indices (t, t + 4), V's rows 2t, 2t + 1 the B's;
    // a V fragment serves every m-tile
    const float* vt_s = Vs + buf * BK * DS;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      FragA<false> a[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt].set(0, s[mt][n][0]);
        a[mt].set(1, s[mt][n][2]);
        a[mt].set(2, s[mt][n][1]);
        a[mt].set(3, s[mt][n][3]);
      }
      const float* v0 = vt_s + (n * 8 + 2 * t) * DS + g;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < dk) {
          FragB<kExact> b;
          b.set(0, v0[j * 8]);
          b.set(1, v0[DS + j * 8]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma3(o[mt][j], a[mt], b);
        }
      }
    }
    __syncthreads();  // this buffer's reads are done before it is refilled
  }
  cp_wait<0>();

  T* ob = out + bh * S * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
      l[mt][r] = 1.f / fmaxf(l[mt][r], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= dk) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + row0 + 16 * mt + 8 * (e >> 1);
        const int c = j * 8 + 2 * t + (e & 1);
        if (r < S && c < D)
          store<T>(ob + (size_t)r * D + c, o[mt][j][e] * l[mt][e >> 1]);
      }
    }
  }
}

template <typename T, int NJ, bool V>
cudaError_t flash_impl(const void* q, const void* k, const void* v, void* out,
                       int BH, int S, int Tn, int D, int causal, int window,
                       cudaStream_t s) {
  constexpr size_t smem = smem_bytes<NJ>();
  static_assert(smem <= kMaxSmem, "tiles exceed a CTA's shared memory");
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, NJ, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + query_tile<NJ>() - 1) / query_tile<NJ>(), BH);
  flash_kernel<T, NJ, V><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tn, D, causal, window,
      kLog2e / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T, bool V>
cudaError_t flash_dispatch(const void* q, const void* k, const void* v,
                           void* out, int BH, int S, int Tn, int D, int causal,
                           int window, cudaStream_t s) {
#define FLASH(NJ) \
  flash_impl<T, NJ, V>(q, k, v, out, BH, S, Tn, D, causal, window, s)
  if (D <= 16) return FLASH(2);
  if (D <= 32) return FLASH(4);
  if (D <= 64) return FLASH(8);
  if (D <= 72) return FLASH(9);
  if (D <= 96) return FLASH(12);
  if (D <= 128) return FLASH(16);
  if (D <= 192) return FLASH(24);
  if (D <= 256) return FLASH(32);
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
  if (dtype == 1)
    return flash_dispatch<__nv_bfloat16, false>(q, k, v, out, BH, S, Tn, D,
                                                causal, window, s);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  return vec ? flash_dispatch<float, true>(q, k, v, out, BH, S, Tn, D, causal,
                                           window, s)
             : flash_dispatch<float, false>(q, k, v, out, BH, S, Tn, D,
                                            causal, window, s);
}
