// GQA flash decode (one new token against a KV cache) for NVIDIA Hopper
// (sm_90a), split over the cache (flash-decoding).
//
// Replaces the Pallas TPU kernel of the JAX package's
// src/repro/kernels/flash_decode.py: flash_decode (_decode_kernel).  That
// kernel walks the cache's blocks in grid order and carries its online
// softmax (acc, m, l) in VMEM.  Here the cache of one (batch row, KV head)
// is cut into `splits` contiguous ranges of `chunk` keys, one block each,
// and a second pass merges the blocks' partial softmax states.
//
// Shapes (row-major, contiguous): q, out (B, H, D); k, v (B, T, KV, D);
// k_scale, v_scale (B, T, KV) float32 for an int8 cache; lengths (B,) int32.
// q is float32 or bfloat16; the cache is q's type or int8.  G = H / KV <= 16
// query heads share each cache head, q head kv*G + g reading cache head kv,
// as the JAX kernel groups them.  D <= 256.  Scores, softmax and sums are
// float32; out is in q's type.
//
// What bounds it on the card: bytes.  Every live key and value is read once
// and used for G heads: about 2G flops per byte of a float32 cache (4G for
// int8), below the float32 ridge for every G <= 16, so the least time is the
// cache bytes of the live prefix over 3.35 TB/s.  What the design does:
//   * Split pass, grid (KV, splits, B), 4 warps a block; the KV heads of
//     one key range run side by side and share the cache's DRAM pages.  The
//     wrapper picks `splits` (split_plan in flash_decode.py) so that there
//     are at least about 2 x 132 blocks and no range holds more than 512
//     keys.  A block whose range starts at or after lengths[b] writes the
//     empty partial (m = -1e30, l = 0, acc = 0) and exits.
//   * Loads are coalesced and 16 bytes wide: L lanes read one key row
//     (L = row bytes / 16, rounded up to a power of two, at most 32; a
//     D = 128 bf16 row is 16 lanes x 16 B), so a warp reads 32 / L rows at
//     once; each row group loads its next 4 rows (2 when G > 8) while it
//     uses the current ones.  An int8 row is read as int8 and dequantised
//     in registers with its (t, kv) scale.  Rows of other widths, or caches
//     not 16-byte aligned, take one element a lane.
//   * Each row group of L lanes keeps its own online-softmax state (m, l and
//     its slice of the (G, D) accumulator) in registers over its keys; the
//     scores for the G heads come from shuffle reductions over the L lanes,
//     with q in shared memory laid out so that a row group's lanes read
//     consecutive words (no bank conflicts).  No barrier inside the key
//     loop.  Scores are kept in log2 units (log2(e) is folded into the
//     1/sqrt(D) scale), so each exponential is one ex2.approx.
//   * The row groups of a warp merge by xor shuffles (each pair computes the
//     same sums in the same order), the warps through shared memory in warp
//     order, after the loop's one barrier.
//   * Combine pass, one warp per (b, kv, g, 32 columns): merges the split
//     partials in split order, out = acc / max(l, 1e-30).  With splits == 1 the split
//     pass writes out itself and no combine is launched.
//   * NEG_INF is the finite -1e30 of the JAX kernel.  Keys past the range or
//     the row's length add exactly 0 (p = 0), so a state that saw no live
//     key stays (m = -1e30, l = 0, acc = 0) and merges as 0.
//   * lengths == 0: every block is empty and out is 0 (acc / max(l, 1e-30)),
//     as in the TPU kernel; the plain decode_ref instead returns the mean of
//     v (softmax of all-masked scores).  Callers pass lengths >= 1.
// Measured on the H100 (PERF.md), the split pass is bound by the
// latency of each step's instructions, not by bytes: its time follows the
// rows each warp walks (every row costs G dot products, G shuffle
// reductions and G softmax updates on the CUDA cores).
// No atomics: every sum has a fixed order, so results are the same from run
// to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// Raises a kernel's dynamic shared-memory limit to `bytes` on the current
// device, calling the runtime only when the limit this library set there
// before is lower (the call costs host time at every launch otherwise).
// `done` is the kernel's own array, one entry per device.
constexpr int kMaxDevices = 64;
cudaError_t raise_smem_limit(const void* kernel, size_t bytes,
                             std::atomic<int>* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int want = static_cast<int>(bytes);
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && done[dev].load(std::memory_order_relaxed) >= want)
    return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           want);
  if (e == cudaSuccess && cached) {
    int cur = done[dev].load();
    while (cur < want && !done[dev].compare_exchange_weak(cur, want)) {
    }
  }
  return e;
}

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

// VEC elements of a row as one load: 16 bytes (uint4) on the vector path,
// one element on the scalar path.
template <typename KVT, int VEC>
struct Raw {
  using type = typename std::conditional<VEC * sizeof(KVT) == 16, uint4,
                                         KVT>::type;
};

template <typename KVT, int VEC>
__device__ __forceinline__ typename Raw<KVT, VEC>::type load_raw(
    const KVT* p) {
  if constexpr (VEC * sizeof(KVT) == 16) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    static_assert(VEC == 1, "vector loads are 16 bytes");
    return *p;
  }
}

template <typename KVT, int VEC>
__device__ __forceinline__ typename Raw<KVT, VEC>::type zero_raw() {
  if constexpr (VEC * sizeof(KVT) == 16) {
    return make_uint4(0u, 0u, 0u, 0u);
  } else {
    return KVT(0);
  }
}

template <typename KVT, int VEC>
__device__ __forceinline__ void unpack(typename Raw<KVT, VEC>::type r,
                                       float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = to_f32(r);
  } else {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    if constexpr (sizeof(KVT) == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
    } else if constexpr (sizeof(KVT) == 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          f[4 * i + j] = static_cast<float>(
              static_cast<int8_t>((w[i] >> (8 * j)) & 0xffu));
    }
  }
}

// 2^x by the SFU (ex2.approx: about 2 ulp).  Scores are kept in log2 units
// (the 1/sqrt(D) scale carries log2(e)), so every exponential is one ex2.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online-softmax merge of (m_o, l_o, acc_o) into (m, l, acc) with the same
// arithmetic for both operands, so two lanes merging each other's states get
// the same bits.
__device__ __forceinline__ void merge_weights(float m, float m_o, float& a,
                                              float& c, float& mn) {
  mn = fmaxf(m, m_o);
  a = exp2_approx(m - mn);
  c = exp2_approx(m_o - mn);
}

// Per-row-group state: m, l per head, acc[g][NV*VEC] per lane.
template <typename Q, typename KVT, int VEC, int NV, int GM>
__global__ void __launch_bounds__(kThreads)
    split_kernel(const Q* __restrict__ q, const KVT* __restrict__ k,
                 const KVT* __restrict__ v, const float* __restrict__ ks,
                 const float* __restrict__ vs,
                 const int* __restrict__ lengths, Q* __restrict__ out,
                 float* __restrict__ part_acc, float* __restrict__ part_m,
                 float* __restrict__ part_l, int T, int KV, int G, int D,
                 int L, int chunk, int splits, float scale) {
  constexpr int E = NV * VEC;             // elements a lane owns per row
  constexpr int U = GM > 8 ? 2 : 4;       // rows a step per row group
  using RawT = typename Raw<KVT, VEC>::type;
  // shared: q, lane-interleaved (below) | per warp: m (G), l (G), acc (G, D)
  // | the warps' merge weights (kWarps, G), m (G), l (G)
  extern __shared__ float smem[];
  float* q_s = smem;
  float* w_s = q_s + G * NV * VEC * L;
  const int GD = G * D;
  const int kvh = blockIdx.x;  // KV fastest: neighbouring blocks share rows
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t H = (size_t)KV * G;
  const size_t head0 = ((size_t)b * H + (size_t)kvh * G) * D;
  const size_t part = ((size_t)b * KV + kvh) * splits + split;
  const int len = min(lengths[b], T);
  const int lo = split * chunk;
  const int hi = min(lo + chunk, len);

  if (lo >= len) {  // the empty partial (out = 0 when there is no combine)
    for (int i = tid; i < GD; i += kThreads) {
      if (splits == 1)
        out[head0 + i] = from_f32<Q>(0.f);
      else
        part_acc[part * GD + i] = 0.f;
    }
    if (splits > 1)
      for (int g = tid; g < G; g += kThreads) {
        part_m[part * G + g] = kNegInf;
        part_l[part * G + g] = 0.f;
      }
    return;
  }

  // q element d = (n*L + j)*VEC + e of head g, the one lane j of a row
  // group multiplies, sits at ((g*NV + n)*VEC + e)*L + j: the L lanes read
  // L consecutive words, free of bank conflicts
  const int lg_l = __ffs(L) - 1;
  for (int g = 0; g < G; ++g)
    for (int d = tid; d < D; d += kThreads) {
      const int vv = d / VEC, e = d % VEC;
      const int n = vv >> lg_l, jj = vv & (L - 1);
      q_s[((g * NV + n) * VEC + e) * L + jj] = to_f32(q[head0 + g * D + d]);
    }
  __syncthreads();

  const int R = 32 / L;           // row groups per warp
  const int NR = kWarps * R;      // row groups per block
  const int rg = lane / L;
  const int j = lane - rg * L;    // lane within its row group
  const int gr = warp * R + rg;
  const size_t row = (size_t)KV * D;  // elements between cache rows t, t+1
  const KVT* kb = k + (size_t)b * T * row + (size_t)kvh * D;
  const KVT* vb = v + (size_t)b * T * row + (size_t)kvh * D;
  const float* ksb = ks ? ks + (size_t)b * T * KV + kvh : nullptr;
  const float* vsb = vs ? vs + (size_t)b * T * KV + kvh : nullptr;

  int e0[NV];  // first element of each vector this lane owns (D if none)
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int e = (n * L + j) * VEC;
    e0[n] = e < D ? e : D;
  }

  float m[GM], l[GM], acc[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  // step: U rows per row group; key (u, gr) of the step at sb is
  // sb + u*NR + gr, so the block reads NR neighbouring rows at each u.  The
  // next step's rows are loaded before this step's are used, so a row
  // group always has two steps of loads in flight.
  RawT kr[U][NV], vr[U][NV];
  float ksc[U], vsc[U];
  auto load_step = [&](int sb, RawT(&kd)[U][NV], RawT(&vd)[U][NV],
                       float(&kscd)[U], float(&vscd)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = sb + u * NR + gr;
      const bool ok = t < hi;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const bool live = ok && e0[n] < D;
        kd[u][n] = live ? load_raw<KVT, VEC>(kb + (size_t)t * row + e0[n])
                        : zero_raw<KVT, VEC>();
        vd[u][n] = live ? load_raw<KVT, VEC>(vb + (size_t)t * row + e0[n])
                        : zero_raw<KVT, VEC>();
      }
      kscd[u] = ksb && ok ? ksb[(size_t)t * KV] * scale : scale;
      vscd[u] = vsb && ok ? vsb[(size_t)t * KV] : 1.f;
    }
  };
  load_step(lo, kr, vr, ksc, vsc);
  for (int sb = lo; sb + warp * R < hi; sb += NR * U) {
    RawT kn[U][NV], vn[U][NV];
    float kscn[U], vscn[U];
    load_step(sb + NR * U, kn, vn, kscn, vscn);
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) ok[u] = sb + u * NR + gr < hi;

    // scores: partial dots over this lane's elements (each q element read
    // once for the step's U rows), then the row group's shuffle sums
    float s[U][GM];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < GM; ++g) s[u][g] = 0.f;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      if (e0[n] >= D) continue;
      float kf[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) unpack<KVT, VEC>(kr[u][n], kf[u]);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        const float* qg = q_s + (g * NV + n) * VEC * L + j;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float qe = qg[e * L];
#pragma unroll
          for (int u = 0; u < U; ++u) s[u][g] += qe * kf[u][e];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        for (int off = L >> 1; off > 0; off >>= 1)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
      }

    // online softmax over the step's live rows (p = 0 for the others)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][g] *= ksc[u];
        if (ok[u]) mx = fmaxf(mx, s[u][g]);
      }
      const float alpha = exp2_approx(m[g] - mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][g] = ok[u] ? exp2_approx(s[u][g] - mx) : 0.f;
        sum += s[u][g];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float vf[VEC];
        unpack<KVT, VEC>(vr[u][n], vf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) break;
          const float p = s[u][g] * vsc[u];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][n * VEC + e] += p * vf[e];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ksc[u] = kscn[u];
      vsc[u] = vscn[u];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        kr[u][n] = kn[u][n];
        vr[u][n] = vn[u][n];
      }
    }
  }

  // merge the row groups of this warp (lanes j, j ^ L, ...)
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
      float a, c, mn;
      merge_weights(m[g], m_o, a, c, mn);
      m[g] = mn;
      l[g] = l[g] * a + l_o * c;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float o = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + o * c;
      }
    }
  }

  // then the warps, through shared memory in warp order
  float* mine = w_s + (size_t)warp * (2 * G + GD);
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      if (j == 0) {
        mine[g] = m[g];
        mine[G + g] = l[g];
      }
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (e0[n] + e < D) mine[2 * G + g * D + e0[n] + e] = acc[g][n * VEC + e];
    }
  }
  __syncthreads();
  // each head's weights of the warps' states, f = exp(m_w - m), and its l
  float* f_s = w_s + kWarps * (2 * G + GD);  // (kWarps, G) | m (G) | l (G)
  for (int g = tid; g < G; g += kThreads) {
    float mt = kNegInf;
    for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, w_s[w * (2 * G + GD) + g]);
    float l_sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* ws = w_s + w * (2 * G + GD);
      const float f = exp2_approx(ws[g] - mt);
      f_s[w * G + g] = f;
      l_sum += ws[G + g] * f;
    }
    f_s[kWarps * G + g] = mt;
    f_s[(kWarps + 1) * G + g] = l_sum;
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    const float l_sum = f_s[(kWarps + 1) * G + g];
    for (int d = tid; d < D; d += kThreads) {
      float a_sum = 0.f;
      for (int w = 0; w < kWarps; ++w)
        a_sum += w_s[w * (2 * G + GD) + 2 * G + g * D + d] * f_s[w * G + g];
      if (splits == 1)
        out[head0 + g * D + d] = from_f32<Q>(a_sum / fmaxf(l_sum, 1e-30f));
      else
        part_acc[part * GD + g * D + d] = a_sum;
    }
  }
  if (splits > 1)
    for (int g = tid; g < G; g += kThreads) {
      part_m[part * G + g] = f_s[kWarps * G + g];
      part_l[part * G + g] = f_s[(kWarps + 1) * G + g];
    }
}

// Merges the split partials in split order: one warp per (b, kv, g, 32
// columns of d), grid (G * ceil(D / 32), KV, B).  The splits' m and l are
// staged in shared memory and their weights 2^(m_s - m) computed once.
template <typename Q>
__global__ void __launch_bounds__(32)
    combine_kernel(const float* __restrict__ part_acc,
                   const float* __restrict__ part_m,
                   const float* __restrict__ part_l, Q* __restrict__ out,
                   int KV, int G, int D, int splits) {
  extern __shared__ float c_s[];  // m (splits) | l (splits) | weight (splits)
  float* m_s = c_s;
  float* l_s = m_s + splits;
  float* f_s = l_s + splits;
  const int dc = (D + 31) / 32;
  const int g = blockIdx.x / dc;
  const int d = (blockIdx.x - g * dc) * 32 + threadIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const size_t p0 = ((size_t)b * KV + kvh) * splits;
  for (int s = threadIdx.x; s < splits; s += 32) {
    m_s[s] = part_m[(p0 + s) * G + g];
    l_s[s] = part_l[(p0 + s) * G + g];
  }
  __syncwarp();
  float mt = kNegInf;
  for (int s = 0; s < splits; ++s) mt = fmaxf(mt, m_s[s]);
  for (int s = threadIdx.x; s < splits; s += 32)
    f_s[s] = exp2_approx(m_s[s] - mt);
  __syncwarp();
  if (d >= D) return;
  float l_sum = 0.f;
  for (int s = 0; s < splits; ++s) l_sum += l_s[s] * f_s[s];
  const float* pa = part_acc + (p0 * G + g) * D + d;
  const size_t stride = (size_t)G * D;  // between splits
  float a_sum = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) a_sum += pa[s * stride] * f_s[s];
  out[((size_t)b * KV * G + (size_t)kvh * G + g) * D + d] =
      from_f32<Q>(a_sum / fmaxf(l_sum, 1e-30f));
}

template <typename Q, typename KVT, int VEC, int NV, int GM>
cudaError_t split_launch(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* lengths,
                         void* out, float* pa, float* pm, float* pl, int B,
                         int KV, int G, int T, int D, int L, int chunk,
                         int splits, cudaStream_t s) {
  const size_t smem = (size_t)(G * NV * VEC * L + kWarps * (2 * G + G * D) +
                              (kWarps + 2) * G) * sizeof(float);
  auto kernel = split_kernel<Q, KVT, VEC, NV, GM>;
  static std::atomic<int> smem_set[kMaxDevices];
  if (smem > kDefaultSmem) {
    const cudaError_t e = raise_smem_limit(
        reinterpret_cast<const void*>(kernel), smem, smem_set);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(KV, splits, B), kThreads, smem, s>>>(
      static_cast<const Q*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lengths),
      static_cast<Q*>(out), pa, pm, pl, T, KV, G, D, L, chunk, splits,
      1.4426950408889634f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename Q, typename KVT, int VEC, int NV>
cudaError_t by_group(int G, const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const void* lengths,
                     void* out, float* pa, float* pm, float* pl, int B, int KV,
                     int T, int D, int L, int chunk, int splits,
                     cudaStream_t s) {
#define SPLIT(GM)                                                          \
  split_launch<Q, KVT, VEC, NV, GM>(q, k, v, ks, vs, lengths, out, pa, pm, \
                                    pl, B, KV, G, T, D, L, chunk, splits, s)
  if (G <= 2) return SPLIT(2);
  if (G <= 4) return SPLIT(4);
  if (G <= 8) return SPLIT(8);
  if (G <= 12) return SPLIT(12);
  return SPLIT(16);
#undef SPLIT
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The lane layout: the vector path when a row is whole 16-byte vectors and
// the caches are 16-byte aligned (L lanes a row, NV vectors a lane), else
// one element a lane (L = 32, NV = ceil(D / 32)).
template <typename Q, typename KVT>
cudaError_t split_dispatch(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs, const void* lengths,
                           void* out, float* pa, float* pm, float* pl, int B,
                           int KV, int G, int T, int D, int chunk, int splits,
                           cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(KVT);
  const bool vec = D % VEC == 0 && aligned16(k) && aligned16(v);
  if (vec) {
    const int nvec = D / VEC;
    int L = 1;
    while (L < nvec && L < 32) L <<= 1;
    if (nvec <= 32)
      return by_group<Q, KVT, VEC, 1>(G, q, k, v, ks, vs, lengths, out, pa,
                                      pm, pl, B, KV, T, D, L, chunk, splits, s);
    if constexpr (VEC == 4)  // float32 rows of 33..64 vectors (D <= 256)
      return by_group<Q, KVT, VEC, 2>(G, q, k, v, ks, vs, lengths, out, pa,
                                      pm, pl, B, KV, T, D, 32, chunk, splits,
                                      s);
    return cudaErrorInvalidValue;
  }
  return by_group<Q, KVT, 1, kMaxD / 32>(G, q, k, v, ks, vs, lengths, out, pa,
                                         pm, pl, B, KV, T, D, 32, chunk,
                                         splits, s);
}

}  // namespace

// C interface, loaded with ctypes.  q_dtype: 0 = float32, 1 = bfloat16;
// kv_dtype: 0 = float32, 1 = bfloat16, 2 = int8 (k_scale/v_scale given,
// else they are null).  part_acc (B, KV, splits, G, D), part_m and part_l
// (B, KV, splits, G) float32 scratch, unused (may be null) when splits == 1.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* lengths, void* out,
                                   void* part_acc, void* part_m, void* part_l,
                                   int B, int H, int KV, int T, int D,
                                   int chunk, int splits, int q_dtype,
                                   int kv_dtype, int device, void* stream) {
  if (B < 1 || KV < 1 || H < KV || H % KV != 0 || H / KV > kMaxG || T < 1 ||
      D < 1 || D > kMaxD || B > 65535 || KV > 65535 || chunk < 1 ||
      splits < 1 || splits > 65535 || (long long)chunk * (splits - 1) >= T ||
      (long long)chunk * splits < T)
    return cudaErrorInvalidValue;
  const bool quant = kv_dtype == 2;
  if (quant != (k_scale != nullptr && v_scale != nullptr))
    return cudaErrorInvalidValue;
  if (splits > 1 && (!part_acc || !part_m || !part_l))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
#define DECODE(QT, KT)                                                     \
  split_dispatch<QT, KT>(q, k, v, k_scale, v_scale, lengths, out, pa, pm, \
                         pl, B, KV, G, T, D, chunk, splits, s)
  if (q_dtype == 0 && kv_dtype == 0) return DECODE(float, float);
  if (q_dtype == 1 && kv_dtype == 1) return DECODE(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 0 && kv_dtype == 2) return DECODE(float, int8_t);
  if (q_dtype == 1 && kv_dtype == 2) return DECODE(__nv_bfloat16, int8_t);
#undef DECODE
  return cudaErrorInvalidValue;
}

// The combine pass over the split pass's partials (splits > 1).
extern "C" int flash_decode_combine_launch(const void* part_acc,
                                           const void* part_m,
                                           const void* part_l, void* out,
                                           int B, int H, int KV, int D,
                                           int splits, int q_dtype, int device,
                                           void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > kMaxG || D < 1 ||
      D > kMaxD || splits < 2 || B > 65535 || KV > 65535)
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(H / KV * ((D + 31) / 32), KV, B);
  const size_t smem = 3 * (size_t)splits * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const float* pa = static_cast<const float*>(part_acc);
  const float* pm = static_cast<const float*>(part_m);
  const float* pl = static_cast<const float*>(part_l);
  static std::atomic<int> smem_set[2][kMaxDevices];
  cudaError_t a = cudaSuccess;
  if (q_dtype == 0) {
    if (smem > kDefaultSmem)
      a = raise_smem_limit(
          reinterpret_cast<const void*>(combine_kernel<float>), smem,
          smem_set[0]);
    if (a != cudaSuccess) return a;
    combine_kernel<float><<<grid, 32, smem, s>>>(
        pa, pm, pl, static_cast<float*>(out), KV, H / KV, D, splits);
  } else if (q_dtype == 1) {
    if (smem > kDefaultSmem)
      a = raise_smem_limit(
          reinterpret_cast<const void*>(combine_kernel<__nv_bfloat16>), smem,
          smem_set[1]);
    if (a != cudaSuccess) return a;
    combine_kernel<__nv_bfloat16><<<grid, 32, smem, s>>>(
        pa, pm, pl, static_cast<__nv_bfloat16*>(out), KV, H / KV, D, splits);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
