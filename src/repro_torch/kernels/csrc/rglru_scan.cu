// RG-LRU linear scan h_t = a_t * h_{t-1} + b_t (h_{-1} = 0) for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package's
// src/repro/kernels/rglru_scan.py: rglru_scan_kernel (_rglru_kernel).  That
// kernel walks the time blocks in grid order and carries a (1, bc) state in
// VMEM; CUDA runs blocks in no order, so here the state crosses time tiles
// through device memory, in a fixed chain.
//
// Shapes (row-major, contiguous): a, b, h (B, S, C); float32 or bfloat16,
// the state and all arithmetic in float32, h written in a's type.  S and C
// need not be multiples of anything: the ragged edges are masked.
//
// What bounds it on the card: bytes.  It does 2 flops per element read
// (a, b) and written (h), far below the ridge, so the least time is
// 3 * B*S*C * elem bytes over 3.35 TB/s.  So it reads a and b once (a
// second pass over them would make 5 element transfers of the bound's 3,
// mostly from HBM at these sizes), 16 bytes a thread:
//   * A tile is (batch, 8 x 16 bytes of channels = 32 float32 or 64 bf16
//     channels, 256 steps).  Its 256 threads each load 8 consecutive steps
//     of 16 bytes of channels into registers (a warp reads 4 rows of 128
//     contiguous bytes a load) and compose their 8 steps' affine map
//     h -> A h + B per channel.
//   * The 32 maps of a channel are scanned across the tile in shared memory
//     (one warp a channel group, a shuffle scan in a fixed tree).
//   * The tile waits for its predecessor in time (same batch and channels,
//     the previous 256 steps) to publish its final state, applies its own
//     map (h_end = A h_prev + B) and publishes h_end: one 64-bit word per
//     channel holding (tag, state), written and polled whole, so no fence
//     is needed.  Tags are unique per call (the host passes a base), so the
//     words never need clearing.
//   * Each thread applies its exclusive prefix to h_prev and runs its 8
//     steps again from registers, writing h with 16-byte stores.
// The chain is fixed: a tile's state is h_prev, composed with its own map,
// whatever order tiles finish in, so two runs agree bit for bit.  Tiles are
// walked in segment-major order by a cooperative grid of as many CTAs as the
// card holds at once (cudaLaunchCooperativeKernel guarantees they are all
// resident), CTA c taking tiles c, c + grid, ...; a tile waits only on a
// smaller one, so the smallest unfinished tile can always go on.  No
// atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 8;                  // 16-byte channel groups a row
constexpr int kSubs = kThreads / kGroups;   // 32 sub-segments a tile
constexpr int kSteps = 8;                   // steps a thread holds
constexpr int kSeg = kSubs * kSteps;        // 256 steps a tile
constexpr int kMaxDevices = 64;

template <typename T>
struct Elem {
  static constexpr int kC = 16 / sizeof(T);   // channels in 16 bytes
  static constexpr uint32_t kOnes = sizeof(T) == 4 ? 0x3f800000u : 0x3f803f80u;
};

// channel i of 16 bytes, as float32 (bf16 -> f32 is exact)
template <typename T>
__device__ __forceinline__ float get(const uint4& u, int i) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float((&u.x)[i]);
  } else {
    const uint32_t w = (&u.x)[i >> 1];
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

template <typename T>
__device__ __forceinline__ void put(uint4& u, int i, float v);
template <>
__device__ __forceinline__ void put<float>(uint4& u, int i, float v) {
  (&u.x)[i] = __float_as_uint(v);
}
// the 16 bits of bf16 channel i
__device__ __forceinline__ void put_bits(uint4& u, int i, uint32_t h) {
  uint32_t& w = (&u.x)[i >> 1];
  w = (i & 1) ? ((w & 0xffffu) | (h << 16)) : ((w & 0xffff0000u) | h);
}
template <>
__device__ __forceinline__ void put<__nv_bfloat16>(uint4& u, int i, float v) {
  put_bits(u, i, __bfloat16_as_ushort(__float2bfloat16(v)));
}

// 16 bytes of channels [c, c + kC) of one row; past C: `fill`.  V: whole
// 16-byte vectors (C % kC == 0, pointers aligned), else element by element.
template <typename T, bool V>
__device__ __forceinline__ uint4 load(const T* __restrict__ row, int c, int C,
                                      uint32_t fill) {
  if constexpr (V) {
    return __ldcs(reinterpret_cast<const uint4*>(row + c));
  } else {
    const unsigned short* bits = reinterpret_cast<const unsigned short*>(row);
    uint4 u = make_uint4(fill, fill, fill, fill);
#pragma unroll
    for (int i = 0; i < Elem<T>::kC; ++i)
      if (c + i < C) {
        if constexpr (sizeof(T) == 4)
          (&u.x)[i] = __float_as_uint(reinterpret_cast<const float*>(row)[c + i]);
        else
          put_bits(u, i, bits[c + i]);
      }
    return u;
  }
}

template <typename T, bool V>
__device__ __forceinline__ void store(T* __restrict__ row, int c, int C,
                                      const uint4& u) {
  if constexpr (V) {
    __stcs(reinterpret_cast<uint4*>(row + c), u);
  } else {
#pragma unroll
    for (int i = 0; i < Elem<T>::kC; ++i)
      if (c + i < C) {
        if constexpr (sizeof(T) == 4)
          reinterpret_cast<float*>(row)[c + i] = __uint_as_float((&u.x)[i]);
        else
          reinterpret_cast<unsigned short*>(row)[c + i] =
              static_cast<unsigned short>((&u.x)[i >> 1] >> (16 * (i & 1)));
      }
  }
}

__device__ __forceinline__ unsigned long long poll(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

template <typename T, bool V>
__global__ void __launch_bounds__(kThreads, 2)
    rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ h, unsigned long long* __restrict__ words,
                 int B, int S, int C, int nseg, int ncb, uint32_t tag) {
  constexpr int kC = Elem<T>::kC;
  constexpr int CB = kGroups * kC;  // channels a tile
  constexpr int LD = CB + 1;        // shared row stride (column reads)
  __shared__ float sA[kSubs * LD], sB[kSubs * LD];
  __shared__ float totA[CB], totB[CB], hin[CB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ts = tid / kGroups, cg = tid % kGroups;
  const int chains = B * ncb;
  const int tiles = chains * nseg;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int seg = tile / chains;
    const int chain = tile - seg * chains;
    const int bi = chain / ncb, cb = chain - bi * ncb;
    const int c0 = cb * CB + cg * kC;  // this thread's first channel
    const int t0 = seg * kSeg + ts * kSteps;
    const size_t base = (size_t)bi * S * C;
    const bool cols = c0 < C;

    // 1. load 8 steps (identity past S or C) and compose their maps
    uint4 ra[kSteps], rb[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (cols && t0 + i < S) {
        const size_t at = base + (size_t)(t0 + i) * C;
        ra[i] = load<T, V>(a + at, c0, C, Elem<T>::kOnes);
        rb[i] = load<T, V>(b + at, c0, C, 0u);
      } else {
        ra[i] = make_uint4(Elem<T>::kOnes, Elem<T>::kOnes, Elem<T>::kOnes,
                           Elem<T>::kOnes);
        rb[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      float A = 1.f, Bv = 0.f;
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        const float at = get<T>(ra[i], j);
        Bv = at * Bv + get<T>(rb[i], j);
        A *= at;
      }
      sA[ts * LD + cg * kC + j] = A;
      sB[ts * LD + cg * kC + j] = Bv;
    }
    __syncthreads();

    // 2. scan the 32 sub-segment maps of each channel (lane = sub-segment);
    // keep the exclusive prefix, and the tile's whole map
    for (int c = warp; c < CB; c += kThreads / 32) {
      float A = sA[lane * LD + c], Bv = sB[lane * LD + c];
#pragma unroll
      for (int d = 1; d < kSubs; d <<= 1) {
        const float Au = __shfl_up_sync(0xffffffffu, A, d);
        const float Bu = __shfl_up_sync(0xffffffffu, Bv, d);
        if (lane >= d) {
          Bv = A * Bu + Bv;
          A *= Au;
        }
      }
      const float Ae = __shfl_up_sync(0xffffffffu, A, 1);
      const float Be = __shfl_up_sync(0xffffffffu, Bv, 1);
      sA[lane * LD + c] = lane ? Ae : 1.f;
      sB[lane * LD + c] = lane ? Be : 0.f;
      if (lane == kSubs - 1) {
        totA[c] = A;
        totB[c] = Bv;
      }
    }
    __syncthreads();

    // 3. the chain: wait for the previous segment's state, publish ours
    if (warp == 0) {
      for (int c = lane; c < CB; c += 32) {
        const int gc = cb * CB + c;
        float hp = 0.f;
        if (gc < C) {
          unsigned long long* w = words + (size_t)bi * C + gc;
          if (seg > 0) {
            const unsigned long long want = tag + (uint32_t)seg;
            unsigned long long x;
            do {
              x = poll(w);
            } while ((x >> 32) != want);
            hp = __uint_as_float(static_cast<uint32_t>(x));
          }
          if (seg + 1 < nseg) {
            const float he = totA[c] * hp + totB[c];
            publish(w, ((unsigned long long)(tag + (uint32_t)seg + 1u) << 32) |
                           __float_as_uint(he));
          }
        }
        hin[c] = hp;
      }
    }
    __syncthreads();

    // 4. carry in, then the 8 steps again from registers, writing h
    if (cols) {
      float hv[kC];
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int c = cg * kC + j;
        hv[j] = sA[ts * LD + c] * hin[c] + sB[ts * LD + c];
      }
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        if (t0 + i >= S) break;
        uint4 u;
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          hv[j] = get<T>(ra[i], j) * hv[j] + get<T>(rb[i], j);
          put<T>(u, j, hv[j]);
        }
        store<T, V>(h + base + (size_t)(t0 + i) * C, c0, C, u);
      }
    }
    __syncthreads();  // shared maps are read before the next tile's writes
  }
}

// info[0..3) <- CTAs launched, tiles, CTAs the card holds at once.
template <typename T, bool V>
cudaError_t rglru_impl(const void* a, const void* b, void* h, void* words,
                       unsigned tag, int* info, int B, int S, int C,
                       cudaStream_t s) {
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
        &per_sm, rglru_kernel<T, V>, kThreads, 0);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  constexpr int CB = kGroups * Elem<T>::kC;
  int ncb = (C + CB - 1) / CB;
  int nseg = (S + kSeg - 1) / kSeg;
  const long long tiles = (long long)B * ncb * nseg;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < resident[dev] ? tiles : resident[dev]);
  info[0] = grid;
  info[1] = static_cast<int>(tiles);
  info[2] = resident[dev];
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* hp = static_cast<T*>(h);
  unsigned long long* wp = static_cast<unsigned long long*>(words);
  uint32_t tg = tag;
  void* args[] = {&ap, &bp, &hp, &wp, &B, &S, &C, &nseg, &ncb, &tg};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(rglru_kernel<T, V>),
                                     dim3(grid), dim3(kThreads), args, 0, s);
}

template <typename T>
cudaError_t rglru_dispatch(const void* a, const void* b, void* h, void* words,
                           unsigned tag, int* info, int B, int S, int C,
                           cudaStream_t s) {
  const bool vec = C % Elem<T>::kC == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(h) % 16 == 0;
  return vec ? rglru_impl<T, true>(a, b, h, words, tag, info, B, S, C, s)
             : rglru_impl<T, false>(a, b, h, words, tag, info, B, S, C, s);
}

}  // namespace

// C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// words: B * C 64-bit words of device scratch whose tags are all below
// `tag` (zeros at first); a call uses tags tag .. tag + ceil(S / 256).
// info[0..3) <- CTAs launched, tiles, CTAs co-resident.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int rglru_scan_launch(const void* a, const void* b, void* h,
                                 void* words, unsigned tag, int* info, int B,
                                 int S, int C, int dtype, int device,
                                 void* stream) {
  if (B < 1 || S < 1 || C < 1 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? rglru_dispatch<float>(a, b, h, words, tag, info, B, S, C, s)
             : rglru_dispatch<__nv_bfloat16>(a, b, h, words, tag, info, B, S,
                                             C, s);
}
