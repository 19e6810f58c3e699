// Flash attention (forward) in bf16 on Hopper's tensor cores (sm_90a):
// wgmma for both products, TMA for the tiles.
//
// Replaces the Pallas TPU kernel of the JAX package's
// src/repro/kernels/flash_attention.py: flash_attention (_flash_kernel),
// for bfloat16 inputs whose rows are whole 16-byte vectors (D % 8 == 0,
// D <= 256).  float32, and bfloat16 at other D, stay on the CUDA-core kernel
// of flash_attention.cu; the wrapper (flash_attention.py, attention_path)
// picks one by dtype and D.
//
// Shapes (row-major, contiguous, 16-byte aligned): q, out (BH, S, D); k, v
// (BH, T, D), bfloat16.  Queries are right-aligned: query i sits at position
// i + T - S.  causal keeps k <= q; window > 0 keeps k > q - window.
//
// What bounds it on the card: operations, 4*S*T*D flops per head (about
// half under a causal mask) at the 989 TFLOP/s bf16 tensor-core rate.  What
// the design does about it:
//   * One block per (b*h, 128 query rows): two consumer warpgroups own 64
//     rows each, a producer warpgroup (one thread of it) starts the loads
//     and hands its registers to the consumers (setmaxnreg: 240 a consumer
//     thread, room for O at D = 256).  Blocks start longest first (the
//     last query tiles, under a causal mask, see the most keys), all heads
//     of a tile together.
//   * S = Q K^T by wgmma.mma_async m64nBKk16 with Q and K read from shared
//     memory through wgmma descriptors; O += P V by wgmma m64nDPk16 with P
//     as the register A operand (converted to bf16 in registers: the one
//     rounding the JAX kernel, which keeps P in float32, does not have) and
//     V from shared memory, transposed (MN-major).  Accumulation in float32.
//   * Tiles arrive by TMA (cp.async.bulk.tensor.3d, tensor maps built on the
//     host through cudaGetDriverEntryPoint, so nothing links -lcuda) into a
//     ring of 2 K/V stages guarded by mbarriers: tile n+1 loads while tile
//     n is multiplied.  Boxes are 64 bf16 (128 bytes) along D with 128-byte
//     swizzle, matching the descriptors' swizzle mode; D is padded to DP (64,
//     128 or 256) by TMA's out-of-bounds zero fill, as are ragged S and T
//     tiles, so nothing is padded in memory.
//   * Key tiles of BK = 128 at D <= 128; BK = 64 at D > 128, so that O
//     (64 x 256 float32 a warpgroup) and the 192 KB of shared memory fit.
//   * The online softmax runs in registers on the wgmma accumulator: each
//     thread holds 2 rows, row max and sum by quad shuffles, exp2 with the
//     scale folded into log2 units.
//   * Masks are applied to S in registers: NEG_INF is the finite -1e30 of
//     the JAX kernel (a row whose first live tile is fully masked is wiped
//     by the next tile through alpha = 0), columns past T get -inf.  Key
//     tiles that the causal or window test kills for every row of the query
//     tile are never loaded (flash_attention.py:46-54 of the JAX package).
//     out = O / max(l, 1e-30).
// No atomics: results are the same from run to run.
#include <cuda.h>  // CUtensorMap and its enums (header only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBQ = 128;                   // query rows a block
constexpr int kStages = 2;                 // K/V ring
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
// registers a thread after setmaxnreg: the producer gives up what the
// consumers take (128 x (168 - 24) = 256 x (240 - 168))
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA ------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// --- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFFull) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// D (64 x 64, float32) = A (64 x 16) * B (64 x 16)^T + (scale_d ? D : 0),
// A and B bf16 in shared memory, both K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, float32) = A (64 x 16) * B (128 x 16)^T + (scale_d ? D : 0),
// A and B bf16 in shared memory, both K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 16, bf16 in registers) * B (16 x 64),
// B bf16 in shared memory, MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, float32) += A (64 x 16, bf16 in registers) * B (16 x 128),
// B bf16 in shared memory, MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, float32) += A (64 x 16, bf16 in registers) * B (16 x 256),
// B bf16 in shared memory, MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
      "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
      "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
      "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
      "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int BK>
__device__ __forceinline__ void wgmma_ss(float (&d)[BK / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BK == 64)
    wgmma_ss_n64(d, da, db, scale_d);
  else
    wgmma_ss_n128(d, da, db, scale_d);
}

template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 64)
    wgmma_rs_n64(d, a, db);
  else if constexpr (DP == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// --- the kernel -------------------------------------------------------------

// Shared memory (1024-byte aligned): Q as DP/64 boxes of (128 rows x 128 B),
// then kStages K tiles and kStages V tiles, each DP/64 boxes of (BK rows x
// 128 B), then the mbarriers.
template <int DP, int BK>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)kBQ * DP * 2 + 2 * kStages * (size_t)BK * DP * 2 +
         (1 + 2 * kStages) * sizeof(uint64_t);
}

template <int DP, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tmq,
                    const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    __nv_bfloat16* __restrict__ out, int BH, int S, int Tn,
                    int D, int causal, int window, float scale_log2) {
  constexpr int NB = DP / 64;                 // 64-column boxes along D
  constexpr uint32_t kQBytes = kBQ * DP * 2;
  constexpr uint32_t kTileBytes = BK * DP * 2;  // one K (or V) stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = base;
  uint8_t* k_s = q_s + kQBytes;
  uint8_t* v_s = k_s + kStages * kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * kTileBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int q0 = qt * kBQ;
  const int off = Tn - S;  // right-aligned query positions
  const int q_min = q0 + off;
  const int q_max = min(q0 + kBQ, S) - 1 + off;
  // live key tiles [kt_begin, kt_end): the block-level skip of the TPU
  // kernel, the arithmetic of flash_attention.live_key_tiles (tested there)
  int kt_end = (Tn + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_max < 0 ? 0 : q_max / BK + 1);
  int kt_begin = 0;
  if (window && q_min - window + 1 > 0) kt_begin = (q_min - window + 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= kConsumers / 32) {
    // producer warpgroup: one thread loads Q once, then the live K/V tiles
    // through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_expect_tx(q_full, kQBytes);
      for (int j = 0; j < NB; ++j)
        tma_load_3d(q_s + j * kBQ * 128, &tmq, q_full, 64 * j, q0, bh);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int st = i % kStages;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * kTileBytes);
        uint8_t* kd = k_s + st * kTileBytes;
        uint8_t* vd = v_s + st * kTileBytes;
        for (int j = 0; j < NB; ++j) {
          tma_load_3d(kd + j * BK * 128, &tmk, &full[st], 64 * j, kt * BK, bh);
          tma_load_3d(vd + j * BK * 128, &tmv, &full[st], 64 * j, kt * BK, bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows 64*wg .. 64*wg + 63 of the tile;
  // this thread holds rows r and r + 8 of them (the wgmma accumulator
  // layout: column 8*(i/4) + 2*(lane%4) + i%2 of register i, the second row
  // for (i/2)%2 == 1)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4;
  const int qp0 = q0 + wg * 64 + r + off;  // query positions of the 2 rows
  const int qp1 = qp0 + 8;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
    const int st = i % kStages;
    mbar_wait(&full[st], (i / kStages) & 1);
    const uint8_t* kt_s = k_s + st * kTileBytes;
    const uint8_t* vt_s = v_s + st * kTileBytes;

    // S = Q K^T over D in steps of 16 (32 bytes inside a 128-byte box row)
    float s[BK / 2];
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) s[c] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      if (kk * 16 >= D) break;
      const int box = kk / 4, col = (kk % 4) * 32;
      const uint64_t da =
          smem_desc(q_s + box * kBQ * 128 + wg * 64 * 128 + col, 16, 1024);
      const uint64_t db = smem_desc(kt_s + box * BK * 128 + col, 16, 1024);
      wgmma_ss<BK>(s, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // masks and the online softmax, in log2 units
    const int k0 = kt * BK + 2 * (lane & 3);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) {
      const int kp = k0 + 8 * (c >> 2) + (c & 1);
      const int qp = (c >> 1) & 1 ? qp1 : qp0;
      bool ok = true;
      if (causal) ok = ok && kp <= qp;
      if (window) ok = ok && kp > qp - window;
      const float x = kp >= Tn ? -INFINITY : (ok ? s[c] * scale_log2 : kNegInf);
      s[c] = x;
      if ((c >> 1) & 1)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) {
      if ((c >> 1) & 1) {
        s[c] = exp2f(s[c] - mx1);
        sum1 += s[c];
      } else {
        s[c] = exp2f(s[c] - mx0);
        sum0 += s[c];
      }
    }
    l0 = l0 * a0 + sum0;  // this thread's share; the quad sums at the end
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int c = 0; c < DP / 2; ++c) o[c] *= (c >> 1) & 1 ? a1 : a0;

    // P to bf16 in the register A-operand layout of m64k16 (it is the
    // accumulator's layout, 16 columns at a time)
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);

    // O += P V over the tile's keys in steps of 16 (16 rows of 128 bytes);
    // V is MN-major: the 64-column boxes are BK * 128 bytes apart
    fence_regs(pa);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DP>(o, pa[kk], smem_desc(vt_s + kk * 16 * 128, BK * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(&empty[st]);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + wg * 64 + r;
  __nv_bfloat16* ob = out + (size_t)bh * S * D;
#pragma unroll
  for (int c = 0; c < DP / 2; c += 2) {
    const int row = (c >> 1) & 1 ? row0 + 8 : row0;
    const int col = 8 * (c >> 2) + 2 * (lane & 3);
    const float inv = (c >> 1) & 1 ? inv1 : inv0;
    if (row < S && col < D)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D + col) =
          __floats2bfloat162_rn(o[c] * inv, o[c + 1] * inv);
  }
}

// --- host: tensor maps and the launch ---------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime at the first
// call, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (BH, rows, D) bf16 -> a 3-d map with boxes of (64 columns, box_rows, 1),
// 128-byte swizzle, zero fill out of bounds.
bool make_map(CUtensorMap* map, const void* ptr, int BH, int rows, int D,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * (cuuint64_t)D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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

template <int DP, int BK>
cudaError_t tc_impl(const void* q, const void* k, const void* v, void* out,
                    int BH, int S, int Tn, int D, int causal, int window,
                    cudaStream_t s) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, BH, S, D, kBQ) || !make_map(&mk, k, BH, Tn, D, BK) ||
      !make_map(&mv, v, BH, Tn, D, BK))
    return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<DP, BK>();
  static std::atomic<int> smem_set[kMaxDevices];
  const cudaError_t e = raise_smem_limit(
      reinterpret_cast<const void*>(flash_tc_kernel<DP, BK>), smem, smem_set);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)((S + kBQ - 1) / kBQ) * BH;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_tc_kernel<DP, BK><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), BH, S, Tn, D, causal,
      window, kLog2e / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// C interface, loaded with ctypes.  bfloat16 only; D % 8 == 0, D <= 256, every
// pointer 16-byte aligned.  Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* out, int BH,
                                         int S, int Tn, int D, int causal,
                                         int window, int device,
                                         void* stream) {
  if (BH < 1 || S < 1 || Tn < 1 || D < 8 || D > 256 || D % 8 != 0 ||
      window < 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(out))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return tc_impl<64, 128>(q, k, v, out, BH, S, Tn, D, causal,
                                       window, s);
  if (D <= 128) return tc_impl<128, 128>(q, k, v, out, BH, S, Tn, D, causal,
                                         window, s);
  return tc_impl<256, 64>(q, k, v, out, BH, S, Tn, D, causal, window, s);
}
