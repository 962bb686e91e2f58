// Hopper (sm_90a) building blocks in raw PTX, for the kernels written by
// hand in this directory: shared-memory mbarriers, TMA tile loads through a
// tensor map, wgmma shared-memory descriptors, the warpgroup products and
// their fences. Header-only; each .cu file compiles on its own. The host
// side encodes a tensor map over a strided (B, S, H, D) view.
//
// Layout conventions (CUTLASS's canonical GMMA layouts, in 16-byte units):
//  - K-major operand with a 128- or 64-byte swizzle: rows of 128 (64) bytes,
//    8-row swizzle atoms of 1024 (512) bytes; SBO = the atom's bytes, LBO
//    unused; a 16-deep k step inside the atom adds 32 bytes to the start.
//  - MN-major operand (the transpose bit): each k row is one 128 (64) byte
//    swizzled row of MN elements; SBO = the 8-row atom's bytes, LBO = the
//    distance between 64-element MN panels.
// Tiles start 1024-byte aligned, so the descriptors' base offset is 0.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace jumbo_hopper {

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to the phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Spin until the phase of parity `parity` has completed. A new barrier is
// in phase 0, so waiting on parity 1 returns at once (an empty ring slot).
// A wait of more than 2^34 cycles (~9 s) is a broken pipeline: it traps,
// and the launch fails with an error instead of holding the card forever.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// ------------------------------------------------------------------ TMA

// The box at coordinates (c0, c1, c2, c3), innermost first, of a 4-D tensor
// map into shared memory at `dst`; completion is counted on `bar` in bytes.
// Elements outside the tensor arrive as zeros and count as bytes all the same.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// 16 bytes of shared memory at `addr` (16-byte aligned).
__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// 2^x on the special-function unit (flush-to-zero; 2^-huge is 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- wgmma

enum SwizzleBytes { kSwizzle64 = 2, kSwizzle128 = 1 };  // the descriptor's layout code

// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets (multiples of 16), swizzle layout; base offset 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              SwizzleBytes layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
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

// Tell the compiler that `r` may change here, so no read of an accumulator
// moves above the wait for the products that write it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// Accumulator layout of every m64nN product below: warp w of the warpgroup
// owns rows 16w..16w+15; with g = lane/4 and t = lane%4, d[4j..4j+3] are
// (16w+g, 8j+2t), (16w+g, 8j+2t+1), (16w+g+8, 8j+2t), (16w+g+8, 8j+2t+1):
// the mma.sync m16n8 layout, one 8-column chunk j after another.

// d (+)= A·Bᵀ, m64n16k16: A (64x16) and B (16x16) both K-major in shared
// memory, through their descriptors. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n16k16(float (&d)[8], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (+)= A·Bᵀ, m64n32k16: A (64x16) and B (32x16) both K-major in shared
// memory, through their descriptors. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (+)= A·Bᵀ, m64n64k16: A (64x16) and B (64x16) both K-major in shared
// memory, through their descriptors. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d += A·B, m64n32k16: A (64x16 bf16) from registers in the mma.sync
// A-fragment layout of each warp's 16 rows; B (16x32) MN-major in shared
// memory (the transpose bit set), through its descriptor.
__device__ __forceinline__ void wgmma_rs_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A·B, m64n64k16: A (64x16 bf16) from registers in the mma.sync
// A-fragment layout of each warp's 16 rows; B (16x64) MN-major in shared
// memory (the transpose bit set), through its descriptor.
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A·B, m64n128k16: A (64x16 bf16) from registers in the mma.sync
// A-fragment layout of each warp's 16 rows; B (16x128) MN-major in shared
// memory (the transpose bit set), through its descriptor.
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (+)= A·Bᵀ over one 16-deep k step, both operands K-major in shared
// memory: the m64nNk16 product of width N (16, 32 or 64).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  if constexpr (N == 16) {
    wgmma_ss_m64n16k16(d, desc_a, desc_b, scale_d);
  } else if constexpr (N == 32) {
    wgmma_ss_m64n32k16(d, desc_a, desc_b, scale_d);
  } else {
    static_assert(N == 64, "wgmma_ss: N is 16, 32 or 64");
    wgmma_ss_m64n64k16(d, desc_a, desc_b, scale_d);
  }
}

// d += A·B over one 16-deep k step, A from registers, B MN-major in shared
// memory: the m64nNk16 product of width N (32, 64 or 128).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 32) {
    wgmma_rs_m64n32k16(d, a, desc_b);
  } else if constexpr (N == 64) {
    wgmma_rs_m64n64k16(d, a, desc_b);
  } else {
    static_assert(N == 128, "wgmma_rs: N is 32, 64 or 128");
    wgmma_rs_m64n128k16(d, a, desc_b);
  }
}

// A 64-row bf16 tile of head_dim D as TMA writes it with the swizzle of
// its row: panels of 64 columns (one of D columns for head_dim 32), each
// 64 rows of kRowBytes, 1024-byte aligned.
template <int D>
struct SwizzledTile {
  static constexpr int kRows = 64;
  static constexpr int kPanelCols = D < 64 ? D : 64;     // columns per swizzled panel
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kRowBytes = kPanelCols * 2;       // 64 or 128: the swizzle
  static constexpr int kPanelBytes = kRows * kRowBytes;
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // 64 rows x D
  static constexpr int kAtomBytes = 8 * kRowBytes;       // one 8-row swizzle atom
  static constexpr SwizzleBytes kSwizzle = kRowBytes == 128 ? kSwizzle128 : kSwizzle64;

  // The tile as a K-major operand (rows are M or N, columns are k) starting
  // at row `row0` (a multiple of 8); `k_step(kk)` is added for k step kk.
  __device__ static uint64_t kmajor(uint32_t tile, int row0) {
    return smem_desc(tile + row0 * kRowBytes, 16, kAtomBytes, kSwizzle);
  }
  __device__ static uint64_t k_step(int kk) {
    return static_cast<uint64_t>(((kk * 16 / kPanelCols) * kPanelBytes + (kk * 16 % kPanelCols) * 2) >> 4);
  }
  // The tile as an MN-major B operand through the transpose bit (rows are
  // k, columns are N) starting at row `row0` (a multiple of 16); a k step
  // of 16 rows adds `mn_step(kk)`.
  __device__ static uint64_t mnmajor(uint32_t tile, int row0) {
    return smem_desc(tile + row0 * kRowBytes, kPanelBytes, kAtomBytes, kSwizzle);
  }
  __device__ static uint64_t mn_step(int kk) {
    return static_cast<uint64_t>((kk * 16 * kRowBytes) >> 4);
  }
  // The byte offset in the tile of row `row`'s 16-byte chunk `c` (columns
  // 8c..8c+7), where TMA's swizzle put it: inside a panel, the chunk index
  // (address bits 4..6 at 128 bytes, 4..5 at 64) is XORed with bits 7..9
  // (7..8) of the unswizzled offset (CUTLASS's Swizzle<3,4,3>, <2,4,3>).
  __device__ static uint32_t chunk_offset(int row, int c) {
    constexpr int kChunks = kPanelCols / 8;  // chunks per panel row
    const uint32_t off = row * kRowBytes + (c % kChunks) * 16;
    return (c / kChunks) * kPanelBytes + (off ^ (((off >> 7) & (kChunks - 1)) << 4));
  }
};

// ------------------------------------------------------------- the host

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found once through the runtime (no -lcuda).
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess) {
      p = nullptr;
    }
#endif
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 4-D bf16 tensor map over the strided (B, S, H, D) view at `base`
// (strides in elements, head_dim stride 1): dims (D, H, S, B) innermost
// first, box (box_d, box_h, box_s, 1), swizzled by the box's row of
// box_d * 2 bytes (64 or 128). A dim of extent 1 is never stepped, so its
// stride is replaced by a legal one.
inline cudaError_t encode_bshd(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                               long long sb, long long ss, long long sh, int box_d, int box_h,
                               int box_s) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const long long el = 2;
  long long st_h = H > 1 ? sh * el : D * el;
  long long st_s = S > 1 ? ss * el : st_h * H;
  long long st_b = B > 1 ? sb * el : st_s * S;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st_h), static_cast<cuuint64_t>(st_s),
                                 static_cast<cuuint64_t>(st_b)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_d), static_cast<cuuint32_t>(box_h),
                             static_cast<cuuint32_t>(box_s), 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            box_d * el == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace jumbo_hopper
