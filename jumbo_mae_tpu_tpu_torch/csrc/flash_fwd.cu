// Flash-attention forward for Hopper (sm_90a): o = softmax(q·kᵀ)·v, and
// optionally lse = m + log(l) per query row.
//
// Replaces: `_fwd_kernel`, launched by `_flash_fwd`, in
// jumbo_mae_tpu_tpu/ops/pallas/attention.py (the Pallas TPU kernel K1).
// Same contract: q arrives already scaled by head_dim**-0.5 and is NOT
// scaled again; K/V stream in tiles under the online-softmax recurrence
// (m, l, acc) kept in f32; P is rounded to the input dtype before its
// product; key columns at index >= Sk are masked to -1e30; lse is f32
// (B*H, Sq) with row b*H + h, the Pallas layout.
//
// What bounds it on an H100: 4*S*D flops per (row, key) pair against 2
// bytes per element moved, about 100 flops per byte at S = 199, under the
// card's ~295 bf16 flops per byte of memory rate: the bound is bytes (read
// q, k and v once, write o once). At these short lengths a block lives
// for a handful of tile steps, each a serial chain (product, wait,
// softmax, product, wait), so what costs time is latency, the softmax's
// instructions (one ex2 per score) and padding past the sequence, not
// the tensor cores.
//
// The bf16 kernel for head_dim 32, 64 and 128 (flash_fwd_wgmma), one
// 64-row query tile per block:
//  - warp specialised: one producer warp starts the TMA loads
//    (cp.async.bulk.tensor, 4-D tensor maps over the strided (B, S, H, D)
//    view, so views of a fused projection load without a copy) and one
//    consumer warpgroup computes;
//  - Q is loaded once per block; K/V tiles of 64 keys stream through a
//    ring of 2 slots under full/empty mbarriers, so the next tile's load
//    overlaps this tile's products;
//  - S = Q·Kᵀ is wgmma m64nNk16 with both operands K-major in swizzled
//    shared memory; O += P·V is wgmma m64nDk16 with A = P from registers
//    (the score accumulator, rounded to bf16, already is wgmma's A layout)
//    and B = V through the descriptor's transpose bit: no transposed copy;
//  - a ragged last K/V tile runs a narrower product (N = 16 or 32 keys)
//    and a shorter softmax, so S = 199 pays for 208 keys a row, not 256;
//  - tiles sized to the sequence, chosen on the host before the one
//    launch: for max(Sq, Sk) <= 32 a 64-row tile packs 2-16 heads of one
//    batch row (rows ordered (s, head); 4 at the 13-token ring hop, 52 of
//    64 rows busy instead of 13) under a block-diagonal mask; longer
//    sequences take one head per tile, a block per 64 query rows;
//  - why one warpgroup per block, at 96 registers (4 blocks an SM) for
//    head_dim <= 64: measured on the H100, 2 or 4 query tiles per block
//    (a (b, h)'s K/V streamed once or twice instead of 4 times at
//    S = 199) ran 1.1-1.7x slower, and the 96-register bound 10 % faster
//    than the compiler's free choice (temporary variant builds, timed by
//    graph replay; PERF.md): more independent blocks hide each block's
//    serial chain, and the re-read K/V comes from L2. Also measured
//    slower: a 3-slot ring, persistent blocks, and starting the next
//    tile's q·kᵀ before this tile's softmax (it needs 32 more registers,
//    so fewer blocks);
//  - rows past the sequence arrive from TMA as zeros and are never stored;
//    no atomics, so the output is bit-identical run to run.
// Swizzle: a 128-byte row for head_dim 64 and 128 (two 64-column panels),
// a 64-byte row for head_dim 32. Helpers live in hopper.cuh.
//
// Shape-selected variants kept from the first port:
//  - head_dim 80 (ViT-H/14) in bf16 runs flash_fwd_bf16_mma: mma.sync
//    m16n8k16, 4 warps of 16 query rows, 64-key tiles loaded with plain
//    16-byte loads. 160-byte rows fit no wgmma swizzle atom;
//  - float32 runs flash_fwd_f32: plain FMA in full f32 (no TF32), 32-row
//    tiles with 4 threads per row, 32-key tiles. This is the exact path
//    parity runs take.
//
// Plain C interface, loaded with ctypes: jumbo_flash_fwd returns a
// cudaError_t after the launch (0 on success).

#include <atomic>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace jumbo_flash;
namespace hp = jumbo_hopper;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // nullptr: not requested
  Strides qs, ks, vs, os;
  int B, H, Sq, Sk;
};

// The maximum dynamic shared memory of `kernel`, raised once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// ------------------------------------------------- bf16 path: wgmma + TMA

constexpr int kTileRows = 64;  // query rows per block = keys per K/V tile
constexpr int kStages = 2;     // K/V ring slots (3 measured no faster)
constexpr int kThreads = 128 + 32;  // one consumer warpgroup and the producer warp

template <int D>
struct WgTile {
  static constexpr int kPanelCols = D < 64 ? D : 64;     // columns per swizzled panel
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kRowBytes = kPanelCols * 2;       // 64 or 128: the swizzle
  static constexpr int kPanelBytes = kTileRows * kRowBytes;
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // 64 rows x D
  static constexpr int kAtomBytes = 8 * kRowBytes;       // one 8-row swizzle atom
  static constexpr hp::SwizzleBytes kSwizzle = kRowBytes == 128 ? hp::kSwizzle128 : hp::kSwizzle64;
  static constexpr size_t kSmem = 1024 + (1 + 2 * kStages) * kTileBytes;  // + alignment
  // blocks per SM the registers must allow: 4 (96 registers a thread) for
  // head_dim <= 64, where more blocks in flight hide each block's serial
  // product -> softmax -> product chain; head_dim 128 needs ~160 registers
  static constexpr int kMinBlocks = D == 128 ? 1 : 4;
};

struct WgParams {
  void* o;
  float* lse;
  Strides os;
  int B, H, Sq, Sk;
  int log_pack;  // 2^log_pack heads share one 64-row tile
};

template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (D == 32) {
    hp::wgmma_rs_m64n32k16(o, a, desc);
  } else if constexpr (D == 64) {
    hp::wgmma_rs_m64n64k16(o, a, desc);
  } else {
    hp::wgmma_rs_m64n128k16(o, a, desc);
  }
}

template <int N>
__device__ __forceinline__ void qk_product(float (&s)[N / 2], uint64_t desc_q, uint64_t desc_k,
                                           int scale_d) {
  if constexpr (N == 16) {
    hp::wgmma_ss_m64n16k16(s, desc_q, desc_k, scale_d);
  } else if constexpr (N == 32) {
    hp::wgmma_ss_m64n32k16(s, desc_q, desc_k, scale_d);
  } else {
    hp::wgmma_ss_m64n64k16(s, desc_q, desc_k, scale_d);
  }
}

// The rows a consumer thread owns, and its place in the row's quad.
struct RowInfo {
  int t;         // lane % 4: columns 2t, 2t+1 of every 8-column chunk
  int head[2];   // the packed head of rows r0 and r0 + 8 (0 when unpacked)
  int log_pack;  // 2^log_pack heads per tile
};

// One K/V tile for one consumer warpgroup: s = q·kᵀ over the tile's first
// kKeys columns (only they can hold keys: 16 or 32 on a ragged last tile),
// the online-softmax update of (m, l, o), then o += P·V. Exponentials are
// 2^(s·log2 e − m·log2 e), one FMA and one ex2 per score.
template <int D, int kKeys>
__device__ __forceinline__ void attend_tile(float (&o)[D / 2], float (&m_run)[2], float (&l_run)[2],
                                            uint32_t q_tile, uint32_t k_tile, uint32_t v_tile,
                                            bool mask, int key0, int sk, const RowInfo& ri) {
  using T = WgTile<D>;
  constexpr int kChunks = kKeys / 8;
  constexpr float kLog2e = 1.4426950408889634f;
  float s[kKeys / 2];
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
  // a k step moves the descriptors' start address (bits 0-13, in 16 bytes)
  const uint64_t desc_q = hp::smem_desc(q_tile, 16, T::kAtomBytes, T::kSwizzle);
  const uint64_t desc_k = hp::smem_desc(k_tile, 16, T::kAtomBytes, T::kSwizzle);
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk * 16 / T::kPanelCols) * T::kPanelBytes + (kk * 16 % T::kPanelCols) * 2;
    qk_product<kKeys>(s, desc_q + (off >> 4), desc_k + (off >> 4), kk > 0);
  }
  hp::wgmma_commit();
  hp::wgmma_wait_all();
  hp::fence_operands(s);

  if (mask) {  // keys past the sequence and, in a packed tile, other heads' keys
    const int pm = (1 << ri.log_pack) - 1;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * ri.t + e;
        const bool past = key0 + (c >> ri.log_pack) >= sk;
        if (past || (c & pm) != ri.head[0]) s[4 * j + e] = kNegInf;
        if (past || (c & pm) != ri.head[1]) s[4 * j + 2 + e] = kNegInf;
      }
    }
  }

  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float alpha[2], mscaled[2], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = hp::fast_exp2((m_run[r] - mx[r]) * kLog2e);
    mscaled[r] = mx[r] * kLog2e;
  }
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = hp::fast_exp2(fmaf(s[4 * j + e], kLog2e, -mscaled[e >> 1]));
      rsum[e >> 1] += s[4 * j + e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
    rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
    l_run[r] = l_run[r] * alpha[r] + rsum[r];
    m_run[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }

  // o += P·V: keys 16kk..16kk+15 (chunks 2kk, 2kk+1) as the A fragment,
  // V's 16 rows of the step as B, MN-major
  uint32_t a[kKeys / 16][4];
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    a[kk][0] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
  const uint64_t desc_v = hp::smem_desc(v_tile, T::kPanelBytes, T::kAtomBytes, T::kSwizzle);
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    pv_product<D>(o, a[kk], desc_v + ((kk * 16 * T::kRowBytes) >> 4));
  }
  hp::wgmma_commit();
  hp::wgmma_wait_all();
  hp::fence_operands(o);
  hp::fence_operands(a);
}

template <int D>
__global__ void __launch_bounds__(kThreads, WgTile<D>::kMinBlocks)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, WgParams p) {
  using T = WgTile<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // q_full, full[], empty[]

  const uint32_t q_tile = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_smem = q_tile + T::kTileBytes;  // kStages K tiles, then kStages V tiles
  const uint32_t v_smem = k_smem + kStages * T::kTileBytes;
  const uint32_t q_full = hp::smem_u32(&bars[0]);
  const uint32_t full0 = hp::smem_u32(&bars[1]);
  const uint32_t empty0 = hp::smem_u32(&bars[1 + kStages]);

  // a tile row r is sequence position s0 + (r >> log_pack) of head h0 + (r & pm)
  const int pm = (1 << p.log_pack) - 1;
  const int rows_s = kTileRows >> p.log_pack;  // sequence positions per tile
  const int s0 = blockIdx.x * rows_s;
  const int h0 = blockIdx.y << p.log_pack;
  const int b = blockIdx.z;
  const int n_tiles = (p.Sk + rows_s - 1) / rows_s;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hp::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(full0 + 8 * s, 1);
      hp::mbar_init(empty0 + 8 * s, 4);  // one arrival per consumer warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // ---- the producer warp: one lane starts every load
    if (lane == 0) {
      hp::mbar_arrive_expect_tx(q_full, T::kTileBytes);
      for (int pn = 0; pn < T::kPanels; ++pn) {
        hp::tma_load_4d(q_tile + pn * T::kPanelBytes, &tm_q, q_full, pn * T::kPanelCols, h0, s0, b);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % kStages;
        hp::mbar_wait(empty0 + 8 * st, ((n / kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st;
        hp::mbar_arrive_expect_tx(full, 2 * T::kTileBytes);
        for (int pn = 0; pn < T::kPanels; ++pn) {
          const uint32_t off = st * T::kTileBytes + pn * T::kPanelBytes;
          hp::tma_load_4d(k_smem + off, &tm_k, full, pn * T::kPanelCols, h0, n * rows_s, b);
          hp::tma_load_4d(v_smem + off, &tm_v, full, pn * T::kPanelCols, h0, n * rows_s, b);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: rows r0 = 16·warp + lane / 4 and r0 + 8
  const int r0 = 16 * warp + (lane >> 2);
  const RowInfo ri{lane & 3, {r0 & pm, (r0 + 8) & pm}, p.log_pack};

  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  float o[D / 2];  // chunk j (columns 8j..8j+7) in o[4j..4j+3]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  hp::mbar_wait(q_full, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % kStages;
    hp::mbar_wait(full0 + 8 * st, (n / kStages) & 1);
    const uint32_t k_tile = k_smem + st * T::kTileBytes;
    const uint32_t v_tile = v_smem + st * T::kTileBytes;
    const int key0 = n * rows_s;
    const bool mask = pm != 0 || key0 + rows_s > p.Sk;
    // columns that can hold a key of this tile: keys key0.. of every head
    const int cols = min(rows_s, p.Sk - key0) << p.log_pack;
    if (cols <= 16) {
      attend_tile<D, 16>(o, m_run, l_run, q_tile, k_tile, v_tile, mask, key0, p.Sk, ri);
    } else if (cols <= 32) {
      attend_tile<D, 32>(o, m_run, l_run, q_tile, k_tile, v_tile, mask, key0, p.Sk, ri);
    } else {
      attend_tile<D, 64>(o, m_run, l_run, q_tile, k_tile, v_tile, mask, key0, p.Sk, ri);
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(empty0 + 8 * st);  // this warp is done with the slot
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const int sq = s0 + (row >> p.log_pack);
    const int h = h0 + (row & pm);
    if (sq >= p.Sq || h >= p.H) continue;
    const float inv_l = 1.f / l_run[r];
    __nv_bfloat16* orow = out + b * p.os.b + sq * p.os.s + h * p.os.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * ri.t) =
          pack_bf16x2(o[4 * j + 2 * r] * inv_l, o[4 * j + 2 * r + 1] * inv_l);
    }
    if (p.lse != nullptr && ri.t == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + sq] = m_run[r] + logf(l_run[r]);
    }
  }
}

// ---------------------------------- bf16 path, head_dim 80: mma.sync

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows per block
constexpr int kMmaKeys = 64;              // keys per K/V tile

template <int D>
constexpr size_t smem_bytes_mma() {
  return sizeof(__nv_bfloat16) *
         ((kMmaRows + kMmaKeys) * (D + kPad) + D * (kMmaKeys + kPad));
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_bf16_mma(Params p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kMmaRows * (D + kPad);
  __nv_bfloat16* vt = ks + kMmaKeys * (D + kPad);

  const int m0 = blockIdx.x * kMmaRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.qs.b + h * p.qs.h;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.ks.b + h * p.ks.h;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.vs.b + h * p.vs.h;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.os.b + h * p.os.h;

  load_rows_bf16<D, kMmaRows, kMmaThreads>(qs, q, p.qs.s, m0, p.Sq);
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16-wide k step
  constexpr int kSteps = D / 16;
  uint32_t qf[kSteps][4];
  const __nv_bfloat16* qw = qs + warp * 16 * (D + kPad);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) load_a_frag(qf[s], qw, D + kPad, s, g, t);

  // online-softmax state for rows g and g+8 of this warp's 16
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  constexpr int kOutTiles = D / 8;
  float acc[kOutTiles][4];
#pragma unroll
  for (int j = 0; j < kOutTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  constexpr int kKeyTiles = kMmaKeys / 8;
  for (int n0 = 0; n0 < p.Sk; n0 += kMmaKeys) {
    __syncthreads();  // the previous tile is consumed by every warp
    load_rows_bf16<D, kMmaKeys, kMmaThreads>(ks, k, p.ks.s, n0, p.Sk);
    load_rows_transposed_bf16<D, kMmaKeys, kMmaThreads>(vt, v, p.vs.s, n0, p.Sk);
    __syncthreads();

    // scores s = q·kᵀ for 16 rows x 64 keys, f32
    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = ks + (j * 8 + g) * (D + kPad);
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        mma_16816(s[j], qf[st], ld_smem_u32(kr + st * 16 + 2 * t),
                  ld_smem_u32(kr + st * 16 + 8 + 2 * t));
      }
    }
    if (n0 + kMmaKeys > p.Sk) {  // ragged last tile: mask the pad keys
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (n0 + j * 8 + 2 * t + c >= p.Sk) s[j][c] = s[j][2 + c] = kNegInf;
        }
      }
    }

    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) alpha[r] = __expf(m_run[r] - mx[r]);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      s[j][0] = __expf(s[j][0] - mx[0]);
      s[j][1] = __expf(s[j][1] - mx[0]);
      s[j][2] = __expf(s[j][2] - mx[1]);
      s[j][3] = __expf(s[j][3] - mx[1]);
      rsum[0] += s[j][0] + s[j][1];
      rsum[1] += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rsum[r];
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < kOutTiles; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc += P·V: the score accumulators are already laid out as the A
    // fragments of P (keys 16kk..16kk+15 are key tiles 2kk and 2kk+1)
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      uint32_t a[4];
      acc_to_a_frag(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < kOutTiles; ++j) {
        const __nv_bfloat16* vr = vt + (j * 8 + g) * (kMmaKeys + kPad) + kk * 16;
        mma_16816(acc[j], a, ld_smem_u32(vr + 2 * t), ld_smem_u32(vr + 8 + 2 * t));
      }
    }
  }

  const int rows[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.Sq) continue;
    const float inv_l = 1.f / l_run[r];
    __nv_bfloat16* orow = o + rows[r] * p.os.s;
#pragma unroll
    for (int j = 0; j < kOutTiles; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16x2(acc[j][2 * r] * inv_l, acc[j][2 * r + 1] * inv_l);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + rows[r]] =
          m_run[r] + logf(l_run[r]);
    }
  }
}

// ----------------------------------------------------------------- f32 path

constexpr int kF32Rows = 32;  // query rows per block; 4 threads per row
constexpr int kF32Keys = 32;  // keys per K/V tile
constexpr int kF32Threads = 4 * kF32Rows;

template <int D>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) * ((kF32Rows + kF32Keys) * (D + 1) + kF32Keys * D +
                          kF32Rows * (kF32Keys + 1));
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32(Params p) {
  static_assert(D % 4 == 0, "head_dim must be a multiple of 4");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kF32Rows][D + 1]
  float* ks = qs + kF32Rows * (D + 1);             // [kF32Keys][D + 1]
  float* vs = ks + kF32Keys * (D + 1);             // [kF32Keys][D]
  float* ps = vs + kF32Keys * D;                   // [kF32Rows][kF32Keys + 1]

  const int m0 = blockIdx.x * kF32Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int r = threadIdx.x >> 2;  // this thread's row in the tile
  const int t = threadIdx.x & 3;   // its lane in the row's quad

  const float* q = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
  const float* k = static_cast<const float*>(p.k) + b * p.ks.b + h * p.ks.h;
  const float* v = static_cast<const float*>(p.v) + b * p.vs.b + h * p.vs.h;
  float* o = static_cast<float*>(p.o) + b * p.os.b + h * p.os.h;

  load_rows_f32<D, kF32Threads>(qs, D + 1, q, p.qs.s, kF32Rows, m0, p.Sq);

  float m_run = kNegInf, l_run = 0.f;
  constexpr int kCols = D / 4;  // output columns t, t+4, t+8, ...
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;

  constexpr int kPerThread = kF32Keys / 4;  // keys t, t+4, ...
  for (int n0 = 0; n0 < p.Sk; n0 += kF32Keys) {
    __syncthreads();
    load_rows_f32<D, kF32Threads>(ks, D + 1, k, p.ks.s, kF32Keys, n0, p.Sk);
    load_rows_f32<D, kF32Threads>(vs, D, v, p.vs.s, kF32Keys, n0, p.Sk);
    __syncthreads();

    float s[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) s[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) s[i] = fmaf(qd, ks[(t + 4 * i) * (D + 1) + d], s[i]);
    }
    float mx = m_run;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (n0 + t + 4 * i >= p.Sk) s[i] = kNegInf;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = expf(m_run - mx);
    float rsum = 0.f;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      s[i] = expf(s[i] - mx);
      rsum += s[i];
      ps[r * (kF32Keys + 1) + t + 4 * i] = s[i];
    }
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
    l_run = l_run * alpha + rsum;
    m_run = mx;
    __syncwarp();  // the quad's p row is written before it is read

#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] *= alpha;
    for (int j = 0; j < kF32Keys; ++j) {
      const float pj = ps[r * (kF32Keys + 1) + j];
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = fmaf(pj, vs[j * D + t + 4 * i], acc[i]);
    }
  }

  const int row = m0 + r;
  if (row < p.Sq) {
    const float inv_l = 1.f / l_run;
    float* orow = o + row * p.os.s;
#pragma unroll
    for (int i = 0; i < kCols; ++i) orow[t + 4 * i] = acc[i] * inv_l;
    if (p.lse != nullptr && t == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + row] = m_run + logf(l_run);
    }
  }
}

// ------------------------------------------------------------------ launch

template <int D>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  using T = WgTile<D>;
  WgParams w;
  w.o = p.o;
  w.lse = p.lse;
  w.os = p.os;
  w.B = p.B;
  w.H = p.H;
  w.Sq = p.Sq;
  w.Sk = p.Sk;
  // heads per tile: as many as fit both lengths into 64 rows, up to H's
  // next power of two; one head for lengths over 32
  w.log_pack = 0;
  const int longest = p.Sq > p.Sk ? p.Sq : p.Sk;
  while ((kTileRows >> (w.log_pack + 1)) >= longest && (1 << w.log_pack) < p.H) ++w.log_pack;
  const int rows_s = kTileRows >> w.log_pack;
  constexpr int pw = T::kPanelCols;
  CUtensorMap tq, tk, tv;
  cudaError_t err = hp::encode_bshd(&tq, p.q, p.B, p.Sq, p.H, D, p.qs.b, p.qs.s, p.qs.h, pw,
                                    1 << w.log_pack, rows_s);
  if (err == cudaSuccess) {
    err = hp::encode_bshd(&tk, p.k, p.B, p.Sk, p.H, D, p.ks.b, p.ks.s, p.ks.h, pw,
                          1 << w.log_pack, rows_s);
  }
  if (err == cudaSuccess) {
    err = hp::encode_bshd(&tv, p.v, p.B, p.Sk, p.H, D, p.vs.b, p.vs.s, p.vs.h, pw,
                          1 << w.log_pack, rows_s);
  }
  if (err != cudaSuccess) return err;
  static std::atomic<unsigned long long> smem_set{0};
  err = allow_smem(flash_fwd_wgmma<D>, T::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + rows_s - 1) / rows_s, (p.H + (1 << w.log_pack) - 1) >> w.log_pack, p.B);
  flash_fwd_wgmma<D><<<grid, kThreads, T::kSmem, stream>>>(tq, tk, tv, w);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_mma<D>();
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = allow_smem(flash_fwd_bf16_mma<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kMmaRows - 1) / kMmaRows, p.H, p.B);
  flash_fwd_bf16_mma<D><<<grid, kMmaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_f32<D>();
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = allow_smem(flash_fwd_f32<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kF32Rows - 1) / kF32Rows, p.H, p.B);
  flash_fwd_f32<D><<<grid, kF32Threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for
// (batch, seq, head); the head_dim stride must be 1. lse may be null.
// Returns a cudaError_t (0 = success). Shapes are validated by the caller;
// the bf16 kernel's tensor maps also need every stride a positive multiple
// of 16 bytes below 2^40 bytes.
int jumbo_flash_fwd(const void* q, const void* k, const void* v, void* o,
                    void* lse, int dtype, int B, int H, int Sq, int Sk, int D,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    long long o_sb, long long o_ss, long long o_sh,
                    void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.qs = {q_sb, q_ss, q_sh};
  p.ks = {k_sb, k_ss, k_sh};
  p.vs = {v_sb, v_ss, v_sh};
  p.os = {o_sb, o_ss, o_sh};
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  if ((dtype != 0 && dtype != 1) || B < 1 || H < 1 || Sq < 1 || Sk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
      case 32: return static_cast<int>(launch_f32<32>(p, s));
      case 64: return static_cast<int>(launch_f32<64>(p, s));
      case 80: return static_cast<int>(launch_f32<80>(p, s));
      case 128: return static_cast<int>(launch_f32<128>(p, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (D) {
    case 32: return static_cast<int>(launch_wgmma<32>(p, s));
    case 64: return static_cast<int>(launch_wgmma<64>(p, s));
    case 80: return static_cast<int>(launch_mma<80>(p, s));
    case 128: return static_cast<int>(launch_wgmma<128>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* jumbo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
