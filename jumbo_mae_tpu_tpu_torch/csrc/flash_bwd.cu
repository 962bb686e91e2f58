// Flash-attention backward for Hopper (sm_90a), two kernels and no atomics:
//
//   K2 (dq):  dq = Σ_k (P ∘ (dO·Vᵀ − D))·K
//   K3 (dkv): dv = Σ_q Pᵀ·dO,   dk = Σ_q (P ∘ (dO·Vᵀ − D))ᵀ·Q
//
// with P = exp(q·kᵀ − lse) recomputed from the forward's lse, and
// D = rowsum(dO ∘ O) − g_lse computed by K2 for its own rows: the JAX
// package computes D outside its kernels (`_flash_bwd`, the per-row
// prologue, with K4's lse cotangent g_lse), and a separate pass over O and
// dO cost more than K2 and K3 together at the MAE shapes. K2 reads its
// rows' O tile beside their dO tile, sums dO·O per row in f32, subtracts
// g_lse where one is given, uses that D in its own dS and writes it to an
// f32 (B*H, Sq) buffer, from which K3 (launched after it on the same
// stream) reads it.
//
// Replaces: `_bwd_dq_kernel` (K2) and `_bwd_dkv_kernel` (K3), launched by
// `_flash_bwd`, in jumbo_mae_tpu_tpu/ops/pallas/attention.py. Same
// contract: q arrives already scaled, so dq is the gradient w.r.t. the
// scaled q; key columns >= Sk get P = 0; query rows >= Sq contribute
// exactly 0 to dk and dv; P and dS are rounded to bf16 before each product
// they feed, products accumulate in f32.
//
// Two kernels, no atomics: each output element is owned by one block,
// which sums its terms in a fixed order, so two runs give bit-identical
// gradients (the TPU design chose this too). K2's block owns a 64-row q
// tile and loops over K/V tiles; K3's block owns a 64-key tile and loops
// over q tiles.
//
// What bounds it on an H100: at the MAE shapes (S = 52 and 199, head_dim
// 64 and 32) K2 does 3 and K3 4 products of 2·S²·D flops per (batch,
// head) against q, k, v, dO, lse and D (K2 also O and g_lse) read once
// and the gradients (K2 also D) written once; with S this short that is
// under the card's ~295 bf16 flops per byte, so the bound is bytes. What
// costs the time is not the bytes or the tensor cores but the elementwise
// work per score (an FMA, an ex2, a subtract, a multiply and a bf16 pack,
// K3 twice the packs), which both kernels pay, and each block's serial chains (products,
// wait, elementwise, products, wait), which only other resident blocks
// can hide; padding past the sequence costs the same per score.
//
// Tried (K2 + K3 at the MAE decoder shape by graph replay, on an NVIDIA
// H100 80GB HBM3 at 700 W; PERF.md has the table): per-tile mask
// specialisation, the largest single gain (0.359 -> 0.276 ms); narrower
// products under a tighter register bound (-> 0.214); a 3-slot ring
// (-> 0.210); 16-column K2 products at head_dim 32 (K2 0.088 -> 0.086).
// Register bounds that force spills (4 blocks at head_dim 64, 5 for K3 at
// 32) ran slower or only as fast, and the build refuses spills. K2 at the
// ViT-H/14 encoder (256, 67, 16, 80): 32-column products under a 3-block
// bound (118 registers) 0.120 ms; 16 columns 0.124; 64 columns spill
// under 3 blocks and take 0.142 under 2.
//
// The bf16 kernels (flash_bwd_dq_wgmma and flash_bwd_dkv_wgmma, at every
// head_dim) follow K1's design (flash_fwd.cu):
//  - warp specialised: one producer warp starts TMA loads through 4-D
//    tensor maps over the strided (B, S, H, D) views, one consumer
//    warpgroup computes;
//  - the block's own tiles (Q, dO and O in K2, K and V in K3) are loaded
//    once; the other pair (K and V in K2, Q and dO in K3) streams
//    through a ring of 3 slots (2 at head_dim 80) under full/empty
//    mbarriers, so the next tiles' loads overlap this tile's products;
//  - K2: S = Q·Kᵀ and dP = dO·Vᵀ are wgmma SS products (both operands
//    K-major in swizzled shared memory); dS = P ∘ (dP − D) is rounded to
//    bf16 in registers, where the accumulator layout already is wgmma's A
//    layout, and dq += dS·K is an RS product with K read through the
//    descriptor's transpose bit from the ring slot itself;
//  - K3: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are SS products; Pᵀ and dSᵀ go to bf16
//    registers and feed dv += Pᵀ·dO and dk += dSᵀ·Q as RS products, dO and
//    Q read through the transpose bit from the ring slots. No transposed
//    copy is made anywhere;
//  - a tile is taken in narrow products of 16 or 32 columns (keys in K2,
//    query rows in K3), each its own chain of SS products, elementwise
//    work and RS products: few score registers are live, so the register
//    bound admits 3-5 blocks an SM at head_dim 32, 64 and 80, which
//    hide each other's chains; the elementwise work per score is
//    specialised per tile (no mask, a ragged end, packed heads), so a
//    full tile pays nothing for masking;
//  - K2's D: each quad of consumer threads owns rows r0 and r0 + 8 and
//    sums dO·O over them, each lane a quarter of the 16-byte chunks read
//    from the swizzled tiles, then two shuffles; one lane per row stores
//    D (pad rows and packed rows of absent heads store nothing, and TMA
//    fills them with zeros, so they never read memory past the sequence);
//  - lse, g_lse and D cannot come through TMA (a tensor map needs 16-byte
//    strides; an lse row is Sq x 4 bytes). K2's consumer threads load
//    their two rows' values into registers; K3's producer warp loads the
//    streamed tile's 64 values of each into a shared-memory slot beside the
//    ring slot (plain 4-byte loads, gathered from rows b·H + h in a packed
//    tile) and each of its lanes arrives on the slot's full barrier;
//  - exponentials are 2^(s·log2 e − lse·log2 e), one FMA and one ex2;
//  - a ragged last tile runs a narrower product (N = 16 or 32), and tiles
//    are sized to the sequence by K1's rule, chosen on the host: for
//    max(Sq, Sk) <= 32 a 64-row tile packs 2-16 heads of one batch row
//    (row r is position s0 + (r >> log_pack) of head h0 + (r & pm); 4
//    heads at the 13-token ring hop) under a block-diagonal mask;
//  - rows past the sequence arrive from TMA as zeros and are never
//    stored; a masked score gives P = dS = 0 exactly.
// Swizzle: a 128-byte row for head_dim 64 and 128, 64 bytes for 32, and
// at head_dim 80 a 64-column panel of 128-byte rows beside a 16-column
// panel of 32-byte rows (hopper.cuh's SwizzledTile, as in K1): the SS
// products take 4 k steps in panel 0 and 1 in panel 1, the RS products
// split into 64 + 16 columns, and K2's D reads chunks 0-7 of a row from
// panel 0 and 8-9 from panel 1; a 2-slot ring there, so shared memory
// admits 3 blocks an SM of either kernel.
// Helpers live in hopper.cuh.
//
// float32 runs plain FMA in full f32 (no TF32), 32-row tiles with 4
// threads per row. This is the exact path parity runs take.
//
// Layout: q, k, v, dO and O are (B, S, H, D) read through strides
// (innermost stride 1); lse, g_lse and D are f32 (B*H, Sq) with row
// b*H + h (K1's lse layout); dq, dk and dv are written through strides in
// the input dtype. The f32 kernels read O and dO for D with plain loads,
// each quad's lanes a quarter of a row.
//
// Plain C interface, loaded with ctypes: each entry point returns
// cudaGetLastError() after its launch (0 on success).

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace jumbo_flash;
namespace hp = jumbo_hopper;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* o;        // K2: the forward's output
  const float* lse;     // (B*H, Sq)
  const float* g_lse;   // K2: (B*H, Sq), lse's cotangent (K4), or null
  float* delta;         // (B*H, Sq), rowsum(dO ∘ O) − g_lse: K2 writes, K3 reads
  void* dq;
  void* dk;
  void* dv;
  Strides qs, ks, vs, dos, os, dqs, dks, dvs;
  int B, H, Sq, Sk;
};

// ------------------------------------- bf16 path (K2, K3): wgmma + TMA

constexpr int kWgRows = 64;           // rows of every tile: q rows (K2) or keys (K3) per block
constexpr int kWgThreads = 128 + 32;  // one consumer warpgroup and the producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct BwdTile : hp::SwizzledTile<D> {
  // ring slots of the streamed pair of tiles: 3, and 2 at head_dim 80,
  // where 3 would leave 2 blocks an SM (K2 93 KB a block, K3 83 KB) and 2
  // admit 3 (73 and 62 KB); at the ViT-H/14 encoder's 67 tokens each
  // kernel streams 2 tiles, so 2 slots already load all of them at once
  // (K3 with 3 slots measured 1.2x slower there, on the H100)
  static constexpr int kStages = D == 80 ? 2 : 3;
  // the block's own tiles (Q, dO and O in K2; K and V in K3) and kStages
  // slots of the streamed pair, + 1024 bytes for alignment. K2's O tile
  // keeps its 5 and 3 blocks an SM at head_dim 32 and 64 (37 and 73 KB a
  // block against the SM's 228 KB); chip_smoke.py checks the count.
  static constexpr size_t kSmemDq = 1024 + (3 + 2 * kStages) * hp::SwizzledTile<D>::kTileBytes;
  static constexpr size_t kSmemDkv = 1024 + (2 + 2 * kStages) * hp::SwizzledTile<D>::kTileBytes;
  // columns per product (keys in K2, query rows in K3) and the blocks per
  // SM the registers must allow, chosen on the H100 (PERF.md): narrow
  // products keep few score registers live, so more blocks run at once
  // and hide each other's serial chains (at head_dim 32: K2 at 72
  // registers, 5 blocks; K3 at 88, 4 blocks). At head_dim 128 the
  // accumulators alone take 64 (K2) and 128 (K3) registers: one block.
  // At head_dim 80 both kernels hold 3 blocks, as many as their shared
  // memory admits (the occupancy query, chip_smoke.py): K3's dk and dv
  // take 80 registers of 136, K2's dq 40 beside 32-column S and dP.
  static constexpr int kDqCols = D == 32 ? 16 : D == 64 || D == 80 ? 32 : 64;
  static constexpr int kDkvCols = D == 128 ? 32 : 16;
  static constexpr int kMinBlocksDq = D == 32 ? 5 : D == 64 || D == 80 ? 3 : 1;
  static constexpr int kMinBlocksDkv = D == 32 ? 4 : D == 64 || D == 80 ? 3 : 1;
};

struct WgParams {
  void* out0;          // K2: dq; K3: dk
  void* out1;          // K3: dv
  const float* lse;    // (B*H, Sq)
  const float* g_lse;  // K2: (B*H, Sq) or null
  float* delta;        // (B*H, Sq): K2 writes, K3 reads
  Strides os0, os1;
  int B, H, Sq, Sk;
  int log_pack;  // 2^log_pack heads share one 64-row tile
};

// Stores rows r0 and r0 + 8 of an m64nD accumulator as bf16, each to its
// (position, head) through the strides; rows past Sq/Sk or H are skipped.
template <int D>
__device__ __forceinline__ void store_rows(void* out, const Strides& os, const float (&x)[D / 2], int r0,
                                           int t, int s0, int h0, int b, int log_pack, int S, int H) {
  __nv_bfloat16* base = static_cast<__nv_bfloat16*>(out);
  const int pm = (1 << log_pack) - 1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const int s = s0 + (row >> log_pack);
    const int h = h0 + (row & pm);
    if (s >= S || h >= H) continue;
    __nv_bfloat16* dst = base + b * os.b + s * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dst + j * 8 + 2 * t) = pack_bf16x2(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]);
    }
  }
}

// How a tile's columns (keys in K2, query rows in K3) are masked, chosen
// per tile so that a full tile pays nothing for it: kNoMask, every column
// holds one; kRagged, one head whose sequence ends inside the tile
// (columns >= lim masked); kPacked, 2^log_pack heads, where a column must
// be the row's head at a position below lim.
enum MaskKind { kNoMask, kRagged, kPacked };

// The rows a consumer thread owns and its place in the row's quad.
struct RowInfo {
  int t;         // lane % 4: columns 2t, 2t+1 of every 8-column chunk
  int head[2];   // the packed head of rows r0 and r0 + 8 (0 when unpacked)
  int log_pack;  // 2^log_pack heads per tile
};

template <MaskKind kMask>
__device__ __forceinline__ bool keep_col(int c, int r, int lim, const RowInfo& ri) {
  if constexpr (kMask == kNoMask) {
    return true;
  } else if constexpr (kMask == kRagged) {
    return c < lim;
  } else {
    return (c >> ri.log_pack) < lim && (c & ((1 << ri.log_pack) - 1)) == ri.head[r];
  }
}

// f(width, c0) over the first `cols` columns of a tile, in products of
// kCols columns at most, each at the narrowest width (16, 32 or 64) that
// holds what is left.
template <int kCols, typename F>
__device__ __forceinline__ void for_each_chunk(int cols, F&& f) {
  for (int c0 = 0; c0 < cols; c0 += kCols) {
    const int left = cols - c0;
    if (kCols == 16 || left <= 16) {
      f(std::integral_constant<int, 16>{}, c0);
    } else if (kCols == 32 || left <= 32) {
      f(std::integral_constant<int, 32>{}, c0);
    } else if constexpr (kCols == 64) {
      f(std::integral_constant<int, 64>{}, c0);
    }
  }
}

// Keys [c0, c0 + kKeys) of one K/V tile for K2's consumer warpgroup:
// S = Q·Kᵀ and dP = dO·Vᵀ; P = 2^(S·log2 e − lse·log2 e); dS = P ∘ (dP −
// D), 0 on masked columns, rounded to bf16; dq += dS·K. `lim` is the
// number of the tile's positions that hold keys.
template <int D, int kKeys, MaskKind kMask>
__device__ __forceinline__ void dq_cols(float (&dq)[D / 2], uint32_t q_tile, uint32_t do_tile,
                                        uint32_t k_tile, uint32_t v_tile, int c0, int lim, const RowInfo& ri,
                                        const float (&lse2)[2], const float (&dd)[2]) {
  using T = hp::SwizzledTile<D>;
  float s[kKeys / 2], dp[kKeys / 2];
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) s[i] = dp[i] = 0.f;
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    hp::wgmma_ss<kKeys>(s, T::kmajor(q_tile, 0, kk), T::kmajor(k_tile, c0, kk), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    hp::wgmma_ss<kKeys>(dp, T::kmajor(do_tile, 0, kk), T::kmajor(v_tile, c0, kk), kk > 0);
  }
  hp::wgmma_commit();
  hp::wgmma_wait_all();
  hp::fence_operands(s);
  hp::fence_operands(dp);

#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const bool keep = keep_col<kMask>(c0 + 8 * j + 2 * ri.t + (e & 1), r, lim, ri);
      const float pr = hp::fast_exp2(fmaf(s[4 * j + e], kLog2e, -lse2[r]));
      s[4 * j + e] = keep ? pr * (dp[4 * j + e] - dd[r]) : 0.f;
    }
  }

  // dq += dS·K: keys 16kk..16kk+15 as the A fragment, K's rows of the step
  // as B, MN-major through the transpose bit
  uint32_t a[kKeys / 16][4];
  acc_to_a<kKeys>(a, s);
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) T::rs_product(dq, a[kk], k_tile, c0 + 16 * kk);
  hp::wgmma_commit();
  hp::wgmma_wait_all();
  hp::fence_operands(dq);
  hp::fence_operands(a);
}

// One K/V tile for K2: its first `cols` columns (only they can hold keys).
template <int D, MaskKind kMask>
__device__ __forceinline__ void dq_tile(int cols, float (&dq)[D / 2], uint32_t q_tile, uint32_t do_tile,
                                        uint32_t k_tile, uint32_t v_tile, int lim, const RowInfo& ri,
                                        const float (&lse2)[2], const float (&dd)[2]) {
  for_each_chunk<BwdTile<D>::kDqCols>(cols, [&](auto n, int c0) {
    dq_cols<D, decltype(n)::value, kMask>(dq, q_tile, do_tile, k_tile, v_tile, c0, lim, ri, lse2, dd);
  });
}

// dO·O summed over row `row` of the swizzled dO and O tiles, by the 4
// lanes of a quad: lane t reads the 16-byte chunks t, t + 4, ... of both;
// every lane returns the same sum.
template <int D>
__device__ __forceinline__ float tile_row_dot(uint32_t do_tile, uint32_t o_tile, int row, int t) {
  using T = hp::SwizzledTile<D>;
  float acc = 0.f;
#pragma unroll
  for (int c = t; c < D / 8; c += 4) {
    const uint32_t off = T::chunk_offset(row, c);
    acc = dot8_bf16(hp::ld_shared_v4(do_tile + off), hp::ld_shared_v4(o_tile + off), acc);
  }
  return quad_sum(acc);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, BwdTile<D>::kMinBlocksDq)
    flash_bwd_dq_wgmma(const __grid_constant__ hp::TileMaps<D> tm_q, const __grid_constant__ hp::TileMaps<D> tm_k,
                       const __grid_constant__ hp::TileMaps<D> tm_v, const __grid_constant__ hp::TileMaps<D> tm_do,
                       const __grid_constant__ hp::TileMaps<D> tm_o, WgParams p) {
  using T = BwdTile<D>;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // own_full, full[], empty[]

  const uint32_t q_tile = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_tile = q_tile + T::kTileBytes;
  const uint32_t o_tile = do_tile + T::kTileBytes;
  const uint32_t k_smem = o_tile + T::kTileBytes;  // kStages K tiles, then kStages V tiles
  const uint32_t v_smem = k_smem + kStages * T::kTileBytes;
  const uint32_t own_full = hp::smem_u32(&bars[0]);
  const uint32_t full0 = hp::smem_u32(&bars[1]);
  const uint32_t empty0 = hp::smem_u32(&bars[1 + kStages]);

  const int pm = (1 << p.log_pack) - 1;
  const int rows_s = kWgRows >> p.log_pack;  // sequence positions per tile
  const int s0 = blockIdx.x * rows_s;
  const int h0 = blockIdx.y << p.log_pack;
  const int b = blockIdx.z;
  const int n_tiles = (p.Sk + rows_s - 1) / rows_s;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hp::mbar_init(own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(full0 + 8 * s, 1);
      hp::mbar_init(empty0 + 8 * s, 4);  // one arrival per consumer warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // ---- the producer warp: one lane starts every load
    if (lane == 0) {
      hp::mbar_arrive_expect_tx(own_full, 3 * T::kTileBytes);
      hp::tma_load_tile<D>(q_tile, tm_q, own_full, h0, s0, b);
      hp::tma_load_tile<D>(do_tile, tm_do, own_full, h0, s0, b);
      hp::tma_load_tile<D>(o_tile, tm_o, own_full, h0, s0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % kStages;
        hp::mbar_wait(empty0 + 8 * st, ((n / kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st;
        hp::mbar_arrive_expect_tx(full, 2 * T::kTileBytes);
        hp::tma_load_tile<D>(k_smem + st * T::kTileBytes, tm_k, full, h0, n * rows_s, b);
        hp::tma_load_tile<D>(v_smem + st * T::kTileBytes, tm_v, full, h0, n * rows_s, b);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: rows r0 = 16·warp + lane / 4 and r0 + 8,
  // with their lse (times log2 e), g_lse and D in registers; pad rows read
  // nothing
  const int r0 = 16 * warp + (lane >> 2);
  const RowInfo ri{lane & 3, {r0 & pm, (r0 + 8) & pm}, p.log_pack};
  float lse2[2], dd[2];
  long long idx[2];
  bool ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const int sq = s0 + (row >> p.log_pack);
    const int h = h0 + (row & pm);
    ok[r] = sq < p.Sq && h < p.H;
    idx[r] = (static_cast<long long>(b) * p.H + h) * p.Sq + sq;
    lse2[r] = ok[r] ? p.lse[idx[r]] * kLog2e : 0.f;
    dd[r] = ok[r] && p.g_lse != nullptr ? -p.g_lse[idx[r]] : 0.f;
  }

  float dq[D / 2];  // chunk j (columns 8j..8j+7) in dq[4j..4j+3]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  hp::mbar_wait(own_full, 0);
  // D = rowsum(dO ∘ O) − g_lse of both rows; lane 0 of the quad stores it
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = tile_row_dot<D>(do_tile, o_tile, r0 + 8 * r, ri.t);
    dd[r] = ok[r] ? sum + dd[r] : 0.f;
    if (ok[r] && ri.t == 0) p.delta[idx[r]] = dd[r];
  }
  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % kStages;
    hp::mbar_wait(full0 + 8 * st, (n / kStages) & 1);
    const uint32_t k_tile = k_smem + st * T::kTileBytes;
    const uint32_t v_tile = v_smem + st * T::kTileBytes;
    // positions of this tile that hold keys, and the columns they fill
    const int lim = min(rows_s, p.Sk - n * rows_s);
    const int cols = lim << p.log_pack;
    if (p.log_pack > 0) {
      dq_tile<D, kPacked>(cols, dq, q_tile, do_tile, k_tile, v_tile, lim, ri, lse2, dd);
    } else if (lim < kWgRows) {
      dq_tile<D, kRagged>(cols, dq, q_tile, do_tile, k_tile, v_tile, lim, ri, lse2, dd);
    } else {
      dq_tile<D, kNoMask>(cols, dq, q_tile, do_tile, k_tile, v_tile, lim, ri, lse2, dd);
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(empty0 + 8 * st);  // this warp is done with the slot
  }
  store_rows<D>(p.out0, p.os0, dq, r0, ri.t, s0, h0, b, p.log_pack, p.Sq, p.H);
}

// Columns [c0, c0 + N) of one streamed q tile for K3's consumer
// warpgroup: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ; Pᵀ = 2^(Sᵀ·log2 e − lse·log2 e)
// and dSᵀ = Pᵀ ∘ (dPᵀ − D), both 0 on masked columns (query rows past the
// sequence, other heads' rows) and rounded to bf16 for dv += Pᵀ·dO and
// dk += dSᵀ·Q. lse2 and dd hold the tile's 64 per-row values (lse times
// log2 e, D); `lim` is the number of the tile's positions that hold rows.
template <int D, int N, MaskKind kMask>
__device__ __forceinline__ void dkv_cols(float (&dk)[D / 2], float (&dv)[D / 2], uint32_t k_tile,
                                         uint32_t v_tile, uint32_t q_tile, uint32_t do_tile, int c0,
                                         const float* lse2, const float* dd, int lim, const RowInfo& ri) {
  using T = hp::SwizzledTile<D>;
  float s[N / 2], dp[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] = dp[i] = 0.f;
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    hp::wgmma_ss<N>(s, T::kmajor(k_tile, 0, kk), T::kmajor(q_tile, c0, kk), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    hp::wgmma_ss<N>(dp, T::kmajor(v_tile, 0, kk), T::kmajor(do_tile, c0, kk), kk > 0);
  }
  hp::wgmma_commit();
  hp::wgmma_wait_all();
  hp::fence_operands(s);
  hp::fence_operands(dp);

#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = c0 + 8 * j + 2 * ri.t;  // this thread's columns c and c + 1
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
    const float2 d2 = *reinterpret_cast<const float2*>(dd + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool keep = keep_col<kMask>(c + (e & 1), e >> 1, lim, ri);
      const float pr = hp::fast_exp2(fmaf(s[4 * j + e], kLog2e, -((e & 1) ? l2.y : l2.x)));
      s[4 * j + e] = keep ? pr : 0.f;
      dp[4 * j + e] = keep ? pr * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x)) : 0.f;
    }
  }

  // dv += Pᵀ·dO and dk += dSᵀ·Q: q rows c0 + 16kk.. as the k step, dO and
  // Q MN-major through the transpose bit
  uint32_t ap[N / 16][4], ads[N / 16][4];
  acc_to_a<N>(ap, s);
  acc_to_a<N>(ads, dp);
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    T::rs_product(dv, ap[kk], do_tile, c0 + 16 * kk);
    T::rs_product(dk, ads[kk], q_tile, c0 + 16 * kk);
  }
  hp::wgmma_commit();
  hp::wgmma_wait_all();
  hp::fence_operands(dk);
  hp::fence_operands(dv);
  hp::fence_operands(ap);
  hp::fence_operands(ads);
}

// One q tile for K3: its first `cols` columns (only they can hold rows).
template <int D, MaskKind kMask>
__device__ __forceinline__ void dkv_tile(int cols, float (&dk)[D / 2], float (&dv)[D / 2], uint32_t k_tile,
                                         uint32_t v_tile, uint32_t q_tile, uint32_t do_tile, const float* lse2,
                                         const float* dd, int lim, const RowInfo& ri) {
  for_each_chunk<BwdTile<D>::kDkvCols>(cols, [&](auto n, int c0) {
    dkv_cols<D, decltype(n)::value, kMask>(dk, dv, k_tile, v_tile, q_tile, do_tile, c0, lse2, dd, lim, ri);
  });
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, BwdTile<D>::kMinBlocksDkv)
    flash_bwd_dkv_wgmma(const __grid_constant__ hp::TileMaps<D> tm_q, const __grid_constant__ hp::TileMaps<D> tm_k,
                        const __grid_constant__ hp::TileMaps<D> tm_v, const __grid_constant__ hp::TileMaps<D> tm_do,
                        WgParams p) {
  using T = BwdTile<D>;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // own_full, full[], empty[]
  __shared__ __align__(16) float lse_s[kStages][kWgRows];  // lse·log2 e of the slot's q rows
  __shared__ __align__(16) float dd_s[kStages][kWgRows];   // D of the slot's q rows

  const uint32_t k_tile = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_tile = k_tile + T::kTileBytes;
  const uint32_t q_smem = v_tile + T::kTileBytes;  // kStages Q tiles, then kStages dO tiles
  const uint32_t do_smem = q_smem + kStages * T::kTileBytes;
  const uint32_t own_full = hp::smem_u32(&bars[0]);
  const uint32_t full0 = hp::smem_u32(&bars[1]);
  const uint32_t empty0 = hp::smem_u32(&bars[1 + kStages]);

  const int pm = (1 << p.log_pack) - 1;
  const int rows_s = kWgRows >> p.log_pack;
  const int s0 = blockIdx.x * rows_s;  // this block's first key position
  const int h0 = blockIdx.y << p.log_pack;
  const int b = blockIdx.z;
  const int n_tiles = (p.Sq + rows_s - 1) / rows_s;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hp::mbar_init(own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(full0 + 8 * s, 1 + 32);  // the TMA arrival and one per producer lane
      hp::mbar_init(empty0 + 8 * s, 4);      // one arrival per consumer warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // ---- the producer warp: lane 0 starts the TMA loads,
                    // every lane loads lse and D of two of the tile's rows
    if (lane == 0) {
      hp::mbar_arrive_expect_tx(own_full, 2 * T::kTileBytes);
      hp::tma_load_tile<D>(k_tile, tm_k, own_full, h0, s0, b);
      hp::tma_load_tile<D>(v_tile, tm_v, own_full, h0, s0, b);
    }
    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % kStages;
      hp::mbar_wait(empty0 + 8 * st, ((n / kStages) & 1) ^ 1);
      const uint32_t full = full0 + 8 * st;
      if (lane == 0) {
        hp::mbar_arrive_expect_tx(full, 2 * T::kTileBytes);
        hp::tma_load_tile<D>(q_smem + st * T::kTileBytes, tm_q, full, h0, n * rows_s, b);
        hp::tma_load_tile<D>(do_smem + st * T::kTileBytes, tm_do, full, h0, n * rows_s, b);
      }
      for (int r = lane; r < kWgRows; r += 32) {
        const int sq = n * rows_s + (r >> p.log_pack);
        const int h = h0 + (r & pm);
        const bool ok = sq < p.Sq && h < p.H;
        const long long i = (static_cast<long long>(b) * p.H + h) * p.Sq + sq;
        lse_s[st][r] = ok ? p.lse[i] * kLog2e : 0.f;
        dd_s[st][r] = ok ? p.delta[i] : 0.f;
      }
      hp::mbar_arrive(full);  // release: this lane's two rows are stored
    }
    return;
  }

  // ---- the consumer warpgroup: key rows r0 = 16·warp + lane / 4 and r0 + 8
  const int r0 = 16 * warp + (lane >> 2);
  const RowInfo ri{lane & 3, {r0 & pm, (r0 + 8) & pm}, p.log_pack};
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  hp::mbar_wait(own_full, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % kStages;
    hp::mbar_wait(full0 + 8 * st, (n / kStages) & 1);
    const uint32_t q_tile = q_smem + st * T::kTileBytes;
    const uint32_t do_tile = do_smem + st * T::kTileBytes;
    // positions of this tile that hold query rows, and the columns they fill
    const int lim = min(rows_s, p.Sq - n * rows_s);
    const int cols = lim << p.log_pack;
    if (p.log_pack > 0) {
      dkv_tile<D, kPacked>(cols, dk, dv, k_tile, v_tile, q_tile, do_tile, lse_s[st], dd_s[st], lim, ri);
    } else if (lim < kWgRows) {
      dkv_tile<D, kRagged>(cols, dk, dv, k_tile, v_tile, q_tile, do_tile, lse_s[st], dd_s[st], lim, ri);
    } else {
      dkv_tile<D, kNoMask>(cols, dk, dv, k_tile, v_tile, q_tile, do_tile, lse_s[st], dd_s[st], lim, ri);
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(empty0 + 8 * st);  // this warp is done with the slot
  }
  store_rows<D>(p.out0, p.os0, dk, r0, ri.t, s0, h0, b, p.log_pack, p.Sk, p.H);
  store_rows<D>(p.out1, p.os1, dv, r0, ri.t, s0, h0, b, p.log_pack, p.Sk, p.H);
}

// ----------------------------------------------------------------- f32 path

constexpr int kF32Rows = 32;  // rows per block (q rows in K2, keys in K3)
constexpr int kF32Cols = 32;  // the other operand's tile
constexpr int kF32Threads = 4 * kF32Rows;  // 4 threads per row
constexpr int kF32PerThread = kF32Cols / 4;  // columns t, t+4, ...

template <int D>
constexpr size_t smem_bwd_f32() {
  // four [32][D+1] tiles, two [32][33] tiles, two [32] scalar rows
  return sizeof(float) * (4 * kF32Rows * (D + 1) + 2 * kF32Rows * (kF32Cols + 1) + 2 * kF32Cols);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dq_f32(BwdParams p) {
  static_assert(D % 4 == 0, "head_dim must be a multiple of 4");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kF32Rows][D + 1]
  float* dos = qs + kF32Rows * (D + 1);            // [kF32Rows][D + 1]
  float* ks = dos + kF32Rows * (D + 1);            // [kF32Cols][D + 1]
  float* vs = ks + kF32Cols * (D + 1);             // [kF32Cols][D + 1]
  float* ds_s = vs + kF32Cols * (D + 1);           // [kF32Rows][kF32Cols + 1]

  const int m0 = blockIdx.x * kF32Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const int r = threadIdx.x >> 2;  // this thread's q row in the tile
  const int t = threadIdx.x & 3;   // its lane in the row's quad
  const int row = m0 + r;

  const float* q = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
  const float* k = static_cast<const float*>(p.k) + b * p.ks.b + h * p.ks.h;
  const float* v = static_cast<const float*>(p.v) + b * p.vs.b + h * p.vs.h;
  const float* dout = static_cast<const float*>(p.dout) + b * p.dos.b + h * p.dos.h;
  const float* o = static_cast<const float*>(p.o) + b * p.os.b + h * p.os.h;
  float* dq = static_cast<float*>(p.dq) + b * p.dqs.b + h * p.dqs.h;

  load_rows_f32<D, kF32Threads>(qs, D + 1, q, p.qs.s, kF32Rows, m0, p.Sq);
  load_rows_f32<D, kF32Threads>(dos, D + 1, dout, p.dos.s, kF32Rows, m0, p.Sq);
  // D = rowsum(dO ∘ O) − g_lse of this row: the quad's lanes sum columns
  // t, t + 4, ...; lane 0 stores it. Pad rows read nothing
  float dsum = 0.f;
  if (row < p.Sq) {
    for (int c = t; c < D; c += 4) dsum = fmaf(dout[row * p.dos.s + c], o[row * p.os.s + c], dsum);
  }
  dsum = quad_sum(dsum);
  const float lse_r = row < p.Sq ? p.lse[bh * p.Sq + row] : 0.f;
  const float dd_r = row < p.Sq ? dsum - (p.g_lse != nullptr ? p.g_lse[bh * p.Sq + row] : 0.f) : 0.f;
  if (row < p.Sq && t == 0) p.delta[bh * p.Sq + row] = dd_r;

  constexpr int kCols = D / 4;  // output columns t, t+4, t+8, ...
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;

  for (int n0 = 0; n0 < p.Sk; n0 += kF32Cols) {
    __syncthreads();
    load_rows_f32<D, kF32Threads>(ks, D + 1, k, p.ks.s, kF32Cols, n0, p.Sk);
    load_rows_f32<D, kF32Threads>(vs, D + 1, v, p.vs.s, kF32Cols, n0, p.Sk);
    __syncthreads();

    float s[kF32PerThread], dp[kF32PerThread];
#pragma unroll
    for (int i = 0; i < kF32PerThread; ++i) s[i] = dp[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * (D + 1) + d];
      const float od = dos[r * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kF32PerThread; ++i) {
        s[i] = fmaf(qd, ks[(t + 4 * i) * (D + 1) + d], s[i]);
        dp[i] = fmaf(od, vs[(t + 4 * i) * (D + 1) + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kF32PerThread; ++i) {
      const float pr = n0 + t + 4 * i < p.Sk ? expf(s[i] - lse_r) : 0.f;
      ds_s[r * (kF32Cols + 1) + t + 4 * i] = pr * (dp[i] - dd_r);
    }
    __syncwarp();  // the quad's dS row is written before it is read

    for (int j = 0; j < kF32Cols; ++j) {
      const float dsj = ds_s[r * (kF32Cols + 1) + j];
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = fmaf(dsj, ks[j * (D + 1) + t + 4 * i], acc[i]);
    }
  }

  if (row < p.Sq) {
    float* out = dq + row * p.dqs.s;
#pragma unroll
    for (int i = 0; i < kCols; ++i) out[t + 4 * i] = acc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dkv_f32(BwdParams p) {
  static_assert(D % 4 == 0, "head_dim must be a multiple of 4");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [kF32Rows][D + 1]
  float* vs = ks + kF32Rows * (D + 1);             // [kF32Rows][D + 1]
  float* qs = vs + kF32Rows * (D + 1);             // [kF32Cols][D + 1]
  float* dos = qs + kF32Cols * (D + 1);            // [kF32Cols][D + 1]
  float* p_s = dos + kF32Cols * (D + 1);           // [kF32Rows][kF32Cols + 1]
  float* ds_s = p_s + kF32Rows * (kF32Cols + 1);   // [kF32Rows][kF32Cols + 1]
  float* lse_s = ds_s + kF32Rows * (kF32Cols + 1); // [kF32Cols]
  float* dd_s = lse_s + kF32Cols;                  // [kF32Cols]

  const int n0 = blockIdx.x * kF32Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const int r = threadIdx.x >> 2;  // this thread's key row in the tile
  const int t = threadIdx.x & 3;
  const int key = n0 + r;

  const float* q = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
  const float* k = static_cast<const float*>(p.k) + b * p.ks.b + h * p.ks.h;
  const float* v = static_cast<const float*>(p.v) + b * p.vs.b + h * p.vs.h;
  const float* dout = static_cast<const float*>(p.dout) + b * p.dos.b + h * p.dos.h;
  float* dk = static_cast<float*>(p.dk) + b * p.dks.b + h * p.dks.h;
  float* dv = static_cast<float*>(p.dv) + b * p.dvs.b + h * p.dvs.h;

  load_rows_f32<D, kF32Threads>(ks, D + 1, k, p.ks.s, kF32Rows, n0, p.Sk);
  load_rows_f32<D, kF32Threads>(vs, D + 1, v, p.vs.s, kF32Rows, n0, p.Sk);

  constexpr int kCols = D / 4;
  float acc_k[kCols], acc_v[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int m0 = 0; m0 < p.Sq; m0 += kF32Cols) {
    __syncthreads();
    load_rows_f32<D, kF32Threads>(qs, D + 1, q, p.qs.s, kF32Cols, m0, p.Sq);
    load_rows_f32<D, kF32Threads>(dos, D + 1, dout, p.dos.s, kF32Cols, m0, p.Sq);
    load_row_scalars<kF32Threads>(lse_s, p.lse + bh * p.Sq, kF32Cols, m0, p.Sq);
    load_row_scalars<kF32Threads>(dd_s, p.delta + bh * p.Sq, kF32Cols, m0, p.Sq);
    __syncthreads();

    float sT[kF32PerThread], dpT[kF32PerThread];
#pragma unroll
    for (int i = 0; i < kF32PerThread; ++i) sT[i] = dpT[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = ks[r * (D + 1) + d];
      const float vd = vs[r * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kF32PerThread; ++i) {
        sT[i] = fmaf(kd, qs[(t + 4 * i) * (D + 1) + d], sT[i]);
        dpT[i] = fmaf(vd, dos[(t + 4 * i) * (D + 1) + d], dpT[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kF32PerThread; ++i) {
      const int col = t + 4 * i;
      const float pr = m0 + col < p.Sq ? expf(sT[i] - lse_s[col]) : 0.f;
      p_s[r * (kF32Cols + 1) + col] = pr;
      ds_s[r * (kF32Cols + 1) + col] = pr * (dpT[i] - dd_s[col]);
    }
    __syncwarp();  // the quad's P and dS rows are written before they are read

    for (int j = 0; j < kF32Cols; ++j) {
      const float pj = p_s[r * (kF32Cols + 1) + j];
      const float dsj = ds_s[r * (kF32Cols + 1) + j];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        acc_v[i] = fmaf(pj, dos[j * (D + 1) + t + 4 * i], acc_v[i]);
        acc_k[i] = fmaf(dsj, qs[j * (D + 1) + t + 4 * i], acc_k[i]);
      }
    }
  }

  if (key < p.Sk) {
    float* krow = dk + key * p.dks.s;
    float* vrow = dv + key * p.dvs.s;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      krow[t + 4 * i] = acc_k[i];
      vrow[t + 4 * i] = acc_v[i];
    }
  }
}

// ------------------------------------------------------------------ launch

// Heads per 64-row tile, K1's rule: as many as fit both lengths into 64
// rows, up to H's next power of two; one head for lengths over 32.
int pack_log(const BwdParams& p) {
  int lp = 0;
  const int longest = p.Sq > p.Sk ? p.Sq : p.Sk;
  while ((kWgRows >> (lp + 1)) >= longest && (1 << lp) < p.H) ++lp;
  return lp;
}

// Tensor maps of q, k, v, dO and (K2) O, in that order, boxes of one
// swizzled panel by 2^lp heads by 64 >> lp positions.
template <int D>
cudaError_t encode_maps(hp::TileMaps<D>* m, int n, const BwdParams& p, int lp) {
  const int rows_s = kWgRows >> lp;
  const struct {
    const void* base;
    int S;
    Strides st;
  } views[5] = {{p.q, p.Sq, p.qs}, {p.k, p.Sk, p.ks}, {p.v, p.Sk, p.vs}, {p.dout, p.Sq, p.dos}, {p.o, p.Sq, p.os}};
  for (int i = 0; i < n; ++i) {
    const cudaError_t err = hp::encode_tile_maps<D>(&m[i], views[i].base, p.B, views[i].S, p.H, views[i].st.b,
                                                    views[i].st.s, views[i].st.h, 1 << lp, rows_s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// K2 (dq and D, `dkv` false) or K3 (dk, dv) through the wgmma kernels; a
// block per 64-row tile of q rows (K2) or keys (K3).
template <int D, bool dkv>
cudaError_t launch_wgmma(const BwdParams& p, cudaStream_t stream) {
  using T = BwdTile<D>;
  const int lp = pack_log(p);
  hp::TileMaps<D> m[5];
  cudaError_t err = encode_maps<D>(m, dkv ? 4 : 5, p, lp);
  if (err != cudaSuccess) return err;
  WgParams w;
  w.out0 = dkv ? p.dk : p.dq;
  w.out1 = p.dv;
  w.lse = p.lse;
  w.g_lse = p.g_lse;
  w.delta = p.delta;
  w.os0 = dkv ? p.dks : p.dqs;
  w.os1 = p.dvs;
  w.B = p.B;
  w.H = p.H;
  w.Sq = p.Sq;
  w.Sk = p.Sk;
  w.log_pack = lp;
  const int rows_s = kWgRows >> lp;
  const dim3 grid(((dkv ? p.Sk : p.Sq) + rows_s - 1) / rows_s, (p.H + (1 << lp) - 1) >> lp, p.B);
  static std::atomic<unsigned long long> smem_set{0};
  if constexpr (dkv) {
    err = allow_smem(flash_bwd_dkv_wgmma<D>, T::kSmemDkv, smem_set);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_wgmma<D><<<grid, kWgThreads, T::kSmemDkv, stream>>>(m[0], m[1], m[2], m[3], w);
  } else {
    err = allow_smem(flash_bwd_dq_wgmma<D>, T::kSmemDq, smem_set);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_wgmma<D><<<grid, kWgThreads, T::kSmemDq, stream>>>(m[0], m[1], m[2], m[3], m[4], w);
  }
  return cudaGetLastError();
}

// Blocks an SM holds of the bf16 K2 (`dkv` false) or K3 kernel at head_dim
// D, from the occupancy calculator: its registers, threads and shared
// memory.
template <int D, bool dkv>
cudaError_t blocks_per_sm(int* blocks) {
  using T = BwdTile<D>;
  static std::atomic<unsigned long long> smem_set{0};
  const size_t smem = dkv ? T::kSmemDkv : T::kSmemDq;
  const void* kernel;
  if constexpr (dkv) {
    kernel = reinterpret_cast<const void*>(flash_bwd_dkv_wgmma<D>);
  } else {
    kernel = reinterpret_cast<const void*>(flash_bwd_dq_wgmma<D>);
  }
  const cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kWgThreads, smem);
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem, const BwdParams& p,
                          cudaStream_t stream, std::atomic<unsigned long long>& smem_set) {
  const cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, int dtype, cudaStream_t stream) {
  if (dtype == 1) return launch_wgmma<D, false>(p, stream);
  static std::atomic<unsigned long long> smem_set{0};
  const dim3 grid((p.Sq + kF32Rows - 1) / kF32Rows, p.H, p.B);
  return launch_kernel(flash_bwd_dq_f32<D>, grid, kF32Threads, smem_bwd_f32<D>(), p, stream, smem_set);
}

template <int D>
cudaError_t launch_dkv(const BwdParams& p, int dtype, cudaStream_t stream) {
  if (dtype == 1) return launch_wgmma<D, true>(p, stream);
  static std::atomic<unsigned long long> smem_set{0};
  const dim3 grid((p.Sk + kF32Rows - 1) / kF32Rows, p.H, p.B);
  return launch_kernel(flash_bwd_dkv_f32<D>, grid, kF32Threads, smem_bwd_f32<D>(), p, stream, smem_set);
}

bool valid(int dtype, int B, int H, int Sq, int Sk) {
  return (dtype == 0 || dtype == 1) && B >= 1 && H >= 1 && Sq >= 1 && Sk >= 1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for
// (batch, seq, head); the head_dim stride must be 1. lse, g_lse and delta
// are f32 (B*H, Sq); K2 writes delta (rowsum(dO ∘ O) − g_lse; g_lse may be
// null) and K3 reads it. Each returns a cudaError_t (0 = success). Shapes
// are validated by the caller.
int jumbo_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* o,
                       const void* lse, const void* g_lse, void* delta, void* dq,
                       int dtype, int B, int H, int Sq, int Sk, int D,
                       long long q_sb, long long q_ss, long long q_sh,
                       long long k_sb, long long k_ss, long long k_sh,
                       long long v_sb, long long v_ss, long long v_sh,
                       long long do_sb, long long do_ss, long long do_sh,
                       long long o_sb, long long o_ss, long long o_sh,
                       long long dq_sb, long long dq_ss, long long dq_sh,
                       void* stream) {
  if (!valid(dtype, B, H, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.o = o;
  p.lse = static_cast<const float*>(lse);
  p.g_lse = static_cast<const float*>(g_lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.qs = {q_sb, q_ss, q_sh};
  p.ks = {k_sb, k_ss, k_sh};
  p.vs = {v_sb, v_ss, v_sh};
  p.dos = {do_sb, do_ss, do_sh};
  p.os = {o_sb, o_ss, o_sh};
  p.dqs = {dq_sb, dq_ss, dq_sh};
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch_dq<32>(p, dtype, s));
    case 64: return static_cast<int>(launch_dq<64>(p, dtype, s));
    case 80: return static_cast<int>(launch_dq<80>(p, dtype, s));
    case 128: return static_cast<int>(launch_dq<128>(p, dtype, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int jumbo_flash_bwd_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int dtype, int B, int H, int Sq,
                        int Sk, int D,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long do_sb, long long do_ss, long long do_sh,
                        long long dk_sb, long long dk_ss, long long dk_sh,
                        long long dv_sb, long long dv_ss, long long dv_sh,
                        void* stream) {
  if (!valid(dtype, B, H, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(const_cast<void*>(delta));
  p.dk = dk;
  p.dv = dv;
  p.qs = {q_sb, q_ss, q_sh};
  p.ks = {k_sb, k_ss, k_sh};
  p.vs = {v_sb, v_ss, v_sh};
  p.dos = {do_sb, do_ss, do_sh};
  p.dks = {dk_sb, dk_ss, dk_sh};
  p.dvs = {dv_sb, dv_ss, dv_sh};
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch_dkv<32>(p, dtype, s));
    case 64: return static_cast<int>(launch_dkv<64>(p, dtype, s));
    case 80: return static_cast<int>(launch_dkv<80>(p, dtype, s));
    case 128: return static_cast<int>(launch_dkv<128>(p, dtype, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks an SM holds of the bf16 K2 (which = 0) or K3 (1) kernel at
// head_dim D, written to *blocks. Returns a cudaError_t.
int jumbo_flash_bwd_blocks_per_sm(int which, int D, int* blocks) {
  const bool dkv = which != 0;
  switch (D) {
    case 32: return static_cast<int>(dkv ? blocks_per_sm<32, true>(blocks) : blocks_per_sm<32, false>(blocks));
    case 64: return static_cast<int>(dkv ? blocks_per_sm<64, true>(blocks) : blocks_per_sm<64, false>(blocks));
    case 80: return static_cast<int>(dkv ? blocks_per_sm<80, true>(blocks) : blocks_per_sm<80, false>(blocks));
    case 128: return static_cast<int>(dkv ? blocks_per_sm<128, true>(blocks) : blocks_per_sm<128, false>(blocks));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* jumbo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
