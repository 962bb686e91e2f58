// Flash-attention backward for Hopper (sm_90a), two kernels and no atomics:
//
//   K2 (dq):  dq = Σ_k (P ∘ (dO·Vᵀ − D))·K
//   K3 (dkv): dv = Σ_q Pᵀ·dO,   dk = Σ_q (P ∘ (dO·Vᵀ − D))ᵀ·Q
//
// with P = exp(q·kᵀ − lse) recomputed from the forward's lse, and
// D = rowsum(dO ∘ O) computed before the kernels (plain torch, as the JAX
// package computes it outside its kernels).
//
// Replaces: `_bwd_dq_kernel` (K2) and `_bwd_dkv_kernel` (K3), launched by
// `_flash_bwd`, in jumbo_mae_tpu_tpu/ops/pallas/attention.py. Same
// contract: q arrives already scaled, so dq is the gradient w.r.t. the
// scaled q; key columns >= Sk get P = 0; P and dS are cast to the operand
// dtype before each product they feed, products accumulate in f32.
//
// Two kernels, no atomics: each output element is owned by one block,
// which sums its terms in a fixed order, so two runs give bit-identical
// gradients (the TPU design chose this too). K2's block owns a 64-row q
// tile and loops over K/V tiles; K3's block owns a key tile and loops over
// q tiles.
//
// Pad rows and columns are masked by the kernels themselves (no pad copy,
// unlike Pallas, which padded S to 128): K2 zeroes P for keys >= Sk; K3
// zeroes P for query rows >= Sq, whose lse, D and dO loads are guarded,
// so they contribute exactly 0 to dk and dv.
//
// What bounds it on an H100: at the MAE shapes (S = 52 and 199, head_dim
// 64 and 32) K2 does 3 and K3 4 products of 2·S²·D flops per (batch,
// head) against q, k, v, dO, lse and D read once and the gradients
// written once; with S this short that is under the card's ~295 bf16
// flops per byte, so the bound is bytes. What the design does about it:
// P and dS never leave registers (the mma.sync accumulator layout is
// reused as the next product's A fragment), each block reads its own
// tile once and streams the other operand's tiles through shared memory.
// Simple first: synchronous loads, no double buffering; wgmma, TMA and a
// tile ring are later work.
//
// Layout: q, k, v and dO are (B, S, H, D) read through strides (innermost
// stride 1); lse and D are f32 (B*H, Sq) with row b*H + h (K1's lse
// layout); dq, dk and dv are written through strides in the input dtype.
//
// Two instantiations per head_dim (32, 64, 80, 128):
//  - bf16: 4 warps of 16 rows, mma.sync m16n8k16 with f32 accumulation.
//    K2: 64 q rows per block, 64-key tiles. K3: 64 keys per block; the q
//    tile is 64 rows up to head_dim 80 and 32 rows at 128, so that the
//    two (16 x head_dim) f32 accumulators of dk and dv plus the (16 x
//    q tile) score tiles fit in registers without spills.
//  - f32: plain FMA in full f32 (no TF32), 32-row tiles with 4 threads per
//    row. This is the exact path parity runs take.
//
// Plain C interface, loaded with ctypes: each entry point returns
// cudaGetLastError() after its launch (0 on success).

#include "flash_common.cuh"

namespace {

using namespace jumbo_flash;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B*H, Sq)
  const float* delta;  // (B*H, Sq), rowsum(dO ∘ O)
  void* dq;
  void* dk;
  void* dv;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  int B, H, Sq, Sk;
};

// ---------------------------------------------------------------- bf16 path

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kDqRows = 16 * kWarps;  // K2: q rows per block
constexpr int kDqKeys = 64;           // K2: keys per K/V tile
constexpr int kDkvKeys = 16 * kWarps; // K3: keys per block

// K3's q tile: see the register budget in the header comment.
template <int D>
__host__ __device__ constexpr int dkv_q_rows() {
  return D <= 80 ? 64 : 32;
}

template <int D>
constexpr size_t smem_dq_bf16() {
  // qs, dos [kDqRows][D+kPad]; ks, vs [kDqKeys][D+kPad]; kt [D][kDqKeys+kPad]
  return sizeof(__nv_bfloat16) * (2 * kDqRows * (D + kPad) + 2 * kDqKeys * (D + kPad) +
                                  D * (kDqKeys + kPad));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16(BwdParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ld = D + kPad;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kDqRows * ld;
  __nv_bfloat16* ks = dos + kDqRows * ld;
  __nv_bfloat16* vs = ks + kDqKeys * ld;
  __nv_bfloat16* kt = vs + kDqKeys * ld;

  const int m0 = blockIdx.x * kDqRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.qs.b + h * p.qs.h;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.ks.b + h * p.ks.h;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.vs.b + h * p.vs.h;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) + b * p.dos.b + h * p.dos.h;
  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(p.dq) + b * p.dqs.b + h * p.dqs.h;

  load_rows_bf16<D, kDqRows, kThreads>(qs, q, p.qs.s, m0, p.Sq);
  load_rows_bf16<D, kDqRows, kThreads>(dos, dout, p.dos.s, m0, p.Sq);

  // lse and D of rows g and g+8 of this warp's 16; pad rows read nothing
  const int rows[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};
  float lse_r[2], dd_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < p.Sq;
    lse_r[r] = ok ? p.lse[bh * p.Sq + rows[r]] : 0.f;
    dd_r[r] = ok ? p.delta[bh * p.Sq + rows[r]] : 0.f;
  }

  constexpr int kSteps = D / 16;
  constexpr int kKeyTiles = kDqKeys / 8;
  constexpr int kOutTiles = D / 8;
  float acc[kOutTiles][4];
#pragma unroll
  for (int j = 0; j < kOutTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const __nv_bfloat16* qw = qs + warp * 16 * ld;
  const __nv_bfloat16* dow = dos + warp * 16 * ld;

  for (int n0 = 0; n0 < p.Sk; n0 += kDqKeys) {
    __syncthreads();  // the previous tile is consumed by every warp
    load_rows_bf16<D, kDqKeys, kThreads>(ks, k, p.ks.s, n0, p.Sk);
    load_rows_bf16<D, kDqKeys, kThreads>(vs, v, p.vs.s, n0, p.Sk);
    load_rows_transposed_bf16<D, kDqKeys, kThreads>(kt, k, p.ks.s, n0, p.Sk);
    __syncthreads();

    // s = q·kᵀ and dp = dO·vᵀ, 16 rows x kDqKeys keys each, f32
    float s[kKeyTiles][4], dp[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      uint32_t aq[4], ado[4];
      load_a_frag(aq, qw, ld, st, g, t);
      load_a_frag(ado, dow, ld, st, g, t);
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        const __nv_bfloat16* kr = ks + (j * 8 + g) * ld + st * 16;
        const __nv_bfloat16* vr = vs + (j * 8 + g) * ld + st * 16;
        mma_16816(s[j], aq, ld_smem_u32(kr + 2 * t), ld_smem_u32(kr + 8 + 2 * t));
        mma_16816(dp[j], ado, ld_smem_u32(vr + 2 * t), ld_smem_u32(vr + 8 + 2 * t));
      }
    }

    // P = exp(s − lse), 0 on pad keys; dS = P ∘ (dp − D), kept in s
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        const int key = n0 + j * 8 + 2 * t + (c & 1);
        const float pr = key < p.Sk ? __expf(s[j][c] - lse_r[r]) : 0.f;
        s[j][c] = pr * (dp[j][c] - dd_r[r]);
      }
    }

    // dq += dS·K, dS cast to bf16 as the A operand, K from the transposed tile
#pragma unroll
    for (int kk = 0; kk < kDqKeys / 16; ++kk) {
      uint32_t a[4];
      acc_to_a_frag(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < kOutTiles; ++j) {
        const __nv_bfloat16* kr = kt + (j * 8 + g) * (kDqKeys + kPad) + kk * 16;
        mma_16816(acc[j], a, ld_smem_u32(kr + 2 * t), ld_smem_u32(kr + 8 + 2 * t));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.Sq) continue;
    __nv_bfloat16* row = dq + rows[r] * p.dqs.s;
#pragma unroll
    for (int j = 0; j < kOutTiles; ++j) {
      *reinterpret_cast<uint32_t*>(row + j * 8 + 2 * t) =
          pack_bf16x2(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

template <int D>
constexpr size_t smem_dkv_bf16() {
  constexpr int kQ = dkv_q_rows<D>();
  // ks, vs [kDkvKeys][D+kPad]; qs, dos [kQ][D+kPad]; qt, dot [D][kQ+kPad];
  // lse, D [kQ] f32
  return sizeof(__nv_bfloat16) * (2 * kDkvKeys * (D + kPad) + 2 * kQ * (D + kPad) +
                                  2 * D * (kQ + kPad)) +
         sizeof(float) * 2 * kQ;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16(BwdParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kQ = dkv_q_rows<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ld = D + kPad;
  constexpr int ldt = kQ + kPad;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kDkvKeys * ld;
  __nv_bfloat16* qs = vs + kDkvKeys * ld;
  __nv_bfloat16* dos = qs + kQ * ld;
  __nv_bfloat16* qt = dos + kQ * ld;
  __nv_bfloat16* dot = qt + D * ldt;
  float* lse_s = reinterpret_cast<float*>(dot + D * ldt);
  float* dd_s = lse_s + kQ;

  const int n0 = blockIdx.x * kDkvKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.qs.b + h * p.qs.h;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.ks.b + h * p.ks.h;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.vs.b + h * p.vs.h;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) + b * p.dos.b + h * p.dos.h;
  __nv_bfloat16* dk = static_cast<__nv_bfloat16*>(p.dk) + b * p.dks.b + h * p.dks.h;
  __nv_bfloat16* dv = static_cast<__nv_bfloat16*>(p.dv) + b * p.dvs.b + h * p.dvs.h;
  const float* lse = p.lse + bh * p.Sq;
  const float* delta = p.delta + bh * p.Sq;

  load_rows_bf16<D, kDkvKeys, kThreads>(ks, k, p.ks.s, n0, p.Sk);
  load_rows_bf16<D, kDkvKeys, kThreads>(vs, v, p.vs.s, n0, p.Sk);

  constexpr int kSteps = D / 16;
  constexpr int kQTiles = kQ / 8;
  constexpr int kOutTiles = D / 8;
  float acc_k[kOutTiles][4], acc_v[kOutTiles][4];
#pragma unroll
  for (int j = 0; j < kOutTiles; ++j) {
    acc_k[j][0] = acc_k[j][1] = acc_k[j][2] = acc_k[j][3] = 0.f;
    acc_v[j][0] = acc_v[j][1] = acc_v[j][2] = acc_v[j][3] = 0.f;
  }
  const __nv_bfloat16* kw = ks + warp * 16 * ld;
  const __nv_bfloat16* vw = vs + warp * 16 * ld;

  for (int m0 = 0; m0 < p.Sq; m0 += kQ) {
    __syncthreads();  // the previous q tile is consumed by every warp
    load_rows_bf16<D, kQ, kThreads>(qs, q, p.qs.s, m0, p.Sq);
    load_rows_bf16<D, kQ, kThreads>(dos, dout, p.dos.s, m0, p.Sq);
    load_rows_transposed_bf16<D, kQ, kThreads>(qt, q, p.qs.s, m0, p.Sq);
    load_rows_transposed_bf16<D, kQ, kThreads>(dot, dout, p.dos.s, m0, p.Sq);
    load_row_scalars<kThreads>(lse_s, lse, kQ, m0, p.Sq);
    load_row_scalars<kThreads>(dd_s, delta, kQ, m0, p.Sq);
    __syncthreads();

    // transposed scores: sT = k·qᵀ and dpT = v·dOᵀ, 16 keys x kQ q rows
    float sT[kQTiles][4], dpT[kQTiles][4];
#pragma unroll
    for (int j = 0; j < kQTiles; ++j) {
      sT[j][0] = sT[j][1] = sT[j][2] = sT[j][3] = 0.f;
      dpT[j][0] = dpT[j][1] = dpT[j][2] = dpT[j][3] = 0.f;
    }
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      uint32_t ak[4], av[4];
      load_a_frag(ak, kw, ld, st, g, t);
      load_a_frag(av, vw, ld, st, g, t);
#pragma unroll
      for (int j = 0; j < kQTiles; ++j) {
        const __nv_bfloat16* qr = qs + (j * 8 + g) * ld + st * 16;
        const __nv_bfloat16* dr = dos + (j * 8 + g) * ld + st * 16;
        mma_16816(sT[j], ak, ld_smem_u32(qr + 2 * t), ld_smem_u32(qr + 8 + 2 * t));
        mma_16816(dpT[j], av, ld_smem_u32(dr + 2 * t), ld_smem_u32(dr + 8 + 2 * t));
      }
    }

    // Pᵀ = exp(sT − lse), exactly 0 on pad query rows; dSᵀ = Pᵀ ∘ (dpT − D)
#pragma unroll
    for (int j = 0; j < kQTiles; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = j * 8 + 2 * t + (c & 1);
        const float pr = m0 + col < p.Sq ? __expf(sT[j][c] - lse_s[col]) : 0.f;
        sT[j][c] = pr;
        dpT[j][c] = pr * (dpT[j][c] - dd_s[col]);
      }
    }

    // dv += Pᵀ·dO and dk += dSᵀ·Q, both cast to bf16 as A operands
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      uint32_t ap[4], ads[4];
      acc_to_a_frag(ap, sT[2 * kk], sT[2 * kk + 1]);
      acc_to_a_frag(ads, dpT[2 * kk], dpT[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < kOutTiles; ++j) {
        const __nv_bfloat16* dr = dot + (j * 8 + g) * ldt + kk * 16;
        const __nv_bfloat16* qr = qt + (j * 8 + g) * ldt + kk * 16;
        mma_16816(acc_v[j], ap, ld_smem_u32(dr + 2 * t), ld_smem_u32(dr + 8 + 2 * t));
        mma_16816(acc_k[j], ads, ld_smem_u32(qr + 2 * t), ld_smem_u32(qr + 8 + 2 * t));
      }
    }
  }

  const int keys[2] = {n0 + warp * 16 + g, n0 + warp * 16 + g + 8};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= p.Sk) continue;
    __nv_bfloat16* krow = dk + keys[r] * p.dks.s;
    __nv_bfloat16* vrow = dv + keys[r] * p.dvs.s;
#pragma unroll
    for (int j = 0; j < kOutTiles; ++j) {
      *reinterpret_cast<uint32_t*>(krow + j * 8 + 2 * t) =
          pack_bf16x2(acc_k[j][2 * r], acc_k[j][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(vrow + j * 8 + 2 * t) =
          pack_bf16x2(acc_v[j][2 * r], acc_v[j][2 * r + 1]);
    }
  }
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
  float* dq = static_cast<float*>(p.dq) + b * p.dqs.b + h * p.dqs.h;

  load_rows_f32<D, kF32Threads>(qs, D + 1, q, p.qs.s, kF32Rows, m0, p.Sq);
  load_rows_f32<D, kF32Threads>(dos, D + 1, dout, p.dos.s, kF32Rows, m0, p.Sq);
  const float lse_r = row < p.Sq ? p.lse[bh * p.Sq + row] : 0.f;
  const float dd_r = row < p.Sq ? p.delta[bh * p.Sq + row] : 0.f;

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

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem,
                          const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, int dtype, cudaStream_t stream) {
  if (dtype == 1) {
    const dim3 grid((p.Sq + kDqRows - 1) / kDqRows, p.H, p.B);
    return launch_kernel(flash_bwd_dq_bf16<D>, grid, kThreads, smem_dq_bf16<D>(), p, stream);
  }
  const dim3 grid((p.Sq + kF32Rows - 1) / kF32Rows, p.H, p.B);
  return launch_kernel(flash_bwd_dq_f32<D>, grid, kF32Threads, smem_bwd_f32<D>(), p, stream);
}

template <int D>
cudaError_t launch_dkv(const BwdParams& p, int dtype, cudaStream_t stream) {
  if (dtype == 1) {
    const dim3 grid((p.Sk + kDkvKeys - 1) / kDkvKeys, p.H, p.B);
    return launch_kernel(flash_bwd_dkv_bf16<D>, grid, kThreads, smem_dkv_bf16<D>(), p, stream);
  }
  const dim3 grid((p.Sk + kF32Rows - 1) / kF32Rows, p.H, p.B);
  return launch_kernel(flash_bwd_dkv_f32<D>, grid, kF32Threads, smem_bwd_f32<D>(), p, stream);
}

bool valid(int dtype, int B, int H, int Sq, int Sk) {
  return (dtype == 0 || dtype == 1) && B >= 1 && H >= 1 && Sq >= 1 && Sk >= 1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for
// (batch, seq, head); the head_dim stride must be 1. lse and delta are
// f32 (B*H, Sq). Each returns a cudaError_t (0 = success). Shapes are
// validated by the caller.
int jumbo_flash_bwd_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int dtype, int B, int H, int Sq, int Sk, int D,
                       long long q_sb, long long q_ss, long long q_sh,
                       long long k_sb, long long k_ss, long long k_sh,
                       long long v_sb, long long v_ss, long long v_sh,
                       long long do_sb, long long do_ss, long long do_sh,
                       long long dq_sb, long long dq_ss, long long dq_sh,
                       void* stream) {
  if (!valid(dtype, B, H, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.qs = {q_sb, q_ss, q_sh};
  p.ks = {k_sb, k_ss, k_sh};
  p.vs = {v_sb, v_ss, v_sh};
  p.dos = {do_sb, do_ss, do_sh};
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
  p.delta = static_cast<const float*>(delta);
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

const char* jumbo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
