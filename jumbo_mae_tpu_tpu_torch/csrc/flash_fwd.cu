// Flash-attention forward for Hopper (sm_90a): o = softmax(q·kᵀ)·v, and
// optionally lse = m + log(l) per query row.
//
// Replaces: `_fwd_kernel`, launched by `_flash_fwd`, in
// jumbo_mae_tpu_tpu/ops/pallas/attention.py (the Pallas TPU kernel K1).
// Same contract: q arrives already scaled by head_dim**-0.5 and is NOT
// scaled again; K/V stream in tiles under the online-softmax recurrence
// (m, l, acc) kept in f32; matmul operands stay in the input dtype; key
// columns at index >= Sk are masked to -1e30; lse is f32 (B*H, Sq) with
// row b*H + h, the Pallas layout.
//
// What bounds it on an H100: at the serving shapes (S = 199, head_dim 64)
// the work is 4*S*D flops per (row, key) pair against 2 bytes per element
// moved, about 100 flops per byte, under the card's ~295 bf16 flops per
// byte of memory rate. So the bound is bytes: read q, k and v once, write
// o once. What the design does about it: the (S, S) score matrix never
// leaves registers; each block reads its 64-row q tile once and streams
// K/V tiles through shared memory; scores and P·V run on the tensor cores
// (mma.sync m16n8k16 bf16, f32 accumulate) so the arithmetic stays well
// under the memory time. Each K/V tile is re-read by every q tile of its
// (batch, head), from L2 at these lengths. Later work: wgmma, TMA and a
// double-buffered K/V ring.
//
// Layout: q, k, v and o are (B, S, H, D) read through strides (innermost
// stride 1), with no fold to (B*H, S, D) and no pad copy — the kernel
// masks ragged query rows and key columns itself.
//
// Two instantiations per head_dim (32, 64, 80, 128):
//  - bf16: 4 warps, 16 query rows each (64-row tiles), 64-key tiles,
//    tensor-core mma.sync;
//  - f32: plain FMA in full f32 (no TF32), 32-row tiles with 4 threads per
//    row, 32-key tiles. This is the exact path parity runs take.
//
// Plain C interface, loaded with ctypes: jumbo_flash_fwd returns
// cudaGetLastError() after the launch (0 on success).

#include "flash_common.cuh"

namespace {

using namespace jumbo_flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // nullptr: not requested
  Strides qs, ks, vs, os;
  int B, H, Sq, Sk;
};

// ---------------------------------------------------------------- bf16 path

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = 16 * kWarps;  // query rows per block
constexpr int kBlockN = 64;           // keys per K/V tile

template <int D>
constexpr size_t smem_bytes_bf16() {
  return sizeof(__nv_bfloat16) *
         ((kBlockM + kBlockN) * (D + kPad) + D * (kBlockN + kPad));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Params p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockM * (D + kPad);
  __nv_bfloat16* vt = ks + kBlockN * (D + kPad);

  const int m0 = blockIdx.x * kBlockM;
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

  load_rows_bf16<D, kBlockM, kThreads>(qs, q, p.qs.s, m0, p.Sq);
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

  constexpr int kKeyTiles = kBlockN / 8;
  for (int n0 = 0; n0 < p.Sk; n0 += kBlockN) {
    __syncthreads();  // the previous tile is consumed by every warp
    load_rows_bf16<D, kBlockN, kThreads>(ks, k, p.ks.s, n0, p.Sk);
    load_rows_transposed_bf16<D, kBlockN, kThreads>(vt, v, p.vs.s, n0, p.Sk);
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
    if (n0 + kBlockN > p.Sk) {  // ragged last tile: mask the pad keys
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
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      acc_to_a_frag(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < kOutTiles; ++j) {
        const __nv_bfloat16* vr = vt + (j * 8 + g) * (kBlockN + kPad) + kk * 16;
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
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  cudaError_t err;
  if (dtype == 1) {
    constexpr size_t smem = smem_bytes_bf16<D>();
    err = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sq + kBlockM - 1) / kBlockM, p.H, p.B);
    flash_fwd_bf16<D><<<grid, kThreads, smem, stream>>>(p);
  } else {
    constexpr size_t smem = smem_bytes_f32<D>();
    err = cudaFuncSetAttribute(flash_fwd_f32<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sq + kF32Rows - 1) / kF32Rows, p.H, p.B);
    flash_fwd_f32<D><<<grid, kF32Threads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for
// (batch, seq, head); the head_dim stride must be 1. lse may be null.
// Returns a cudaError_t (0 = success). Shapes are validated by the caller.
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
  switch (D) {
    case 32: return static_cast<int>(launch<32>(p, dtype, s));
    case 64: return static_cast<int>(launch<64>(p, dtype, s));
    case 80: return static_cast<int>(launch<80>(p, dtype, s));
    case 128: return static_cast<int>(launch<128>(p, dtype, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* jumbo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
