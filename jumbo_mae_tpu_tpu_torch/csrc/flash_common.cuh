// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the strided (B, S, H, D) view, bf16 packing and the f32 kernels' loads
// from device memory into shared memory. Each .cu file is compiled on its
// own into its own library, so everything here is header-only.

#pragma once

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace jumbo_flash {

constexpr float kNegInf = -1e30f;  // finite, as in the Pallas kernels

struct Strides {
  long long b, s, h;  // in elements; the head_dim stride is 1
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc + Σ a_i·b_i over the 8 bf16 pairs of two 16-byte chunks, in f32, in
// a fixed order.
__device__ __forceinline__ float dot8_bf16(const uint4& a, const uint4& b, float acc) {
  const uint32_t* x = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* y = reinterpret_cast<const uint32_t*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + i));
    const float2 fy = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(y + i));
    acc = fmaf(fx.x, fy.x, acc);
    acc = fmaf(fx.y, fy.y, acc);
  }
  return acc;
}

// The sum of `x` over the 4 lanes of a quad (lanes 4k..4k+3), the same
// bits in each: (x0 + x1) + (x2 + x3) in every lane, as f32 addition
// commutes.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The bf16 A fragments of a wgmma m64nN accumulator, whose chunk j
// (columns 8j..8j+7) is x[4j..4j+3] in the mma.sync layout: k step kk
// (columns 16kk..16kk+15) is chunks 2kk and 2kk+1.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16x2(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// f32 rows [row0, row0 + rows) into shared memory with row stride
// dst_stride; rows >= n are zeros.
template <int D, int kThreads>
__device__ __forceinline__ void load_rows_f32(float* dst, int dst_stride,
                                              const float* src,
                                              long long row_stride, int rows,
                                              int row0, int n) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    dst[r * dst_stride + c] = (row0 + r < n) ? src[(row0 + r) * row_stride + c] : 0.f;
  }
}

// Per-row f32 values (lse, D) of rows [row0, row0 + rows) of one
// (batch·head) row of a (B·H, S) array; rows >= n are zeros.
template <int kThreads>
__device__ __forceinline__ void load_row_scalars(float* dst, const float* src,
                                                 int rows, int row0, int n) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    dst[i] = (row0 + i < n) ? src[row0 + i] : 0.f;
  }
}

// The maximum dynamic shared memory of `kernel`, raised once per device
// (`done` holds one bit per device ordinal), not on every launch.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, std::atomic<unsigned long long>& done) {
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

}  // namespace jumbo_flash
