// Per-row symmetric int8 quantization for Hopper (sm_90a).
//
// Replaces repro/kernels/quantize.py::_quant_kernel (the Pallas kernel the
// JAX package names for its compression uploads; its oracle
// quantize_int8_ref computes the same function). For each row r of a
// contiguous (rows, cols) f32 matrix x it writes
//
//   s[r]    = max(absmax(x[r, :]), 1e-12) / 127
//   q[r, c] = clip(round_half_even(x[r, c] / s[r]), -127, 127) as int8
//
// q and s must be bitwise equal to the plain PyTorch version and to the
// numpy/JAX oracle, so every operation is singly rounded: the build passes
// --fmad=false and -prec-div=true, the divisions are __fdiv_rn, and the
// rounding is rintf (round half to even, as torch.round and jnp.round).
// jnp.max and jnp.maximum propagate NaN where fmaxf drops it, so both the
// row's absmax and the max with 1e-12 go through nan_max below: a row with
// a NaN gets a NaN scale, as in the reference. q of a non-finite row is
// unspecified.
//
// Design: one block of 256 threads per row. Where cols is a multiple of 4,
// at most 4096, and the pointers are 16-byte aligned (the codec's rows of
// 4096 and the round payload's 256), each thread loads up to 4 float4s into
// registers, so the row is read from device memory once and written once
// as char4 stores. Other shapes take a strided scalar loop that reads the
// row twice (the second read mostly hits L1/L2). The absmax is a warp
// shuffle max, then a max over the 8 warps through shared memory.
//
// Bound: bandwidth. The kernel reads rows*cols*4 bytes, writes rows*cols
// bytes of q and rows*4 of s, and does about 5 operations a value. At
// (65536, 4096) that is 1.342 GB, about 0.40 ms at 3.35 TB/s, and 1.3 G
// operations, under 0.02 ms at the card's f32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecPerThread = 4;  // float4s a thread keeps in registers
constexpr int kVecCols = kThreads * kVecPerThread * 4;  // 4096

__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// The row's absmax, reduced over the block; every thread gets it.
__device__ __forceinline__ float block_max(float v, float* warp_max) {
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  v = warp_max[0];
  for (int w = 1; w < kWarps; ++w) v = nan_max(v, warp_max[w]);
  return v;
}

__device__ __forceinline__ float row_scale(float absmax) {
  return __fdiv_rn(nan_max(absmax, 1e-12f), 127.0f);
}

__device__ __forceinline__ signed char quantize(float v, float scale) {
  float r = rintf(__fdiv_rn(v, scale));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return (signed char)(int)r;
}

// cols % 4 == 0, cols <= 4096, 16-byte aligned rows: one read of the row.
__global__ void __launch_bounds__(kThreads)
quantize_rows_vec(const float* __restrict__ x, signed char* __restrict__ q,
                  float* __restrict__ s, int cols) {
  __shared__ float warp_max[kWarps];
  const int64_t row = blockIdx.x;
  const int cols4 = cols >> 2;
  const float4* xr = reinterpret_cast<const float4*>(x + row * cols);
  char4* qr = reinterpret_cast<char4*>(q + row * cols);

  float4 v[kVecPerThread];
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    const int c = threadIdx.x + k * kThreads;
    v[k] = c < cols4 ? xr[c] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    m = nan_max(m, fabsf(v[k].x));
    m = nan_max(m, fabsf(v[k].y));
    m = nan_max(m, fabsf(v[k].z));
    m = nan_max(m, fabsf(v[k].w));
  }
  const float scale = row_scale(block_max(m, warp_max));
#pragma unroll
  for (int k = 0; k < kVecPerThread; ++k) {
    const int c = threadIdx.x + k * kThreads;
    if (c < cols4)
      qr[c] = make_char4(quantize(v[k].x, scale), quantize(v[k].y, scale),
                         quantize(v[k].z, scale), quantize(v[k].w, scale));
  }
  if (threadIdx.x == 0) s[row] = scale;
}

// Any other shape: a strided loop over the row, read twice.
__global__ void __launch_bounds__(kThreads)
quantize_rows_any(const float* __restrict__ x, signed char* __restrict__ q,
                  float* __restrict__ s, int cols) {
  __shared__ float warp_max[kWarps];
  const int64_t row = blockIdx.x;
  const float* xr = x + row * cols;
  signed char* qr = q + row * cols;

  float m = 0.0f;
  for (int c = threadIdx.x; c < cols; c += kThreads) m = nan_max(m, fabsf(xr[c]));
  const float scale = row_scale(block_max(m, warp_max));
  for (int c = threadIdx.x; c < cols; c += kThreads) qr[c] = quantize(xr[c], scale);
  if (threadIdx.x == 0) s[row] = scale;
}

}  // namespace

// Launches the quantization of a contiguous (rows, cols) f32 matrix x on
// `stream` into q (rows, cols) int8 and s (rows,) f32, and returns
// cudaGetLastError() as an int (0 = launched). The caller owns every
// buffer; rows and cols are positive.
extern "C" int quantize_int8_launch(const float* x, signed char* q, float* s,
                                    int rows, int cols, void* stream) {
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)q % 4 == 0);
  cudaStream_t st = (cudaStream_t)stream;
  if (cols % 4 == 0 && cols <= kVecCols && aligned)
    quantize_rows_vec<<<rows, kThreads, 0, st>>>(x, q, s, cols);
  else
    quantize_rows_any<<<rows, kThreads, 0, st>>>(x, q, s, cols);
  return (int)cudaGetLastError();
}
