// Mamba selective scan for Hopper (sm_90a).
//
// Replaces repro/kernels/ssm_scan.py::_ssm_kernel (the Pallas kernel; its
// oracle ssm_scan_ref computes the same function). For dt (B, S, inner) f32,
// x (B, S, inner) f32 or bf16, Bm, Cm (B, S, N) f32, A (inner, N) f32 and an
// optional h0 (B, inner, N) f32, all contiguous, it writes y (B, S, inner)
// and the final state h (B, inner, N), both f32:
//
//   h[c, n] <- expf(dt[t, c] * A[c, n]) * h[c, n] + (dt[t, c] * x[t, c]) * Bm[t, n]
//   y[t, c]  = sum_n h[c, n] * Cm[t, n]                 for t = 0 .. S-1
//
// Every operation is singly rounded, in the order of ssm_scan_plain (built
// with --fmad=false, no fmaf: a * h + bx is a multiply then an add), and
// the exponential is expf (never __expf); only the order of y's 16-term sum
// may differ from the plain version's.
//
// Design: channels are independent, so one thread owns one (batch row,
// channel) and keeps its N states and its row of A in registers; the
// sequence runs in a loop inside the thread (the Pallas grid's sequential
// chunk axis), so no state crosses a block or goes through device memory
// until the end. A block of 128 channels walks S in chunks of 16 steps: it
// stages the chunk's Bm and Cm rows (the same for every channel of a batch
// row) in shared memory, each thread loads its 16 dt and x values into
// registers at once (coalesced across the warp, all in flight together),
// then runs the 16 steps from registers, reading a step's Bm and Cm rows
// from shared memory four floats a load (a broadcast: the exponentials
// share the same dispatch queue). It is built for N = 16 only, the state
// size of every config in the repo (jamba's d_state); other sizes return
// cudaErrorInvalidValue. At most 128 registers a thread, so an SM holds
// four blocks and the long wave's 512 blocks run in one wave. The ragged tail of S and of inner is masked in-kernel: any S and
// inner.
//
// Bound: per call the kernel must read dt and x and write y (Bm, Cm, A and
// the states are small): at the LLM path's long wave (4, 2048, 16384, 16)
// with bf16 x that is 1.35 GB, 0.40 ms at 3.35 TB/s, while its 2.1e9
// (channel, state, step) updates are ~1.5e10 f32 operations, 0.22 ms at 67
// TFLOP/s: the bytes bound it. The exponentials (one per update) run on the
// SFUs, 16 a clock on an SM against 128 f32 lanes, and with one thread per
// channel only B * inner threads exist (65 536 at the long wave, a quarter
// of what the card holds), so the expected time is a few times the bound.
// Splitting the states over threads, a cheaper exp of dt * A, and a chunked
// parallel scan across time are the later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels of a block
constexpr int kChunk = 16;     // time steps staged at once
constexpr int kState = 16;     // N, the one state size built
constexpr int kMinBlocks = 4;  // blocks an SM must hold: <= 128 registers a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Row tt of a chunk's staged Bm or Cm into registers, four floats a load.
template <int N>
__device__ __forceinline__ void row(float (&dst)[N], const float* src) {
  static_assert(N % 4 == 0, "rows are read as float4");
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    dst[4 * q] = v.x;
    dst[4 * q + 1] = v.y;
    dst[4 * q + 2] = v.z;
    dst[4 * q + 3] = v.w;
  }
}

template <int N, typename TX>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssm_scan_fwd(const float* __restrict__ dt, const float* __restrict__ Bm,
             const float* __restrict__ Cm, const TX* __restrict__ x,
             const float* __restrict__ A, const float* __restrict__ h0,
             float* __restrict__ y, float* __restrict__ h_out, int S, int inner) {
  __shared__ __align__(16) float b_s[kChunk][N];
  __shared__ __align__(16) float c_s[kChunk][N];

  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < inner;
  const int64_t state_row = ((int64_t)b * inner + c) * N;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[(int64_t)c * N + n] : 0.0f;
    h[n] = (live && h0 != nullptr) ? h0[state_row + n] : 0.0f;
  }

  const int64_t row0 = (int64_t)b * S;  // row (b, t = 0) of the (B * S) rows
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int len = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk's Bm, Cm fully read
    for (int e = threadIdx.x; e < len * N; e += kThreads) {
      const int tt = e / N, n = e - tt * N;
      b_s[tt][n] = Bm[(row0 + t0 + tt) * N + n];
      c_s[tt][n] = Cm[(row0 + t0 + tt) * N + n];
    }
    float dtr[kChunk], xr[kChunk];
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      dtr[tt] = 0.0f;
      xr[tt] = 0.0f;
      if (live && tt < len) {
        const int64_t i = (row0 + t0 + tt) * inner + c;
        dtr[tt] = dt[i];
        xr[tt] = to_f32(x[i]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      if (tt >= len) break;
      const float d = dtr[tt];
      const float dx = d * xr[tt];
      float bv[N], cv[N];
      row<N>(bv, b_s[tt]);
      row<N>(cv, c_s[tt]);
      float acc = 0.0f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float abar = expf(d * a[n]);
        h[n] = abar * h[n] + dx * bv[n];
        acc = acc + h[n] * cv[n];
      }
      if (live) y[(row0 + t0 + tt) * inner + c] = acc;
    }
  }

  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[state_row + n] = h[n];
  }
}

int launch(const void* dt, const void* Bm, const void* Cm, const void* x, const void* A,
           const void* h0, void* y, void* h, int B, int S, int inner, int x_is_bf16,
           cudaStream_t stream) {
  dim3 grid((inner + kThreads - 1) / kThreads, B);
  const float* dtf = static_cast<const float*>(dt);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  const float* af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h);
  if (x_is_bf16)
    ssm_scan_fwd<kState, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        dtf, bf, cf, static_cast<const __nv_bfloat16*>(x), af, h0f, yf, hf, S, inner);
  else
    ssm_scan_fwd<kState, float><<<grid, kThreads, 0, stream>>>(
        dtf, bf, cf, static_cast<const float*>(x), af, h0f, yf, hf, S, inner);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the scan on `stream` and returns cudaGetLastError() as an int,
// 0 = launched. h0 may be null (zeros). The caller checks shapes, types and
// contiguity and owns every buffer; a state size other than kState returns
// cudaErrorInvalidValue.
extern "C" int ssm_scan_launch(const void* dt, const void* Bm, const void* Cm, const void* x,
                               const void* A, const void* h0, void* y, void* h, int B, int S,
                               int inner, int state, int x_is_bf16, void* stream) {
  if (state != kState) return (int)cudaErrorInvalidValue;
  return launch(dt, Bm, Cm, x, A, h0, y, h, B, S, inner, x_is_bf16,
                static_cast<cudaStream_t>(stream));
}
