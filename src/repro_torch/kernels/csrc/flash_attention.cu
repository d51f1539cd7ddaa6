// GQA flash attention (causal, optionally sliding-window) for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel (the Pallas kernel
// behind the JAX package's attn_impl hook; its oracle flash_attention_ref
// computes the same function). For q (B, S, H, D) and k, v (B, S, KV, D), all
// contiguous, f32 or bf16, it writes o (B, S, H, D) in q's type:
//
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h/G] * D^-1/2 + mask) v[b, j, h/G]
//
// with G = H / KV, mask = 0 where (i >= j if causal) and (i - j < window if a
// window is given), -1e30 elsewhere, and every key j >= S masked. All
// arithmetic is f32. The online softmax follows the Pallas kernel step for
// step: m starts at -1e30, m' = max(m, rowmax(s)), p = expf(s - m'),
// l' = l * expf(m - m') + sum(p), acc' = acc * expf(m - m') + p.v, and the
// output is acc / max(l, 1e-30). Built with --fmad=false: the dot products
// call fmaf() explicitly, every other operation is singly rounded, and the
// exponentials are expf (never __expf).
//
// Design: one block of 256 threads per (query tile of 64 rows, query head,
// batch row); query head h reads KV head h / G, and the G blocks of a group
// meet the same K/V tiles in L2. The query tile is staged once in shared
// memory as f32 (times D^-1/2); a loop walks the live key tiles of 64 only,
// from the first key the window lets the tile's first row see to the last
// key its last row may see under the causal mask, so a fully masked tile is
// never touched (the Pallas kernel's pl.when(live)), and a windowed layer
// costs O(S * W). Each tile is staged in shared memory as f32 (K, then V in
// the same buffer; rows past S as zeros): the 16 x 16 threads each compute a
// 4 x 4 block of the 64 x 64 score tile, the row max and sum are shuffles
// across the 16 threads of a row, the probabilities go through shared memory,
// and each thread carries (m, l) and a 4 x D/16 block of the output
// accumulator in registers. Rows of shared memory are padded to D + 1 floats,
// so the reads of the score loop are free of bank conflicts for every D.
//
// Bound: at the serve path's prefill (B 4, S 8..48, 32 heads, 8 KV heads,
// D 128, bf16, causal) a call does under 1e8 FLOPs and moves about 4 MB: the
// bytes set the bound (about 1 us at 3.35 TB/s), and the time is the launch
// and one pass of latency. At long prompts the FLOPs set it: (4, 4096, 32, 8,
// 128) causal needs 4 * B * H * D * (unmasked pairs) = 5.5e11 FLOPs, 0.56 ms at
// the tensor cores' 989 TFLOP/s. This kernel uses the f32 CUDA cores (67
// TFLOP/s) fed from shared memory, so it cannot come within 15x of that
// bound: mma.sync / wgmma tiles over bf16 operands and TMA staging are the
// later work that closes the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // query rows and key columns of a tile
constexpr int kRows = 4;   // query rows a thread owns (16 threads a row group)
constexpr int kCols = 4;   // key columns a thread owns in a score tile
constexpr int kLdp = kTile + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Stage rows [row0, row0 + 64) of one head into dst (row stride ld) as f32
// times `mul`; rows at or past S are zeros.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* __restrict__ src,
                                      int64_t row_stride, int row0, int S, int D, float mul) {
  const int valid = min(kTile, S - row0);
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    float x = 0.0f;
    if (r < valid) x = to_f32(src[(int64_t)(row0 + r) * row_stride + d]) * mul;
    dst[r * ld + d] = x;
  }
}

template <typename T, int DJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int S, int H, int KV, int D, int causal, int window,
          float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;              // kTile x ld, q * D^-1/2
  float* kv_s = q_s + kTile * ld;  // kTile x ld, K then V of the current tile
  float* p_s = kv_s + kTile * ld;  // kTile x kLdp, probabilities

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const int64_t q_rs = (int64_t)H * D, kv_rs = (int64_t)KV * D;
  const T* qb = q + ((int64_t)b * S * H + h) * D;
  const T* kb = k + ((int64_t)b * S * KV + kvh) * D;
  const T* vb = v + ((int64_t)b * S * KV + kvh) * D;

  stage(q_s, ld, qb, q_rs, q0, S, D, scale);

  // the live key tiles: from the first key row q0 may see (window) to the
  // last key the tile's last row may see (causal)
  const int k_hi = causal ? min(q0 + kTile, S) - 1 : S - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[kRows], l[kRows], acc[kRows][DJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  for (int t = k_lo / kTile; t <= k_hi / kTile; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // q_s staged; the previous V tile fully read
    stage(kv_s, ld, kb, kv_rs, k0, S, D, 1.0f);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRows], c[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = q_s[(ty * kRows + i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) c[j] = kv_s[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool live = kp < S && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
        if (!live) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      for (int off = 8; off > 0; off >>= 1)  // the 16 threads of this row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < kCols; ++j) p_s[(ty * kRows + i) * kLdp + tx + 16 * j] = s[i][j];
    }

    __syncthreads();  // K fully read, P written
    stage(kv_s, ld, vb, kv_rs, k0, S, D, 1.0f);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = p_s[(ty * kRows + i) * kLdp + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        const float x = d < D ? kv_s[c * ld + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty * kRows + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (((int64_t)b * S + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(orow + d, acc[i][j] / denom);
    }
  }
}

template <typename T, int DJ>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
           int KV, int D, int causal, int window, float scale, cudaStream_t stream) {
  const int smem = (2 * kTile * (D + 1) + kTile * kLdp) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_fwd<T, DJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KV, D, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
             int KV, int D, int causal, int window, float scale, cudaStream_t stream) {
  const int chunks = (D + 15) / 16;  // output columns a thread owns
  if (chunks <= 2) return launch<T, 2>(q, k, v, o, B, S, H, KV, D, causal, window, scale, stream);
  if (chunks <= 4) return launch<T, 4>(q, k, v, o, B, S, H, KV, D, causal, window, scale, stream);
  if (chunks <= 8) return launch<T, 8>(q, k, v, o, B, S, H, KV, D, causal, window, scale, stream);
  return launch<T, 16>(q, k, v, o, B, S, H, KV, D, causal, window, scale, stream);
}

}  // namespace

// Launches the attention on `stream` and returns cudaGetLastError() (or the
// error of raising the shared-memory limit) as an int, 0 = launched. The
// caller checks shapes (D <= 256, H % KV == 0), contiguity and types, and
// owns every buffer. window = 0 means no window.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int H, int KV, int D, int causal,
                                      int window, float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, S, H, KV, D, causal, window, scale, st);
  return launch_d<float>(q, k, v, o, B, S, H, KV, D, causal, window, scale, st);
}
