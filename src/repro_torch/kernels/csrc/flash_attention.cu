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
// window is given), -1e30 elsewhere, and every key j >= S masked. The online
// softmax follows the Pallas kernel step for step, in f32: m starts at -1e30,
// m' = max(m, rowmax(s)), p = expf(s - m'), l' = l * expf(m - m') + sum(p),
// acc' = acc * expf(m - m') + p.v, and the output is acc / max(l, 1e-30),
// rounded to q's type once. Built with --fmad=false, so every f32 operation
// outside the products is singly rounded, and the exponentials are expf
// (never __expf). Two kernels, chosen by dtype:
//
// bf16: flash_fwd_tc, on the tensor cores. A block is one warpgroup of four
// consumer warps that owns 64 query rows, plus one producer warp. The rows
// are 64 / P positions of P query heads of one KV group (P, the largest power
// of two dividing G up to 64: the Pallas kernel's packing of a group's heads),
// so one K/V tile feeds P heads. The producer warp brings Q once, then each
// live key tile of 64 rows of K and V by TMA (128-byte swizzle, zero fill
// past S and past D) into a ring of two stages guarded by mbarriers. The
// consumers compute S = Q.K^T with wgmma m64n64k16 from shared memory
// (bf16 in, f32 accumulate), scale it by D^-1/2 in f32, mask it only on a
// tile that the diagonal, the window's edge or S cuts, and run the online
// softmax in the accumulator's registers (row max and sum are shuffles
// across the quad of threads that share a row; the rescale of the output is
// skipped while a thread's row maxima stay put). P.V runs as wgmma with P as
// the register operand and V from shared memory (MN-major, transposed by
// the instruction): the m64n8 C fragment of a score tile is the A fragment
// of the product, so P never goes through shared memory.
//
// P.V is split: P = P_hi + P_mid + P_lo, three bf16 slices (the top,
// middle and bottom 8 bits of each f32 significand: exactly p), three MMAs
// into one f32 accumulator, V exact in bf16. One term fails the check that
// holds this kernel, one bf16 step of each output (|o - plain| <= 2^-7
// |plain| + 2e-5): P cut once to bf16 errs by up to 2^-8 of each weight,
// ~1e-3 absolute on outputs that cancel to near zero, where the bound is
// 2e-5. Two terms (16 bits of p) pass it, but round several times as many
// outputs differently from the plain version as the plain version does from
// the exact result, which moved qwen3-4b's logits (kernel against plain
// cores) outside the range the earlier kernel held; the third term brings
// that rate to the plain version's at short prompts. The CPU test that
// emulates this arithmetic (tests/test_torch_flash_attention.py,
// test_split_p_keeps_the_emulated_kernel_within_one_bf16_step) measures one,
// two and three terms against the bound. The split costs 2x the function's
// MMA work.
//
// Bound: at long prompts the operations: 4 * B * H * D * (unmasked pairs)
// at 989 TFLOP/s, 0.139 ms at (4, 2048, 32, 8, 128) causal. What holds it
// back is less the tensor cores than the CUDA-core work a score costs: the
// scale, the max, an expf (nine instructions), the sum, the split's masks,
// subtractions and packing, and the rescale of the accumulator when a row's
// max moves, issued by two consumer warps a scheduler (two blocks an SM at
// D <= 128, at most 168 registers a thread).
// Variants timed on the card showed it: dropping both products and the loads
// took off about a fifth, the loads alone nothing; issuing the next tile's
// Q.K^T and this tile's P.V under the softmax (FlashAttention-3's
// intra-warpgroup pipelining) was slower. More warps a scheduler (a second
// consumer warpgroup sharing each K/V tile, registers rebalanced by
// setmaxnreg), fewer instructions a score and persistent blocks are later
// work. At the serve prefill (S <= 48) the bytes set the bound (~1 us), and
// the time is the launch and one pass of latency.
//
// f32: flash_fwd_f32, on the CUDA cores (the check is an absolute 2e-5 there,
// which bf16 operands cannot meet). One block of 256 threads per (query tile
// of 64 rows, query head, batch row); the query tile staged once in shared
// memory as f32 (times D^-1/2); a loop over the live 64-key tiles, each
// staged as f32 (K, then V in the same buffer; rows past S as zeros); the
// 16 x 16 threads each compute a 4 x 4 block of the score tile with fmaf;
// the probabilities go through shared memory; each thread carries (m, l) and
// a 4 x D/16 block of the output in registers.
//
// Both walk only the live key tiles: from the first key the window lets the
// block's first row see to the last key its last row may see under the
// causal mask, so a fully masked tile is never touched (the Pallas kernel's
// pl.when(live)), and a windowed layer costs O(S * W); blocks with the
// longest causal rows go first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTile = 64;  // query rows and key columns of a tile
constexpr int kRows = 4;   // query rows a thread owns (16 threads a row group)
constexpr int kCols = 4;   // key columns a thread owns in a score tile
constexpr int kLdp = kTile + 1;

// Stage rows [row0, row0 + 64) of one head into dst (row stride ld) times
// `mul`; rows at or past S are zeros.
__device__ __forceinline__ void stage(float* dst, int ld, const float* __restrict__ src,
                                      int64_t row_stride, int row0, int S, int D, float mul) {
  const int valid = min(kTile, S - row0);
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    float x = 0.0f;
    if (r < valid) x = src[(int64_t)(row0 + r) * row_stride + d] * mul;
    dst[r * ld + d] = x;
  }
}

template <int DJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S, int H, int KV, int D,
              int causal, int window, float scale) {
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
  const float* qb = q + ((int64_t)b * S * H + h) * D;
  const float* kb = k + ((int64_t)b * S * KV + kvh) * D;
  const float* vb = v + ((int64_t)b * S * KV + kvh) * D;

  stage(q_s, ld, qb, q_rs, q0, S, D, scale);

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
    float* orow = o + (((int64_t)b * S + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) orow[d] = acc[i][j] / denom;
    }
  }
}

template <int DJ>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
               int KV, int D, int causal, int window, float scale, cudaStream_t stream) {
  const int smem = (2 * kTile * (D + 1) + kTile * kLdp) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_fwd_f32<DJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, H, KV, D, causal, window, scale);
  return (int)cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                 int KV, int D, int causal, int window, float scale, cudaStream_t stream) {
  const int chunks = (D + 15) / 16;  // output columns a thread owns
  if (chunks <= 2) return launch_f32<2>(q, k, v, o, B, S, H, KV, D, causal, window, scale, stream);
  if (chunks <= 4) return launch_f32<4>(q, k, v, o, B, S, H, KV, D, causal, window, scale, stream);
  if (chunks <= 8) return launch_f32<8>(q, k, v, o, B, S, H, KV, D, causal, window, scale, stream);
  return launch_f32<16>(q, k, v, o, B, S, H, KV, D, causal, window, scale, stream);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 160;   // one consumer warpgroup + one producer warp
constexpr int kBlockRows = 64;    // query rows of a block (the warpgroup's M)
constexpr int kBlockKeys = 64;    // keys of a tile
constexpr int kStages = 2;        // K/V ring
constexpr uint32_t kChunkBytes = 64 * 128;  // 64 rows of one 64-column (128-byte) chunk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: 8-row groups
// 1024 bytes apart (SBO); `lbo` is the stride between 64-column chunks, read
// only for an MN-major operand wider than one chunk.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void gmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous instructions.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define GMMA_D32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define GMMA_OUT32(d)                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),        \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),     \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (+)= A.B over k16 with A and B from shared memory, both K-major:
// the score tile's Q.K^T step.
__device__ __forceinline__ void gmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : GMMA_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A.B over k16 with A from registers (a bf16 x 2 fragment) and B from
// shared memory, MN-major: a P.V step.
__device__ __forceinline__ void gmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : GMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// (x0, x1) >= 0 as the sum of three bf16 x 2 words hi + mid + lo: the top,
// middle and bottom 8 bits of each f32 significand (hi and mid by masking, a
// remainder by an exact subtraction), so the three carry every bit of p.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  const float h0 = __uint_as_float(u0 & 0xffff0000u), h1 = __uint_as_float(u1 & 0xffff0000u);
  const float r0 = x0 - h0, r1 = x1 - h1;
  const uint32_t v0 = __float_as_uint(r0), v1 = __float_as_uint(r1);
  const float m0 = __uint_as_float(v0 & 0xffff0000u), m1 = __uint_as_float(v1 & 0xffff0000u);
  const uint32_t w0 = __float_as_uint(r0 - m0), w1 = __float_as_uint(r1 - m1);
  hi = __byte_perm(u0, u1, 0x7632);
  mid = __byte_perm(v0, v1, 0x7632);
  lo = __byte_perm(w0, w1, 0x7632);
}

// The block: 64 query rows = 64 / P positions x P heads (row r is position
// p0 + r / P of head h0 + r % P; P = 1 << pshift), all reading KV head h0 / G.
// Shared memory: Q, then kStages x (K, V); each a DP / 64 chunks of 64 rows x
// 128 bytes, as TMA writes them with the 128-byte swizzle; then the barriers.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, DP <= 128 ? 2 : 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S, int H,
             int G, int D, int causal, int window, float scale, int pshift) {
  constexpr int kChunks = DP / 64;
  constexpr uint32_t kOperand = kChunks * kChunkBytes;  // one 64-row tile of Q, K or V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's 1024-byte atoms
  const uint32_t q_s = base;
  const uint32_t bars = base + kOperand * (1 + 2 * kStages);
  const uint32_t q_full = bars;
  auto k_s = [&](int st) { return base + kOperand * (1 + 2 * st); };
  auto v_s = [&](int st) { return base + kOperand * (2 + 2 * st); };
  auto full = [&](int st) { return bars + 8u * (1 + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + kStages + st); };

  const int npos = kBlockRows >> pshift;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest causal rows first
  const int h0 = blockIdx.x << pshift, b = blockIdx.y;
  const int kvh = h0 / G;
  const int p0 = qt * npos;
  const int k_hi = causal ? min(p0 + npos, S) - 1 : S - 1;
  const int k_lo = window > 0 ? max(0, p0 - window + 1) : 0;
  const int t_lo = k_lo / kBlockKeys, n_tiles = k_hi / kBlockKeys - t_lo + 1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(q_full, kOperand);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        tma_load(q_s + c * kChunkBytes, &tq, 64 * c, h0, p0, b, q_full);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, round = i / kStages;
        if (round > 0) mbar_wait(empty(st), (round - 1) & 1);
        mbar_expect_tx(full(st), 2 * kOperand);
        const int k0 = (t_lo + i) * kBlockKeys;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          tma_load(k_s(st) + c * kChunkBytes, &tk, 64 * c, kvh, k0, b, full(st));
          tma_load(v_s(st) + c * kChunkBytes, &tv, 64 * c, kvh, k0, b, full(st));
        }
      }
    }
    return;
  }

  // The consumers. Thread (warp, lane) holds rows ra = 16 warp + lane / 4 and
  // rb = ra + 8 of every m64n64 accumulator, at columns 8 j + 2 (lane % 4) + {0, 1}
  // of its n8 block j: registers 4 j + {0, 1} (row ra) and 4 j + {2, 3} (row rb).
  const int ra = 16 * warp + (lane >> 2), rb = ra + 8;
  const int pa = p0 + (ra >> pshift), pb = p0 + (rb >> pshift);
  const int cq = 2 * (lane & 3);

  float acc[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;

  mbar_wait(q_full, 0);
  __syncwarp();  // wgmma is .aligned: the warp converges after the spin
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages, round = i / kStages;
    const int k0 = (t_lo + i) * kBlockKeys;
    mbar_wait(full(st), round & 1);
    __syncwarp();

    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.0f;
    fence_regs(s);
    gmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kChunkBytes + (kk & 3) * 32;
      gmma_ss(s, gmma_desc(q_s + off, 16), gmma_desc(k_s(st) + off, 16), kk > 0);
    }
    gmma_commit();
    gmma_wait_all();
    fence_regs(s);

    // scale, then mask only where the diagonal, the window's edge or S cuts
    // the tile
    const bool cut = k0 + kBlockKeys > S || (causal && k0 + kBlockKeys - 1 > p0) ||
                     (window > 0 && p0 + npos - 1 - k0 >= window);
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale;
        if (cut) {
          const int qp = e < 2 ? pa : pb, kp = k0 + 8 * j + cq + (e & 1);
          const bool live = kp < S && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
          if (!live) x = kNegInf;
        }
        s[4 * j + e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    float rs_a = 0.0f, rs_b = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[4 * j + e] - (e < 2 ? mn_a : mn_b));
        s[4 * j + e] = p;
        if (e < 2) rs_a += p;
        else rs_b += p;
      }
    }
    rs_a += __shfl_xor_sync(0xffffffffu, rs_a, 1);
    rs_a += __shfl_xor_sync(0xffffffffu, rs_a, 2);
    rs_b += __shfl_xor_sync(0xffffffffu, rs_b, 1);
    rs_b += __shfl_xor_sync(0xffffffffu, rs_b, 2);
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    l_a = l_a * al_a + rs_a;
    l_b = l_b * al_b + rs_b;
    m_a = mn_a;
    m_b = mn_b;
    if (al_a != 1.0f || al_b != 1.0f) {  // a row's max moved (x 1.0 is exact: skip it)
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        fence_regs(acc[c]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[c][4 * j + 0] *= al_a;
          acc[c][4 * j + 1] *= al_a;
          acc[c][4 * j + 2] *= al_b;
          acc[c][4 * j + 3] *= al_b;
        }
      }
    }

    // P's A fragments for the four k16 steps: n8 blocks 2 kk and 2 kk + 1 of
    // the score accumulator, split into three bf16 terms
    uint32_t p_hi[4][4], p_mid[4][4], p_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], p_hi[kk][r], p_mid[kk][r],
                   p_lo[kk][r]);
    }

#pragma unroll
    for (int c = 0; c < kChunks; ++c) fence_regs(acc[c]);
    gmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint64_t vd = gmma_desc(v_s(st) + c * kChunkBytes + kk * 16 * 128, kChunkBytes);
        gmma_rs(acc[c], p_hi[kk], vd);
        gmma_rs(acc[c], p_mid[kk], vd);
        gmma_rs(acc[c], p_lo[kk], vd);
      }
    }
    gmma_commit();
    gmma_wait_all();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) fence_regs(acc[c]);
    mbar_arrive(empty(st));  // this thread's reads of the stage are done
  }

  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  const int64_t row_stride = (int64_t)H * D;
  const int pmask = (1 << pshift) - 1;
  __nv_bfloat16* oa = o + ((int64_t)b * S + pa) * row_stride + (int64_t)(h0 + (ra & pmask)) * D;
  __nv_bfloat16* ob = o + ((int64_t)b * S + pb) * row_stride + (int64_t)(h0 + (rb & pmask)) * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 64 * c + 8 * j + cq;  // D is even: d < D means d + 1 < D
      if (d >= D) continue;
      if (pa < S)
        *reinterpret_cast<__nv_bfloat162*>(oa + d) =
            __floats2bfloat162_rn(acc[c][4 * j] / den_a, acc[c][4 * j + 1] / den_a);
      if (pb < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + d) =
            __floats2bfloat162_rn(acc[c][4 * j + 2] / den_b, acc[c][4 * j + 3] / den_b);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, S, heads, D) bf16 tensor as TMA sees it: boxes of 64 columns x
// box_heads heads x box_rows positions, 128-byte swizzle, zeros past every
// edge.
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D,
                int box_heads, int box_rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_heads, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
              int D, int causal, int window, float scale, cudaStream_t stream) {
  const int G = H / KV;
  int pshift = 0;  // pack the largest power of two of a group's heads, up to 64
  while (pshift < 6 && G % (2 << pshift) == 0) ++pshift;
  const int npos = kBlockRows >> pshift;
  const int n_qt = (S + npos - 1) / npos;
  if (n_qt > 65535) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, S, H, D, 1 << pshift, npos) ||
      !tensor_map(&tk, k, B, S, KV, D, 1, kBlockKeys) ||
      !tensor_map(&tv, v, B, S, KV, D, 1, kBlockKeys))
    return (int)cudaErrorInvalidValue;
  const int smem =
      (int)((DP / 64) * kChunkBytes * (1 + 2 * kStages)) + 1024 + 8 * (1 + 2 * kStages);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H >> pshift, B, n_qt);
  flash_fwd_tc<DP><<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, H, G, D, causal, window, scale, pshift);
  return (int)cudaGetLastError();
}

int dispatch_tc(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                int KV, int D, int causal, int window, float scale, cudaStream_t stream) {
  if (D % 8 != 0 || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 != 0)
    return (int)cudaErrorInvalidValue;  // TMA's strides and addresses are 16-byte multiples
  if (D <= 64) return launch_tc<64>(q, k, v, o, B, S, H, KV, D, causal, window, scale, stream);
  if (D <= 128) return launch_tc<128>(q, k, v, o, B, S, H, KV, D, causal, window, scale, stream);
  if (D <= 192) return launch_tc<192>(q, k, v, o, B, S, H, KV, D, causal, window, scale, stream);
  return launch_tc<256>(q, k, v, o, B, S, H, KV, D, causal, window, scale, stream);
}

}  // namespace

// Launches the attention on `stream` and returns cudaGetLastError() (or the
// error of raising the shared-memory limit or of describing the tensors to
// TMA) as an int, 0 = launched. The caller checks shapes (D <= 256,
// H % KV == 0), contiguity and types, and owns every buffer; for bf16 it
// also hands D % 8 == 0 and 16-byte aligned q, k, v and o (cudaErrorInvalidValue
// otherwise). window = 0 means no window.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int H, int KV, int D, int causal,
                                      int window, float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_tc(q, k, v, o, B, S, H, KV, D, causal, window, scale, st);
  return dispatch_f32(q, k, v, o, B, S, H, KV, D, causal, window, scale, st);
}
