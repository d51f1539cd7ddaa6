// Windowed sketch fold for Hopper (sm_90a).
//
// Replaces repro/kernels/sketch.py::_sketch_kernel (the Pallas kernel the
// JAX package runs on the TPU through _fold_pallas). For each client
// column i of a (W, n) time-ordered window x (NaN = not observed) and the
// same window sorted along W (xs, NaN last), it writes one column of the
// (3 + bins + K, n) f32 output:
//
//   row 0          count of valid samples
//   row 1, 2       masked Welford mean and M2, with the pending product
//                  added one step late, exactly as _welford_update orders it
//   rows 3..       bins histogram counts from x >= edge_j comparisons
//   last K rows    K order statistics at integer ranks of the sorted window
//                  (NaN when the column has no valid sample)
//
// Bit-for-bit parity with the numpy oracle (sketch_reference) needs IEEE
// single rounding on every operation: the build passes --fmad=false and
// -prec-div=true, and the arithmetic below uses the explicit _rn
// intrinsics as well, so no multiply-add is contracted into an FMA.
//
// Design: one thread per client column, 128 threads a block. Thread i
// reads x[s, i] and xs[s, i] for s = 0..W-1; neighbouring threads read
// neighbouring addresses, so every load and every store of the output row
// is coalesced across the warp. The histogram re-reads x once per interior
// edge; those re-reads hit L1/L2, not device memory.
//
// Bound: bandwidth. The fold reads x and xs once (2 * W * n * 4 bytes) and
// writes (3 + bins + K) * n * 4 bytes; it does O(W * bins) comparisons per
// column, far below the card's compute rate. At W = 64, n = 100 000,
// bins = 16, K = 32 that is 71.6 MB, about 21 us at 3.35 TB/s. A later
// design that gathers and sorts the window inside the kernel, reading the
// ring once, would move about 46 MB (about 14 us).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void sketch_fold_kernel(const float* __restrict__ x,
                                   const float* __restrict__ xs,
                                   const float* __restrict__ edges,
                                   float* __restrict__ out,
                                   int W, int n, int n_edges, int K) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t N = n;

  // masked Welford fold (_welford_update): the state only advances on
  // valid samples, so invalid ones need no arithmetic at all
  float c = 0.0f, m = 0.0f, m2 = 0.0f, pend = 0.0f;
  for (int s = 0; s < W; ++s) {
    const float v = x[s * N + i];
    if (isnan(v)) continue;
    const float m2n = __fadd_rn(m2, pend);
    const float cn = __fadd_rn(c, 1.0f);
    const float d = __fsub_rn(v, m);
    const float mn = __fadd_rn(m, __fdiv_rn(d, cn));
    const float pn = __fmul_rn(d, __fsub_rn(v, mn));
    c = cn;
    m = mn;
    m2 = m2n;
    pend = pn;
  }
  m2 = __fadd_rn(m2, pend);
  out[0 * N + i] = c;
  out[1 * N + i] = m;
  out[2 * N + i] = m2;

  // histogram (_edge_hist): cum_j = #valid samples >= edge_j, then
  // hist = [c - cum_0, cum_0 - cum_1, ..., cum_last]; [c] with no edges
  float prev = c;
  for (int j = 0; j < n_edges; ++j) {
    const float e = edges[j];
    float cum = 0.0f;
    for (int s = 0; s < W; ++s) {
      const float v = x[s * N + i];
      if (!isnan(v) && v >= e) cum = __fadd_rn(cum, 1.0f);
    }
    out[(3 + j) * N + i] = __fsub_rn(prev, cum);
    prev = cum;
  }
  const int bins = n_edges + 1;
  out[(3 + n_edges) * N + i] = prev;

  // quantiles (_quantile_ranks): midpoints of K equal-weight blocks of
  // the kc valid samples, clipped to [0, max(kc - 1, 0)], picked from the
  // sorted window
  const int kc = (int)c;
  const int hi = kc > 0 ? kc - 1 : 0;
  const float qnan = __int_as_float(0x7fc00000);
  for (int j = 0; j < K; ++j) {
    int r = ((2 * j + 1) * kc) / (2 * K);
    r = r < 0 ? 0 : (r > hi ? hi : r);
    out[(3 + bins + j) * N + i] = kc > 0 ? xs[r * N + i] : qnan;
  }
}

}  // namespace

// Launches the fold on `stream` and returns cudaGetLastError() as an int
// (0 = launched). The caller owns every buffer: x, xs (W, n) and out
// (3 + n_edges + 1 + K, n) are contiguous f32 on the current device,
// edges holds n_edges f32 values.
extern "C" int sketch_fold_launch(const float* x, const float* xs,
                                  const float* edges, float* out, int W,
                                  int n, int n_edges, int K, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  sketch_fold_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x, xs, edges, out, W, n, n_edges, K);
  return (int)cudaGetLastError();
}
