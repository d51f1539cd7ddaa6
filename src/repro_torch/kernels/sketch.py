"""Windowed-sketch fold over the fleet signal ring, in PyTorch, with the
fold itself a hand-written CUDA kernel.

The streaming-analytics workload folds each vehicle's last-`W`
observations into a compact sketch: Welford moments, a fixed-bin
histogram, and a mergeable KLL-style quantile summary. The whole fleet is
folded at once, where the ring lives: one `(3 + bins + K, capacity)` f32
result leaves the device, the ring never does.

Bit-for-bit parity with the per-vehicle numpy fold (`sketch_reference`,
which the sandboxed payload runs) is the contract, so the fold keeps the
JAX package's three choices:

* The Welford step carries the *pending* product ``d * (v - mean)`` and
  adds it one step late, so no multiply-add is contracted into an FMA.
* Histogram binning compares samples against precomputed f32 interior
  edges (``x >= edge_j`` counts); comparisons are exact, division is not.
* The quantile summary is pure selection: K order statistics at integer
  ranks of the f32-sorted window.

The work splits as in the JAX package: the window is gathered from the
ring (`window_block`) and sorted (`torch.sort`, NaN last) outside the
kernel, and `sketch_fold` folds `(x, xs, edges)`. On a CUDA tensor
`sketch_fold` launches `csrc/sketch_fold.cu`, which replaces the Pallas
`_sketch_kernel`; on a CPU tensor it runs `fold_plain`, the same fold in
plain PyTorch. Nothing falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build

#: launches of the sketch-fold CUDA kernel in this process: `sketch_fold`
#: adds one where it launches the kernel, and nowhere else
launches = 0


@dataclasses.dataclass(frozen=True)
class SketchSpec:
    """Shape of a windowed sketch. Frozen + hashable so planes can key
    their per-tick fleet-sketch cache on it."""

    window: int = 64
    bins: int = 16
    lo: float = 0.0
    hi: float = 12.0
    quantile_k: int = 32

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.bins < 1:
            raise ValueError(f"bins must be >= 1, got {self.bins}")
        if self.quantile_k < 1:
            raise ValueError(f"quantile_k must be >= 1, got {self.quantile_k}")

    @property
    def dim(self) -> int:
        """Rows of the fused device output: count, mean, m2, hist, quantiles."""
        return 3 + self.bins + self.quantile_k

    def edges(self) -> np.ndarray:
        """Interior bin edges, f32. Samples are binned by counting
        ``x >= edge_j`` — exact comparisons, matching the clip semantics
        of the original division-based binning (x < lo → bin 0,
        x >= hi → last bin, x == edge_j → bin j)."""
        width = (self.hi - self.lo) / self.bins
        return (self.lo + width * np.arange(1, self.bins)).astype(np.float32)


def sketch_reference(xs: Iterable[float], spec: SketchSpec) -> dict:
    """Per-vehicle numpy oracle: the exact fold `ANALYTICS_PAYLOAD` runs
    in the sandbox (f32 Welford, edge-comparison binning, integer-rank
    quantile selection). `compute_sketches` must match it bit-for-bit."""
    x = np.asarray(list(xs), dtype=np.float32)
    count = int(x.shape[0])
    c = np.float32(0.0)
    one = np.float32(1.0)
    mean = np.float32(0.0)
    m2 = np.float32(0.0)
    for v in x:
        c = c + one
        d = v - mean
        mean = mean + d / c
        m2 = m2 + d * (v - mean)
    edges = spec.edges()
    if count:
        idx = (x[:, None] >= edges[None, :]).sum(axis=1)
        hist = np.bincount(idx, minlength=spec.bins)
        xs_sorted = np.sort(x)
        K = spec.quantile_k
        ranks = np.minimum((2 * np.arange(K) + 1) * count // (2 * K), count - 1)
        qsk = [float(v) for v in xs_sorted[ranks]]
    else:
        hist = np.zeros((spec.bins,), np.int64)
        qsk = []
    return {
        "count": count,
        "mean": float(mean),
        "m2": float(m2),
        "hist": [int(v) for v in hist],
        "qsk": qsk,
    }


@dataclasses.dataclass(frozen=True)
class FleetSketches:
    """Host-side container for one fleet-wide sketch call."""

    spec: SketchSpec
    counts: np.ndarray  # (n,) int64
    means: np.ndarray   # (n,) f32
    m2s: np.ndarray     # (n,) f32
    hists: np.ndarray   # (n, bins) int64
    qvals: np.ndarray   # (n, quantile_k) f32; NaN rows where count == 0

    @property
    def n_clients(self) -> int:
        return int(self.counts.shape[0])

    def row(self, i: int) -> dict:
        """Payload-shaped dict for vehicle `i` — bit-identical to
        `sketch_reference` over that vehicle's window."""
        c = int(self.counts[i])
        return {
            "count": c,
            "mean": float(self.means[i]),
            "m2": float(self.m2s[i]),
            "hist": [int(v) for v in self.hists[i]],
            "qsk": [] if c == 0 else [float(v) for v in self.qvals[i]],
        }


def sketches_from_device(spec: SketchSpec, out: np.ndarray) -> FleetSketches:
    """Split the fused `(3 + bins + K, n)` device result into typed
    host arrays (counts/hists exact as integers: both are bounded by
    the window length, far inside f32's 2^24 integer range)."""
    nb = spec.bins
    return FleetSketches(
        spec=spec,
        counts=out[0].astype(np.int64),
        means=out[1].copy(),
        m2s=out[2].copy(),
        hists=out[3 : 3 + nb].T.astype(np.int64),
        qvals=out[3 + nb :].T.copy(),
    )


def empty_fleet_sketches(spec: SketchSpec, n: int) -> FleetSketches:
    """Zero-sample sketches for `n` vehicles (unknown signal / empty
    fleet) — `row()` matches `sketch_reference([], spec)`."""
    return FleetSketches(
        spec=spec,
        counts=np.zeros((n,), np.int64),
        means=np.zeros((n,), np.float32),
        m2s=np.zeros((n,), np.float32),
        hists=np.zeros((n, spec.bins), np.int64),
        qvals=np.full((n, spec.quantile_k), np.nan, np.float32),
    )


# --------------------------------------------------------------------- #
# the plain fold (twin of the JAX package's _fold_xla)                  #
# --------------------------------------------------------------------- #
def _edge_hist(x, valid, c, edges):
    """(bins, n) f32 counts from >=-edge comparisons. Exact: counts are
    bounded by the window length."""
    if edges.numel() == 0:
        return c[None]
    cum = torch.stack(
        [(valid & (x >= e)).sum(dim=0, dtype=torch.float32) for e in edges]
    )  # (bins-1, n): count of samples >= each edge
    return torch.cat([c[None] - cum[:1], cum[:-1] - cum[1:], cum[-1:]], dim=0)


def _quantile_ranks(kc, quantile_k):
    """(K, n) int64 ranks: midpoints of K equal-weight blocks, clipped."""
    j = torch.arange(quantile_k, dtype=torch.int32, device=kc.device)[:, None]
    r = ((2 * j + 1) * kc[None, :]) // (2 * quantile_k)
    hi = torch.clamp(kc - 1, min=0)[None, :]
    return torch.minimum(torch.clamp(r, min=0), hi).long()


def fold_plain(x, xs, edges, quantile_k: int) -> torch.Tensor:
    """(W, n) time-ordered window, the same window sorted along W, and
    the interior edges -> (3 + bins + K, n) f32 sketches, in plain
    PyTorch on any device. What the kernel computes, step for step."""
    n = x.shape[1]
    valid = torch.logical_not(torch.isnan(x))
    xz = torch.where(valid, x, 0.0)
    zeros = torch.zeros((n,), dtype=torch.float32, device=x.device)
    c = m = m2 = pend = zeros
    for v, ok in zip(xz, valid):  # _welford_update, one sample at a time
        m2n = m2 + pend
        cn = c + 1.0
        d = v - m
        mn = m + d / cn
        pn = d * (v - mn)
        c = torch.where(ok, cn, c)
        m = torch.where(ok, mn, m)
        m2 = torch.where(ok, m2n, m2)
        pend = torch.where(ok, pn, pend)
    m2 = m2 + pend

    hist = _edge_hist(x, valid, c, edges)

    kc = c.to(torch.int32)
    qv = torch.gather(xs, 0, _quantile_ranks(kc, quantile_k))
    qv = torch.where(kc[None, :] > 0, qv, torch.nan)
    return torch.cat([c[None], m[None], m2[None], hist, qv], dim=0)


# --------------------------------------------------------------------- #
# the kernel's wrapper                                                  #
# --------------------------------------------------------------------- #
def _launcher():
    fn = _build.load("sketch_fold").sketch_fold_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sketch_fold(x, xs, edges, quantile_k: int) -> torch.Tensor:
    """Fold a `(W, n)` window `x` (NaN = not observed), the same window
    sorted along W (`xs`, NaN last) and the interior bin edges (`(bins-1,)`)
    into `(3 + bins + K, n)` f32 sketches.

    CPU tensors run `fold_plain`. CUDA tensors launch the hand-written
    kernel (`csrc/sketch_fold.cu`) on the current stream, or raise."""
    global launches
    if x.device.type == "cpu":
        return fold_plain(x, xs, edges, quantile_k)
    if x.device.type != "cuda":
        raise ValueError(f"sketch_fold runs on cpu or cuda, not {x.device}")
    for name, t in (("x", x), ("xs", xs), ("edges", edges)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {x.device}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2 or xs.shape != x.shape or edges.dim() != 1:
        raise ValueError(f"need x, xs (W, n) and edges (bins-1,); got "
                         f"{tuple(x.shape)}, {tuple(xs.shape)}, {tuple(edges.shape)}")
    if quantile_k < 1:
        raise ValueError(f"quantile_k must be >= 1, got {quantile_k}")
    W, n = x.shape
    n_edges = edges.numel()
    out = torch.empty((4 + n_edges + quantile_k, n), dtype=torch.float32,
                      device=x.device)
    if n == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(x.device):
        err = launch(x.data_ptr(), xs.data_ptr(), edges.data_ptr(),
                     out.data_ptr(), W, n, n_edges, quantile_k,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sketch_fold kernel did not launch: CUDA error {err}")
    launches += 1
    return out


# --------------------------------------------------------------------- #
# entry points                                                          #
# --------------------------------------------------------------------- #
def window_block(ring, t: int, hist_len: int, col: int, window: int):
    """Gather signal `col`'s last-`window` ring slots, oldest first, as a
    `(W, capacity)` block from the signal-major ring `(hist_cap, n_signals,
    capacity)`. Positions older than the recorded history are NaN, exactly
    reproducing `FleetSignalPlane.window`'s ``k = min(k_requested,
    hist_len)`` truncation; offline ticks are already NaN in the ring."""
    hist_cap = ring.shape[0]
    W = min(int(window), hist_cap)
    i = torch.arange(W, device=ring.device)
    slots = torch.remainder(t - W + 1 + i, hist_cap)  # floor-mod: >= 0
    x = ring[slots, col, :]  # a fresh (W, capacity) copy
    x[: W - min(W, hist_len)] = torch.nan
    return x


def _fold(x, spec: SketchSpec) -> torch.Tensor:
    xs = torch.sort(x, dim=0).values.contiguous()  # NaN last, as np.sort
    edges = torch.from_numpy(spec.edges()).to(x.device)
    return sketch_fold(x, xs, edges, spec.quantile_k)


def fold_window(x, spec: SketchSpec, *, device="cuda") -> torch.Tensor:
    """Fold a (W, n) time-ordered window matrix (NaN = not observed)
    into `(spec.dim, n)` f32 sketches on `device`. Kernel-level entry
    used by the parity tests; the planes go through `sketch_ring`."""
    x = torch.as_tensor(x, dtype=torch.float32, device=resolve_device(device))
    if x.dim() != 2:
        raise ValueError(f"window must be (W, n), got {tuple(x.shape)}")
    return _fold(x.contiguous(), spec)


def sketch_ring(ring, t: int, hist_len: int, col: int, spec: SketchSpec):
    """Fold signal `col`'s last-`spec.window` ring slots into per-client
    sketches where the ring lives. Returns the fused `(spec.dim, capacity)`
    f32 tensor on the ring's device, the only thing that crosses to the
    host on the analytics path."""
    return _fold(window_block(ring, t, hist_len, col, spec.window), spec)
