"""Streaming data analytics over the fleet — the paper's second workload.

AutoSPADA's operational case study is not learning: it is *streaming
statistics over fuel-consumption signals* computed on-vehicle with only
compact summaries leaving the car (OODIDA's on-board/off-board analytics
split). This module is that workload on our platform:

1. an `AnalyticsDriver` window is one assignment to every online vehicle;
2. each vehicle's task container reads the last `window` observations of a
   signal from its signal plane view (`autospada.get_signal_window`),
   folds them through Welford's online mean/variance and a fixed-bin
   histogram, and publishes the resulting *sketch* — (count, mean, M2,
   bin counts), O(bins) bytes no matter how many samples were seen;
3. the server stacks all vehicles' sketches and merges them in one
   batched reduction on the driver's device
   (`repro_torch.kernels.ops.merge_moments` / `merge_histograms`),
   yielding exact fleet-level mean/variance/histogram as if every raw
   sample had been uploaded.

`merge_moments_reference` is the sequential pairwise (Chan et al.) merge,
kept as the oracle the batched path is tested against.

Two payload paths produce the *same sketch, bit for bit*:

* `ANALYTICS_PAYLOAD` (the oracle) folds `get_signal_window` in a
  sandboxed numpy loop — float32 Welford with the deferred-product
  update, >=-edge histogram binning, integer-rank quantile selection
  (`kernels.sketch.sketch_reference` is the same formula as a
  function);
* `SKETCH_PAYLOAD` (``AnalyticsConfig(sketch=True)``) calls
  `autospada.get_signal_sketch`, which on plane-attached vehicles is
  answered by ONE fused fleet-wide device fold over the signal ring
  per tick (`compute_sketches`, cached) — N sandboxed Python folds and
  the device→host ring sync collapse into a single kernel call.

Sketches now carry a mergeable KLL-style quantile summary (`qsk`), so
`WindowStats.quantile(q)` answers fleet-level percentile queries with a
deterministic rank-error bound — the paper's fuel-consumption analytics
("what's the 90th-percentile fuel rate across the fleet?") without any
raw sample leaving a vehicle.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import numpy as np

from repro_torch.core.user import AssignmentDoc, User
from repro_torch.fleet.rounds import DeadlinePump
from repro_torch.kernels.ops import (
    merge_histograms,
    merge_moments,
    merge_quantile_sketches,
)

#: Payload template executed inside every vehicle's task container: fold a
#: signal window through Welford + fixed bins + ranked quantile values,
#: publish the sketch only. This is the per-vehicle ORACLE the fused
#: device path (`SKETCH_PAYLOAD` → `compute_sketches`) must match bit for
#: bit, so every operation is pinned to float32 semantics the kernels can
#: reproduce exactly: the Welford mean/M2 updates run on np.float32
#: scalars, binning compares against precomputed f32 interior edges
#: (comparisons are exact where the old width-division was not), and the
#: quantile summary selects K order statistics at integer ranks of the
#: f32-sorted window — the same formula as
#: `kernels.sketch.sketch_reference`.
ANALYTICS_PAYLOAD = """
import autospada
import numpy as np

p = autospada.get_parameters()
sig = p["signal"]
xs = autospada.get_signal_window(sig, int(p["window"]))
x = np.asarray(xs, dtype=np.float32)
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
nb = int(p["bins"])
lo = float(p["lo"])
hi = float(p["hi"])
K = int(p["quantile_k"])
width = (hi - lo) / nb
edges = (lo + width * np.arange(1, nb)).astype(np.float32)
if count:
    idx = (x[:, None] >= edges[None, :]).sum(axis=1)
    hist = np.bincount(idx, minlength=nb)
    xs_sorted = np.sort(x)
    ranks = np.minimum((2 * np.arange(K) + 1) * count // (2 * K), count - 1)
    qsk = [float(v) for v in xs_sorted[ranks]]
else:
    hist = np.zeros((nb,), np.int64)
    qsk = []
autospada.publish({
    "window_id": int(p["window_id"]),
    "signal": sig,
    "count": int(count),
    "mean": float(mean),
    "m2": float(m2),
    "hist": [int(v) for v in hist],
    "qsk": qsk,
})
"""

#: The vectorized sibling: one `autospada.get_signal_sketch` call. On
#: plane-attached vehicles the answer comes from the fleet-wide cached
#: device fold (`FleetSignalPlane.sketch_row`) — the window never crosses
#: into the sandbox and the ring never crosses to the host — and on any
#: other source from the identical reference formula, so both payloads
#: publish the same values bit for bit.
SKETCH_PAYLOAD = """
import autospada

p = autospada.get_parameters()
sk = autospada.get_signal_sketch(
    p["signal"],
    int(p["window"]),
    bins=int(p["bins"]),
    lo=float(p["lo"]),
    hi=float(p["hi"]),
    quantile_k=int(p["quantile_k"]),
)
sk["window_id"] = int(p["window_id"])
sk["signal"] = p["signal"]
autospada.publish(sk)
"""


@dataclasses.dataclass(frozen=True)
class AnalyticsConfig:
    """One streaming-statistics campaign over a vehicle signal."""

    signal: str = "Vehicle.FuelRate"
    window: int = 64        # on-vehicle samples folded per sketch
    bins: int = 16          # fixed-bin histogram resolution
    lo: float = 0.0         # histogram support (clipped at the edges);
    hi: float = 12.0        # default spans the drive-cycle fuel-rate range
    quantile_k: int = 32    # ranked values per vehicle quantile summary
    sketch: bool = False    # True: fused device sketches (SKETCH_PAYLOAD)
    deadline_fraction: float = 0.9
    deadline_pumps: int | None = 64


@dataclasses.dataclass(frozen=True)
class WindowStats:
    """Fleet-level statistics of one analytics window."""

    window_id: int
    participants: int
    canceled: int
    pumps: int
    count: int          # pooled on-vehicle samples behind this window
    mean: float
    var: float          # population variance of the pooled samples
    hist: np.ndarray    # (bins,) pooled fixed-bin counts
    #: merged quantile summary: values sorted ascending with cumulative
    #: weights (sample mass at-or-below each value); None for legacy
    #: sketches without a `qsk` field
    q_values: np.ndarray | None = None
    q_weights: np.ndarray | None = None

    @property
    def std(self) -> float:
        return float(np.sqrt(max(self.var, 0.0)))

    def quantile(self, q: float) -> float:
        """Fleet-level q-quantile estimate from the merged per-vehicle
        summaries: one searchsorted over the cumulative weights.
        Deterministic rank error is bounded by ``count / (2 *
        quantile_k)`` plus one sample per participant — no raw sample
        ever left a vehicle to earn it. NaN when no samples merged."""
        if self.q_values is None or self.q_values.size == 0:
            return float("nan")
        total = float(self.q_weights[-1])
        if not total > 0:
            return float("nan")
        target = min(max(float(q), 0.0), 1.0) * total
        i = int(np.searchsorted(self.q_weights, target, side="left"))
        i = min(i, len(self.q_values) - 1)
        # zero-weight NaN entries (count-0 vehicles) sort to the tail;
        # a q=1.0 query must step back onto the last real value
        while i > 0 and not np.isfinite(self.q_values[i]):
            i -= 1
        return float(self.q_values[i])


def merge_moments_reference(
    sketches: Iterable[tuple[float, float, float]]
) -> tuple[float, float, float]:
    """Sequential pairwise Chan merge of (count, mean, M2) sketches — the
    per-client loop the batched `kernels.ops.merge_moments` replaces, kept
    as the correctness oracle."""
    c, mean, m2 = 0.0, 0.0, 0.0
    for ci, mi, m2i in sketches:
        ci = float(ci)
        if ci <= 0:
            continue
        tot = c + ci
        delta = mi - mean
        mean += delta * ci / tot
        m2 += m2i + delta * delta * c * ci / tot
        c = tot
    return c, mean, m2


@dataclasses.dataclass
class WindowInFlight:
    """A committed-but-not-closed analytics window: the assignment plus
    its armed `DeadlinePump` (the analytics twin of
    `repro_torch.fleet.rounds.RoundInFlight`)."""

    window_id: int
    n_clients: int
    assign: AssignmentDoc
    pump: DeadlinePump


class AnalyticsDriver:
    """Runs windowed streaming-statistics assignments through the platform
    (the analytics sibling of `FederatedDriver`)."""

    def __init__(
        self,
        user: User,
        cfg: AnalyticsConfig,
        *,
        engine: Any = None,
        status_oracle: bool = False,
        metrics: Any = None,
        device="cuda",
    ):
        self.user = user
        self.cfg = cfg
        #: where the server-side sketch merges run
        self.device = device
        #: unified event engine: window deadlines become heap entries; the
        #: quorum check reads AssignmentDoc.counts() (status events), with
        #: status_oracle=True restoring the dense statuses() scan
        self.engine = engine
        self.status_oracle = status_oracle
        #: FleetMetrics sink for live per-window progress gauges (fed from
        #: the same status-event counters the deadline check reads)
        self.metrics = metrics
        self.history: list[WindowStats] = []
        #: raw per-vehicle sketches of the most recent window (tests replay
        #: the batched merge against the sequential reference with these)
        self.last_sketches: list[dict[str, Any]] = []

    def start_window(
        self, window_id: int, pump: Callable[[], None]
    ) -> "WindowInFlight":
        """Commit one window's assignment and arm its deadline pump
        without pumping — the suspension point `repro.fleet.checkpoint`
        uses to snapshot a window mid-flight."""
        cfg = self.cfg
        clients = self.user.online_clients()
        source = SKETCH_PAYLOAD if cfg.sketch else ANALYTICS_PAYLOAD
        payload = self.user.payload(source, name=f"analytics-w{window_id}")
        # one immutable Parameters doc shared by every task — the sketch
        # spec is fleet-wide, unlike FedAvg's per-client data seeds
        params = self.user.parameter(
            {
                "signal": cfg.signal,
                "window": cfg.window,
                "bins": cfg.bins,
                "lo": cfg.lo,
                "hi": cfg.hi,
                "quantile_k": cfg.quantile_k,
                "window_id": window_id,
            }
        )
        tasks = [self.user.task(c, payload, params) for c in clients]
        assign = self.user.assignment(
            f"analytics window {window_id}", tasks
        ).commit()
        need = max(1, int(len(clients) * cfg.deadline_fraction))
        on_counts = None
        if self.metrics is not None:
            self.metrics.begin_round(window_id, len(clients))
            on_counts = self.metrics.update_progress
        dpump = DeadlinePump(
            assign,
            len(clients),
            need=need,
            budget=cfg.deadline_pumps,
            pump=pump,
            engine=self.engine,
            status_oracle=self.status_oracle,
            on_counts=on_counts,
        )
        return WindowInFlight(
            window_id=window_id,
            n_clients=len(clients),
            assign=assign,
            pump=dpump,
        )

    def finish_window(self, wif: "WindowInFlight") -> WindowStats:
        """Pump an in-flight window to its close and merge the sketches."""
        window_id = wif.window_id
        assign = wif.assign
        pumps = wif.pump.run()
        canceled = assign.cancel()
        if self.metrics is not None:
            # final gauge including the deadline cancels (cancel() above
            # published CANCELED statuses into the same counters)
            self.metrics.update_progress(assign.counts())
        sketches = []
        for values in assign.results().values():
            for v in values:
                if (
                    isinstance(v, dict)
                    and v.get("window_id") == window_id
                    and "m2" in v
                ):
                    sketches.append(v)
        self.last_sketches = sketches
        rec = self._merge(window_id, sketches, canceled=canceled, pumps=pumps)
        self.history.append(rec)
        return rec

    def run_window(
        self, window_id: int, pump: Callable[[], None]
    ) -> WindowStats:
        return self.finish_window(self.start_window(window_id, pump))

    def _merge(
        self,
        window_id: int,
        sketches: list[dict[str, Any]],
        *,
        canceled: int,
        pumps: int,
    ) -> WindowStats:
        """Server side: one batched merge over the client axis."""
        if not sketches:
            return WindowStats(
                window_id, 0, canceled, pumps, 0, float("nan"), float("nan"),
                np.zeros((self.cfg.bins,), np.int64),
            )
        counts = np.asarray([s["count"] for s in sketches], np.float32)
        means = np.asarray([s["mean"] for s in sketches], np.float32)
        m2s = np.asarray([s["m2"] for s in sketches], np.float32)
        hists = np.asarray([s["hist"] for s in sketches], np.int64)
        c, mean, m2 = merge_moments(counts, means, m2s, device=self.device)
        hist = merge_histograms(hists, device=self.device)
        q_values = q_weights = None
        K = self.cfg.quantile_k
        if any(len(s.get("qsk") or ()) == K for s in sketches):
            qvals = np.full((len(sketches), K), np.nan, np.float32)
            for i, s in enumerate(sketches):
                q = s.get("qsk") or ()
                if len(q) == K:
                    qvals[i] = q
            q_values, q_weights = merge_quantile_sketches(
                qvals, counts, device=self.device
            )
        if c <= 0:
            # every vehicle sketched zero samples (e.g. an unknown signal):
            # there is no statistic to report, same as the no-sketches case
            mean, var = float("nan"), float("nan")
        else:
            var = m2 / c
        return WindowStats(
            window_id=window_id,
            participants=len(sketches),
            canceled=canceled,
            pumps=pumps,
            count=int(c),
            mean=mean,
            var=var,
            hist=hist,
            q_values=q_values,
            q_weights=q_weights,
        )

    # ------------------------------------------------------------------ #
    def format_table(self) -> str:
        head = (
            f"{'window':>6} {'clients':>8} {'canceled':>9} {'samples':>8} "
            f"{'mean':>9} {'std':>8} {'p50':>8} {'p90':>8}  histogram"
        )
        lines = [head]
        for r in self.history:
            total = max(1, int(r.hist.sum()))
            bar = "".join(
                " .:-=+*#%@"[min(9, int(10 * v / total))] for v in r.hist
            )
            lines.append(
                f"{r.window_id:>6} {r.participants:>8} {r.canceled:>9} "
                f"{r.count:>8} {r.mean:>9.3f} {r.std:>8.3f} "
                f"{r.quantile(0.5):>8.3f} {r.quantile(0.9):>8.3f}  [{bar}]"
            )
        return "\n".join(lines)
