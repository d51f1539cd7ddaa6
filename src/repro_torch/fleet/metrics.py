"""Fleet-scale metrics: what the simulator measures per round and how it
is summarized.

The ROADMAP's "millions of users" claim needs a load-bearing signal:
per-round participation, cancellations, broker traffic (published /
delivered / dropped deltas from the `Broker` counters), simulation ticks
to quorum, and wall time — aggregated into clients/sec and participation
percentiles. `benchmarks/fleet_scale.py` prints these as CSV rows and
`repro_torch.launch.fleet` as a table.

Wall-clock fields are measurement-only: they never feed back into the
simulation, so determinism (same seed -> same aggregate) is unaffected.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.columns import FleetColumns


@dataclass(frozen=True, slots=True)
class RoundMetrics:
    round: int
    online_at_start: int
    participants: int
    canceled: int
    ticks: int  # simulation ticks the round consumed
    published: int  # broker messages published during the round
    delivered: int
    dropped: int
    wall_s: float
    mean_client_loss: float | None = None
    dist_to_optimum: float | None = None

    @property
    def participation(self) -> float:
        return self.participants / max(1, self.online_at_start)


@dataclass(frozen=True, slots=True)
class RoundProgress:
    """Live gauge of the round currently in flight, fed from the same
    O(1) `AssignmentDoc.counts()` status-event counters the deadline
    check reads — progress costs zero extra store scans."""

    round: int
    total: int          # tasks committed this round/window
    finished: int = 0
    error: int = 0
    canceled: int = 0

    @property
    def terminal(self) -> int:
        return self.finished + self.error + self.canceled

    @property
    def active(self) -> int:
        return max(0, self.total - self.terminal)

    @property
    def completion(self) -> float:
        return self.finished / max(1, self.total)

    def to_dict(self) -> dict[str, int | float]:
        """JSON-shaped snapshot — the serve gateway's ``progress`` reads
        return exactly this, so dashboards and tests share one schema."""
        return {
            "round": self.round,
            "total": self.total,
            "finished": self.finished,
            "error": self.error,
            "canceled": self.canceled,
            "active": self.active,
            "completion": self.completion,
        }


@dataclass
class FleetMetrics:
    """Accumulates per-round records and derives fleet-level aggregates."""

    rounds: list[RoundMetrics] = field(default_factory=list)
    #: gauge of the in-flight round (None between rounds' commit/close);
    #: drivers call `begin_round` at commit and `update_progress` on
    #: every counts snapshot, so dashboards can poll completed / failed /
    #: canceled live instead of waiting for the round record
    progress: RoundProgress | None = None
    #: shared per-client arena (repro_torch.core.columns): when attached,
    #: `fleet_gauges` reads fleet-wide state as vectorized reductions
    #: over the same columns the store and services write — a view, not
    #: a copy
    columns: "FleetColumns | None" = None

    def record(self, rec: RoundMetrics) -> None:
        self.rounds.append(rec)

    # -- columnar fleet gauges ------------------------------------------ #
    def fleet_gauges(self) -> dict[str, float]:
        """Instantaneous fleet-wide gauges, each ONE numpy reduction over
        the shared columns: no per-client Python loop, no copies. Empty
        dict when no arena is attached."""
        cols = self.columns
        if cols is None or cols.n_rows == 0:
            return {}
        n = cols.n_rows
        return {
            "clients": n,
            "online": int(np.count_nonzero(cols.online[:n])),
            "registered": int(np.count_nonzero(cols.registered[:n])),
            "runnable": int(np.count_nonzero(cols.runnable[:n])),
            "stragglers": int(np.count_nonzero(cols.straggler[:n])),
            "unacked_results": int(cols.unacked[:n].sum()),
            "mean_clock": float(cols.clock[:n].mean()),
            "max_clock": int(cols.clock[:n].max()),
        }

    # -- live per-round progress ---------------------------------------- #
    def begin_round(self, round_id: int, total: int) -> None:
        self.progress = RoundProgress(round=round_id, total=total)

    def update_progress(self, counts) -> None:
        """Fold one `TaskCounts` snapshot into the gauge (no-op until
        `begin_round` opens one)."""
        if self.progress is None:
            return
        self.progress = RoundProgress(
            round=self.progress.round,
            total=self.progress.total,
            finished=counts.finished,
            error=counts.error,
            canceled=counts.canceled,
        )

    # ------------------------------------------------------------------ #
    def summary(self) -> dict:
        if not self.rounds:
            return {"rounds": 0}
        parts = np.array([r.participants for r in self.rounds], np.float64)
        ratio = np.array([r.participation for r in self.rounds])
        wall = float(sum(r.wall_s for r in self.rounds))
        total_participants = int(parts.sum())
        return {
            "rounds": len(self.rounds),
            "total_participants": total_participants,
            "clients_per_sec": total_participants / max(wall, 1e-9),
            "wall_s": wall,
            "ticks": int(sum(r.ticks for r in self.rounds)),
            "participation_p50": float(np.percentile(ratio, 50)),
            "participation_p10": float(np.percentile(ratio, 10)),
            "canceled_total": int(sum(r.canceled for r in self.rounds)),
            "published": int(sum(r.published for r in self.rounds)),
            "delivered": int(sum(r.delivered for r in self.rounds)),
            "dropped": int(sum(r.dropped for r in self.rounds)),
            "final_dist_to_optimum": self.rounds[-1].dist_to_optimum,
        }

    def format_table(self) -> str:
        head = (
            f"{'round':>5} {'online':>7} {'clients':>8} {'canceled':>9} "
            f"{'ticks':>6} {'dropped':>8} {'loss':>10} {'dist':>8}"
        )
        lines = [head]
        for r in self.rounds:
            loss = f"{r.mean_client_loss:.4f}" if r.mean_client_loss is not None else "-"
            dist = f"{r.dist_to_optimum:.4f}" if r.dist_to_optimum is not None else "-"
            lines.append(
                f"{r.round:>5} {r.online_at_start:>7} {r.participants:>8} "
                f"{r.canceled:>9} {r.ticks:>6} {r.dropped:>8} {loss:>10} {dist:>8}"
            )
        s = self.summary()
        if s["rounds"]:
            lines.append(
                f"-- {s['rounds']} rounds, {s['total_participants']} client-rounds, "
                f"{s['clients_per_sec']:.0f} clients/s, "
                f"{s['dropped']} notifications dropped"
            )
        return "\n".join(lines)
