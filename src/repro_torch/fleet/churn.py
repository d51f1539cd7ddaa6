"""Event-driven ignition churn: geometric inter-arrival times per vehicle.

The simulator's churn step used to draw one RNG sample *per vehicle per
tick* whenever ``p_leave``/``p_return`` were set — the last O(N) Python
loop on the tick path (ROADMAP). A per-tick Bernoulli(p) coin is
equivalent to drawing the whole waiting time at once: the number of ticks
until the first success is Geometric(p), sampled in O(1) by inverse CDF
(``1 + floor(log1p(-u) / log1p(-p))``). So each vehicle gets a seeded
*event time* instead of a nightly coin, and a tick costs O(events), not
O(N):

* `EventChurn` — a min-heap of ``(tick, index, cid)`` toggle events.
  ``pop_due(now)`` pops only vehicles whose ignition flips this tick.
* `DenseChurn` — the O(N)-scan oracle: same per-vehicle RNG streams, same
  scheduling rule, but ``pop_due`` walks every watched vehicle. The
  parity test proves the heap machinery reproduces the dense scan's
  toggle sequence exactly at a fixed seed.

Determinism and composability: every vehicle draws from its own
``default_rng((seed, 0xC0FFEE, index))`` stream, so event times never
depend on fleet size, membership order, or how other vehicles toggle —
the same row-stability contract the signal scenarios follow. External
power transitions (tests and drivers call `FleetPool.power_on/off`
directly) re-enter through `notify`, which reschedules the vehicle from
its *actual* new state, so the schedule can never disagree with the
world: an externally parked vehicle still returns at a Geometric
(p_return) horizon, exactly like the per-tick coin did.
"""
from __future__ import annotations

import heapq
import math
from functools import partial

import numpy as np


def geometric_gap(u: float, p: float) -> int:
    """Ticks until the first success of a Bernoulli(p) sequence (>= 1),
    from one uniform draw: the inverse-CDF geometric sample."""
    if p >= 1.0:
        return 1
    return 1 + int(math.floor(math.log1p(-u) / math.log1p(-p)))


class EventChurn:
    """Seeded churn event schedule, O(events) per tick.

    A watched *online* vehicle holds a pending ignition-off event at a
    Geometric(p_leave) horizon; an *offline* one holds an ignition-on
    event at Geometric(p_return). A probability of zero means that
    transition never fires (matching the per-tick coin, which could never
    land below 0). `pop_due` yields the cids whose toggle is due this
    tick, in fleet (index) order — the order the dense per-vehicle loop
    used.
    """

    def __init__(self, seed: int, p_leave: float, p_return: float):
        self.p_leave = float(p_leave)
        self.p_return = float(p_return)
        self._seed = seed
        self._rng: dict[str, np.random.Generator] = {}
        self._online: dict[str, bool] = {}
        self._index: dict[str, int] = {}
        self._next: dict[str, int | None] = {}
        self._heap: list[tuple[int, int, str]] = []
        self.now = 0
        #: when attached, toggle events live in the unified engine heap
        #: (repro_torch.fleet.engine) instead of the private one
        self._engine = None
        self._toggle = None

    # -- unified-engine sink --------------------------------------------- #
    def attach_engine(self, engine, toggle) -> None:
        """Route future (and any already-pending) toggle events into the
        unified `EventEngine` heap. `toggle(cid)` performs the power
        transition; `pop_due` is never called in this mode — the engine's
        drain fires toggles in the same (tick, index) fleet order."""
        from repro_torch.fleet.engine import PHASE_CHURN  # cycle-free late import

        self._engine = engine
        self._toggle = toggle
        self._phase = PHASE_CHURN
        while self._heap:
            t, idx, cid = heapq.heappop(self._heap)
            if self._next.get(cid) == t:
                engine.schedule(
                    t, partial(self._fire, cid, t), phase=PHASE_CHURN, key=idx
                )

    def _fire(self, cid: str, t: int) -> None:
        if self._next.get(cid) != t:
            return  # stale: rescheduled or canceled since pushed
        self.now = max(self.now, t)
        self._next[cid] = None
        self._toggle(cid)  # re-enters via notify to draw the next gap

    # -- membership ------------------------------------------------------ #
    def watch(self, cid: str, index: int, online: bool, now: int | None = None) -> None:
        """Start scheduling a vehicle. Idempotent per cid."""
        if cid in self._online:
            return
        if now is not None:
            self.now = max(self.now, now)
        self._index[cid] = int(index)
        self._rng[cid] = np.random.default_rng((self._seed, 0xC0FFEE, int(index)))
        self._online[cid] = bool(online)
        self._next[cid] = None
        self._schedule(cid)

    def notify(self, cid: str, index: int, online: bool) -> None:
        """A power transition happened (churn-driven or external): track
        the new state and reschedule from it. Unknown vehicles (joined
        mid-experiment) are auto-watched."""
        if cid not in self._online:
            self.watch(cid, index, online)
            return
        if self._online[cid] == bool(online):
            return
        self._online[cid] = bool(online)
        self._schedule(cid)

    # -- scheduling ------------------------------------------------------ #
    #: DenseChurn never drains the heap, so it must not feed it either
    _use_heap = True

    def _schedule(self, cid: str) -> None:
        if self._engine is not None:
            # external transitions between ticks draw from the engine's
            # clock (the legacy path refreshed `now` in every pop_due)
            self.now = max(self.now, self._engine.now)
        p = self.p_leave if self._online[cid] else self.p_return
        if p <= 0.0:
            self._next[cid] = None  # pending heap entries become stale
            return
        t = self.now + geometric_gap(float(self._rng[cid].random()), p)
        self._next[cid] = t
        if self._engine is not None:
            self._engine.schedule(
                t, partial(self._fire, cid, t), phase=self._phase,
                key=self._index[cid],
            )
        elif self._use_heap:
            heapq.heappush(self._heap, (t, self._index[cid], cid))

    def pop_due(self, now: int) -> list[str]:
        """Vehicles whose ignition toggles at `now`, in fleet order.
        The caller performs the actual power transition, whose `notify`
        re-enters to schedule the next event from the new state."""
        self.now = now
        due: list[str] = []
        while self._heap and self._heap[0][0] <= now:
            t, _, cid = heapq.heappop(self._heap)
            if self._next.get(cid) != t:
                continue  # stale: rescheduled or canceled since pushed
            self._next[cid] = None
            due.append(cid)
        return due


class DenseChurn(EventChurn):
    """The O(N) oracle: identical streams and scheduling rule, but each
    tick scans every watched vehicle for a due event — the shape of the
    old per-vehicle per-tick loop. Exists to pin the heap's behaviour."""

    _use_heap = False  # the scan reads _next only; don't grow the heap

    def pop_due(self, now: int) -> list[str]:
        self.now = now
        due = [
            cid
            for cid, t in sorted(
                self._next.items(), key=lambda kv: self._index[kv[0]]
            )
            if t is not None and t <= now
        ]
        for cid in due:
            self._next[cid] = None
        return due


CHURNS = ("event", "dense")


def make_churn(kind: str, seed: int, p_leave: float, p_return: float) -> EventChurn:
    if kind == "event":
        return EventChurn(seed, p_leave, p_return)
    if kind == "dense":
        return DenseChurn(seed, p_leave, p_return)
    raise ValueError(f"unknown churn {kind!r}; pick one of {CHURNS}")
