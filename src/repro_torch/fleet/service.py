"""Plane-native fleet service scheduling (ROADMAP: "plane-native client
service").

The simulator's original step-4 loop polled every online `EdgeClient`
every tick: an `idle` check plus an `advance()` per vehicle, each paying
queue/lock overhead even when the client had nothing to do. At N >= 1024
that dense poll is the dominant Python cost of a mostly-idle fleet tick —
the exact central-instance per-client bookkeeping bottleneck OODIDA
(arXiv:1902.00319) reports, and the reason MEDAL (arXiv:2102.13125)
argues for event-driven edge orchestration.

Two interchangeable services implement the same `tick(t)` contract:

* `DensePollService` — the original O(N)-per-tick loop, verbatim. Kept as
  the **parity oracle**: the scheduler must reproduce its event
  interleaving bit-for-bit (same broker message ids => same seeded fault
  schedule => same aggregate), and `tests/test_service.py` proves it.
* `FleetServiceScheduler` — event-driven: clients become *runnable* via
  cheap wake hooks (broker delivery to their clock topic, container-event
  enqueue, `EdgeClient._spawn`) instead of being polled. Straggler and
  resync phase gating is evaluated as vectorized numpy masks over the
  whole fleet, so one tick costs a couple of numpy ops plus a Python loop
  over only the runnable/resync-due clients — O(runnable), not O(N).

Parity argument (why skipping idle clients is bit-for-bit safe): a dense
iteration over an idle, non-resync-due client performs no broker-visible
action (`advance` finds no events and no ops), so eliding it cannot
perturb the publish order, the message-id sequence, or any client state.
Clients woken *during* a sweep by an earlier-indexed client's service are
picked up at their index position exactly as the dense loop would reach
them; wakes at already-passed indices stay runnable for the next tick,
which is also what the dense loop does.
"""
from __future__ import annotations

import heapq
import threading
from typing import TYPE_CHECKING, Iterable

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.client import EdgeClient
    from repro_torch.fleet.elastic import FleetPool


class DensePollService:
    """The original per-tick poll loop over every vehicle — the parity
    oracle and benchmark baseline for `FleetServiceScheduler`."""

    def __init__(
        self,
        pool: "FleetPool",
        *,
        steps_per_tick: int,
        resync_period: int,
        straggler_period: int,
        stragglers: Iterable[str] = (),
    ):
        self.pool = pool
        self.steps_per_tick = steps_per_tick
        self.resync_period = resync_period
        self.straggler_period = straggler_period
        self.stragglers = set(stragglers)
        #: clients actually advanced last tick (dense: every online,
        #: non-gated vehicle, idle or not)
        self.last_serviced = 0

    def tick(self, t: int) -> None:
        served = 0
        for i, (cid, v) in enumerate(self.pool.vehicles.items()):
            c = v.client
            if c is None:
                continue
            if cid in self.stragglers and (t + i) % self.straggler_period:
                continue  # straggler: skips this tick's service slot
            if c.idle and (t + i) % self.resync_period == 0:
                # periodic dial-in recovers dropped QoS-0 notifications
                c.resync()
            c.advance(self.steps_per_tick)
            served += 1
        self.last_serviced = served

    # pool membership hooks (the dense loop re-scans the pool every tick,
    # so it needs none of this)
    def client_powered_on(self, index: int, client: "EdgeClient") -> None:
        pass

    def client_powered_off(self, index: int) -> None:
        pass


class FleetServiceScheduler:
    """Event-driven runnable set + vectorized phase gating.

    State is indexed by vehicle index (`Vehicle.metadata["index"]`, which
    equals the vehicle's position in `pool.vehicles` — entries are only
    ever appended):

    * ``_online`` / ``_runnable`` / ``_straggler`` — numpy bool arrays;
    * ``_clients`` — index -> live `EdgeClient` (None while powered off).

    A client's wake hook sets its runnable bit (and, mid-sweep, enqueues
    it into the current tick's heap if its index has not been passed yet).
    Each `tick` computes the straggler/resync phase masks for the whole
    fleet in a few vectorized numpy expressions and then services only the
    candidate indices, in ascending order — the dense loop's order.
    """

    #: The mask-based tick() gates the fleet with per-index numpy arrays
    #: (`_idx`, `_online`). `EngineService` replaces tick() with heap-fed
    #: events and never reads them, so it opts out and the event path
    #: carries no dead per-tick gating state (the dense oracle keeps its
    #: own copy).
    _uses_masks = True

    def __init__(
        self,
        pool: "FleetPool",
        *,
        steps_per_tick: int,
        resync_period: int,
        straggler_period: int,
        straggler_indices: Iterable[int] = (),
    ):
        self.pool = pool
        self.steps_per_tick = steps_per_tick
        self.resync_period = resync_period
        self.straggler_period = straggler_period
        n = max(1, len(pool.vehicles))
        self._capacity = n
        if self._uses_masks:
            self._idx = np.arange(n)
            self._online = np.zeros(n, bool)
        # gating state lives in the pool's shared FleetColumns arena when
        # one is attached (the columnar control plane: StateStore, the
        # services, and FleetMetrics all view the same per-client arrays);
        # detached pools fall back to private arrays. Access goes through
        # the `_runnable`/`_straggler` properties — the arena reallocates
        # on growth, so views are taken at use time, never cached.
        self._cols = getattr(pool, "columns", None)
        if self._cols is not None:
            self._cols.ensure(n)
            self._cols.runnable[:n] = False
            self._cols.straggler[:n] = False
        else:
            self._runnable_local = np.zeros(n, bool)
            self._straggler_local = np.zeros(n, bool)
        self._clients: list["EdgeClient | None"] = [None] * n
        for i in straggler_indices:
            self._ensure_index(i)
            self._straggler[i] = True
        # sweep state: a heap of indices still to service this tick (None
        # outside `tick`), the highest index already serviced, and the
        # thread running the sweep (only same-thread wakes may touch the
        # heap)
        self._live: list[int] | None = None
        self._cursor = -1
        self._sweep_thread: threading.Thread | None = None
        self.last_serviced = 0
        for v in pool.vehicles.values():
            if v.client is not None:
                self.client_powered_on(v.metadata["index"], v.client)

    # ------------------------------------------------------------------ #
    # gating columns (arena-backed when the pool carries a FleetColumns) #
    # ------------------------------------------------------------------ #
    @property
    def _runnable(self) -> np.ndarray:
        if self._cols is not None:
            return self._cols.runnable[: self._capacity]
        return self._runnable_local

    @_runnable.setter
    def _runnable(self, arr) -> None:
        if self._cols is not None:
            self._cols.runnable[: self._capacity] = arr
        else:
            self._runnable_local = np.asarray(arr, bool)

    @property
    def _straggler(self) -> np.ndarray:
        if self._cols is not None:
            return self._cols.straggler[: self._capacity]
        return self._straggler_local

    @_straggler.setter
    def _straggler(self, arr) -> None:
        if self._cols is not None:
            self._cols.straggler[: self._capacity] = arr
        else:
            self._straggler_local = np.asarray(arr, bool)

    # ------------------------------------------------------------------ #
    # wake plumbing                                                      #
    # ------------------------------------------------------------------ #
    def _make_wake(self, i: int):
        def wake() -> None:
            live = self._live
            if (
                live is not None
                and threading.current_thread() is self._sweep_thread
            ):
                if i == self._cursor:
                    # the client being serviced woke itself (an op spawned
                    # and consumed within its own advance): the sweep's
                    # post-advance has_work check decides runnability, so
                    # setting the bit here would leave it stale
                    return
                self._runnable[i] = True
                if i > self._cursor:
                    # woken mid-sweep at an index the dense loop has not
                    # reached yet: service it this tick, in order
                    heapq.heappush(live, i)
                return
            # outside a sweep, or from another thread (a ContainerThread's
            # exit callback): only set the bit — heapq on a plain list is
            # not thread-safe, and the next tick picks the bit up anyway
            self._runnable[i] = True

        return wake

    def _ensure_index(self, i: int) -> None:
        if i < self._capacity:
            return
        cap = max(i + 1, 2 * self._capacity)
        if self._uses_masks:
            self._idx = np.arange(cap)
            arr = np.zeros(cap, bool)
            arr[: self._capacity] = self._online
            self._online = arr
        if self._cols is not None:
            self._cols.ensure(cap)  # new rows default runnable/straggler=False
        else:
            for name in ("_runnable_local", "_straggler_local"):
                arr = np.zeros(cap, bool)
                arr[: self._capacity] = getattr(self, name)
                setattr(self, name, arr)
        self._clients.extend([None] * (cap - self._capacity))
        self._capacity = cap

    # pool membership hooks ------------------------------------------------
    def client_powered_on(self, index: int, client: "EdgeClient") -> None:
        self._ensure_index(index)
        self._clients[index] = client
        if self._uses_masks:
            self._online[index] = True
        client.set_wake(self._make_wake(index))
        # bootstrap already spawned ops before the hook ran: seed from the
        # client's actual state rather than assuming idle
        self._runnable[index] = client.has_work
        if (
            self._live is not None
            and self._runnable[index]
            and index > self._cursor
        ):
            heapq.heappush(self._live, index)

    def client_powered_off(self, index: int) -> None:
        if index >= self._capacity:
            return
        c = self._clients[index]
        if c is not None:
            c.set_wake(None)
        self._clients[index] = None
        if self._uses_masks:
            self._online[index] = False
        self._runnable[index] = False

    # ------------------------------------------------------------------ #
    # the per-tick sweep                                                 #
    # ------------------------------------------------------------------ #
    def tick(self, t: int) -> None:
        idx = self._idx
        # vectorized phase gating over the whole fleet: two numpy masks
        # replace N per-client modulo checks
        phase = (t + idx) % self.resync_period == 0
        gated = self._straggler & (((t + idx) % self.straggler_period) != 0)
        cand = self._online & ~gated & (self._runnable | phase)
        live = [int(i) for i in np.flatnonzero(cand)]  # ascending => a heap
        self._sweep(live, t)

    # hooks the engine-native subclass overrides (repro_torch.fleet.engine):
    # the sweep below is the parity-critical loop both services share
    def _on_gated_skip(self, i: int, t: int) -> None:
        """A gated straggler surfaced mid-sweep; the mask recomputation
        next tick re-examines it, so the base scheduler needs no note."""

    def _note_runnable(self, i: int) -> None:
        """Post-advance re-arm: the client still has work."""
        self._runnable[i] = True

    def _sweep(self, live: list[int], t: int) -> None:
        """Service `live` (a heap of candidate indices) in ascending
        order — the dense loop's order. Shared verbatim by the scheduler
        and `EngineService`, so the bit-for-bit parity argument holds for
        both: gating, the clear-then-set runnable discipline, and the
        post-advance re-arm are identical."""
        self._live = live
        self._cursor = -1
        self._sweep_thread = threading.current_thread()
        served = 0
        try:
            while live:
                i = heapq.heappop(live)
                if i <= self._cursor:
                    continue  # duplicate wake for an already-serviced index
                self._cursor = i
                c = self._clients[i]
                if c is None:
                    continue
                if self._straggler[i] and (t + i) % self.straggler_period:
                    self._on_gated_skip(i, t)
                    continue  # gated straggler woken mid-sweep: next slot
                # clear-then-set, never assign after advance: a cross-thread
                # wake landing between `c.has_work` and the store must not
                # be clobbered ("missed wakes are not [allowed]")
                self._runnable[i] = False
                if not c.has_work and (t + i) % self.resync_period == 0:
                    c.resync()
                c.advance(self.steps_per_tick)
                if c.has_work:
                    self._note_runnable(i)
                served += 1
        finally:
            self._live = None
            self._cursor = -1
            self._sweep_thread = None
        self.last_serviced = served


def make_service(
    kind: str,
    pool: "FleetPool",
    *,
    steps_per_tick: int,
    resync_period: int,
    straggler_period: int,
    straggler_indices: Iterable[int] = (),
):
    """Build the configured service implementation ("scheduler" is the
    event-driven default; "dense" is the poll-loop parity oracle).

    Both take the straggler set as vehicle *indices* — the dense oracle's
    cid set is derived here, so the two representations cannot drift and
    silently break the bit-for-bit parity contract."""
    if kind == "dense":
        idx = set(straggler_indices)
        return DensePollService(
            pool,
            steps_per_tick=steps_per_tick,
            resync_period=resync_period,
            straggler_period=straggler_period,
            stragglers={
                cid
                for cid, v in pool.vehicles.items()
                if v.metadata["index"] in idx
            },
        )
    if kind == "scheduler":
        return FleetServiceScheduler(
            pool,
            steps_per_tick=steps_per_tick,
            resync_period=resync_period,
            straggler_period=straggler_period,
            straggler_indices=straggler_indices,
        )
    raise ValueError(f"unknown service kind {kind!r}; use 'scheduler' or 'dense'")
