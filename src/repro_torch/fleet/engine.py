"""The unified fleet event engine.

One time-ordered heap drives everything the simulator used to poll for:

* **ignition toggles** — `repro_torch.fleet.churn.EventChurn` pushes its seeded
  geometric toggle events straight into the engine (phase CHURN);
* **service wakes and straggler/resync releases** — `EngineService`
  (below) models per-client service rates as token-bucket refill events:
  an idle client's periodic dial-in is a refill at its next resync phase
  tick, and a gated straggler's budget refills at its next ungated slot
  (phase SERVICE). Broker-delivery wakes stay O(1) bit flips on a hot
  queue — no heap traffic from other threads;
* **round/analytics deadline closes** — `pump_until_deadline` registers
  the round deadline as a timer entry (phase TIMER) and closes on it.

`FleetSimulator.tick` drains the heap once per tick in O(events due):
a mostly-idle million-vehicle tick pops a handful of entries instead of
scanning the fleet. Same-tick ordering is made deterministic by the
phase number — churn toggles apply before service events, which apply
before timers — reproducing the legacy tick's phase order exactly, and
heap ties beyond (at, phase, key) break by schedule order.

Parity contract (the house rule): the dense per-tick poll survives as
the oracle — `SimConfig(backends=Backends(engine="dense", service=
"dense", churn="dense"))` runs the original O(N) loops, and the engine
must reproduce its aggregates, broker counters, and churn sequences
bit-for-bit at the same seed. `tests/test_engine.py` proves it across a
faults × churn × stragglers grid.
"""
from __future__ import annotations

import heapq
from repro_torch.core.counter import Counter
import threading
from collections import deque
from functools import partial
from typing import TYPE_CHECKING, Callable, Iterable

import numpy as np

from repro_torch.fleet.service import FleetServiceScheduler

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.broker import Broker, Message, Subscription
    from repro_torch.core.client import EdgeClient
    from repro_torch.fleet.elastic import FleetPool

#: same-tick phase order — the legacy tick applied churn toggles first,
#: then serviced clients; timers (round deadlines) observe both.
#: PHASE_ADMIT runs before everything: the fleet query gateway
#: (`repro_torch.serve.gateway`) drains analyst requests there, so reads see
#: the between-ticks snapshot and submissions commit before this tick's
#: churn toggles or service sweep can observe them.
PHASE_ADMIT, PHASE_CHURN, PHASE_SERVICE, PHASE_TIMER = -1, 0, 1, 2


class Entry:
    """One scheduled event. `cancel()` is O(1) — the heap entry goes
    stale and is skipped on pop; `fired` flips when the drain ran it."""

    __slots__ = ("at", "phase", "key", "fn", "fired", "canceled")

    def __init__(self, at: int, phase: int, key: int, fn):
        self.at = at
        self.phase = phase
        self.key = key
        self.fn = fn
        self.fired = False
        self.canceled = False

    def cancel(self) -> None:
        self.canceled = True


class CalendarLane:
    """A numpy calendar-queue lane for phase-periodic per-index events.

    The engine heap is pure Python: at 100k+ vehicles the heappush/pop
    constant on high-rate same-tick service refills dominates a
    mostly-idle tick. But the refill schedule is
    *purely periodic* — index ``i`` fires exactly when
    ``(t + i) % period == 0``, a time-invariant phase — so the whole
    schedule collapses to calendar buckets: bucket ``i % period`` holds
    index ``i`` forever, and the bucket due at tick ``t`` is
    ``(-t) % period``. Firing a tick is then ONE vectorized gather
    (`bucket[self._on[bucket]]`) over a boolean membership column instead
    of O(due) heap pops + O(due) re-pushes.

    * periodic mode (resync refills): membership = powered-on; the lane
      fires the index at every due tick while the bit is set — the exact
      fire set of a heap entry that re-arms itself one period ahead, with
      power-off handled by clearing the bit instead of a stale check.
    * ``one_shot`` mode (straggler releases): arming sets the bit; the
      first due tick clears it and fires — the next ungated slot, exactly
      the heap's ``t + (-(t + i)) % period`` booking.

    The callback receives the WHOLE due batch as one index array — the
    "batch same-tick refills into one array op" design.
    """

    __slots__ = ("period", "callback", "one_shot", "_on", "_buckets")

    def __init__(
        self,
        period: int,
        callback: Callable[[np.ndarray, int], None],
        *,
        one_shot: bool = False,
        capacity: int = 1,
    ):
        self.period = max(1, int(period))
        self.callback = callback
        self.one_shot = one_shot
        self._on = np.zeros(max(1, int(capacity)), bool)
        #: phase -> cached ascending index array (rebuilt on growth)
        self._buckets: dict[int, np.ndarray] = {}

    def ensure(self, n: int) -> None:
        if n <= len(self._on):
            return
        cap = max(int(n), 2 * len(self._on))
        arr = np.zeros(cap, bool)
        arr[: len(self._on)] = self._on
        self._on = arr
        self._buckets.clear()

    def set_member(self, i: int, member: bool) -> None:
        self.ensure(i + 1)
        self._on[i] = member

    def member(self, i: int) -> bool:
        return i < len(self._on) and bool(self._on[i])

    def _bucket(self, phase: int) -> np.ndarray:
        # cache invalidated wholesale by ensure() on growth
        b = self._buckets.get(phase)
        if b is None:
            b = np.arange(phase, len(self._on), self.period)
            self._buckets[phase] = b
        return b

    def due(self, t: int) -> np.ndarray:
        """Member indices due at tick t, ascending — one boolean gather."""
        bucket = self._bucket((-t) % self.period)
        return bucket[self._on[bucket]]

    def fire(self, t: int) -> int:
        due = self.due(t)
        if due.size == 0:
            return 0
        if self.one_shot:
            self._on[due] = False
        self.callback(due, t)
        return int(due.size)


class EventEngine:
    """A single time-ordered event heap for the whole fleet world.

    API (the registration surface the subsystems share):

    * ``schedule(at, fn)`` — run ``fn`` when the drain reaches tick
      ``at``; returns the `Entry` (cancelable, `fired`-observable).
    * ``wake(cid)`` — nudge a client's service wake hook by id (the same
      hook broker deliveries fire); O(1), callable from any thread.
    * ``on_status(topic, cb)`` — reliable subscription whose messages are
      dispatched to ``cb`` the moment they land (via `Subscription.wake`),
      not polled.

    Determinism: entries pop in ``(at, phase, key, schedule order)``
    order. All heap mutation happens on the simulator thread; cross-
    thread interaction goes through `wake`, which only touches GIL-atomic
    structures.
    """

    def __init__(self, broker: "Broker | None" = None):
        self._broker = broker
        self._heap: list[tuple[int, int, int, int, Entry]] = []
        self._seq = Counter()
        self._wakes: dict[str, Callable[[], None]] = {}
        #: calendar-queue lanes fired at the PHASE_SERVICE point of every
        #: drain (registration order). The heap stays the home of sparse
        #: timers and churn; lanes carry the high-rate periodic refills.
        self._lanes: list[CalendarLane] = []
        #: last drained tick; during a drain, the tick being drained
        self.now = 0
        #: True while `drain` runs — same-tick schedules are legal then
        self.draining = False

    # -- registration --------------------------------------------------- #
    def schedule(
        self,
        at: int,
        fn: Callable[[], None] | None = None,
        *,
        phase: int = PHASE_TIMER,
        key: int = 0,
    ) -> Entry:
        entry = Entry(int(at), phase, key, fn)
        heapq.heappush(self._heap, (entry.at, phase, key, next(self._seq), entry))
        return entry

    def bind_wake(self, cid: str, fn: Callable[[], None]) -> None:
        self._wakes[cid] = fn

    def unbind_wake(self, cid: str) -> None:
        self._wakes.pop(cid, None)

    def wake(self, cid: str) -> bool:
        """Fire a client's wake hook by id (True if one is bound)."""
        fn = self._wakes.get(cid)
        if fn is None:
            return False
        fn()
        return True

    def on_status(
        self, topic: str, cb: Callable[["Message"], None]
    ) -> "Subscription":
        """Dispatch every message on `topic` to `cb` as it is delivered.

        The subscription is reliable (user-side AMQP leg: no delay
        faults), so `cb` observes transitions synchronously with the
        store commit. Returns the subscription for unsubscribe."""
        if self._broker is None:
            raise RuntimeError("EventEngine has no broker attached")
        sub = self._broker.subscribe(topic, qos=1, reliable=True)

        def pump() -> None:
            for msg in sub.drain():
                cb(msg)

        sub.wake = pump
        return sub

    def add_lane(self, lane: CalendarLane) -> None:
        """Register a calendar-queue lane. Lanes fire between the heap's
        PHASE_CHURN and later-phase entries of each drained tick, so lane
        events occupy the same slot in the deterministic order that
        PHASE_SERVICE heap entries do (membership changes made by churn
        callbacks at tick t are visible to tick t's lane fires, exactly
        like the heap's same-drain service bookings)."""
        self._lanes.append(lane)

    # -- the per-tick sweep --------------------------------------------- #
    def drain(self, t: int) -> int:
        """Run every entry due at or before tick `t`, in deterministic
        (at, phase, key, schedule-order) order. Callbacks may schedule
        same-tick entries (e.g. a churn power-on queueing a service
        refill at `t`); the heap ordering runs them in phase order within
        this same drain. Calendar lanes fire at the churn/service
        boundary — with no lanes registered the split pop loop below is
        the original single loop, entry for entry. Returns the number of
        events fired (heap entries + lane batch members)."""
        self.now = t
        self.draining = True
        fired = 0
        heap = self._heap
        try:
            # overdue entries, this tick's gateway admissions, and this
            # tick's churn toggles first: lane membership must reflect
            # every power transition at tick t
            while heap and (
                heap[0][0] < t or (heap[0][0] == t and heap[0][1] <= PHASE_CHURN)
            ):
                entry = heapq.heappop(heap)[4]
                if entry.canceled:
                    continue
                entry.fired = True
                if entry.fn is not None:
                    entry.fn()
                fired += 1
            for lane in self._lanes:
                fired += lane.fire(t)
            while heap and heap[0][0] <= t:
                entry = heapq.heappop(heap)[4]
                if entry.canceled:
                    continue
                entry.fired = True
                if entry.fn is not None:
                    entry.fn()
                fired += 1
        finally:
            self.draining = False
        return fired

    def __len__(self) -> int:
        return len(self._heap)


class EngineService(FleetServiceScheduler):
    """Engine-native fleet service: the scheduler's sweep without the
    per-tick O(N) numpy masks.

    Where `FleetServiceScheduler` recomputes straggler/resync phase masks
    over the whole fleet every tick, this service keeps each client's
    *next* service credit in the engine heap — a token-bucket view of the
    same phase arithmetic:

    * every online client holds a **resync refill** event at its next
      ``(t + index) % resync_period == 0`` tick, rescheduled one period
      ahead each time it fires (stale-checked across power cycles);
    * a straggler that gets woken while gated books a **straggler
      release** event at its next ungated slot — its service budget
      refilling — instead of being re-examined every tick;
    * broker/container wakes append the index to a `deque` (GIL-atomic,
      any thread) and flip the runnable bit; the next tick folds the hot
      queue into the sweep.

    The sweep itself — order, gating, clear-then-set runnable discipline,
    post-advance re-arm — is the scheduler's own `_sweep`, so the parity
    argument is inherited rather than re-proven: a tick services exactly
    the indices the dense loop would touch for a broker-visible action,
    in the same ascending order.
    """

    #: events, not masks: the base class skips allocating/growing its
    #: `_idx`/`_online` per-tick gating arrays for this subclass (they
    #: were dead weight here — only the mask-based tick() reads them)
    _uses_masks = False

    def __init__(
        self,
        engine: EventEngine,
        pool: "FleetPool",
        *,
        steps_per_tick: int,
        resync_period: int,
        straggler_period: int,
        straggler_indices: Iterable[int] = (),
    ):
        self._engine = engine
        self._hot: deque[int] = deque()
        self._due: list[int] = []
        self._resync_at: dict[int, int] = {}
        self._release_at: dict[int, int] = {}
        super().__init__(
            pool,
            steps_per_tick=steps_per_tick,
            resync_period=resync_period,
            straggler_period=straggler_period,
            straggler_indices=straggler_indices,
        )

    # -- wake plumbing --------------------------------------------------- #
    def _make_wake(self, i: int):
        def wake() -> None:
            live = self._live
            if (
                live is not None
                and threading.current_thread() is self._sweep_thread
            ):
                if i == self._cursor:
                    # self-wake of the client being serviced: the sweep's
                    # post-advance has_work check decides runnability
                    return
                if not self._runnable[i]:
                    self._runnable[i] = True
                    self._hot.append(i)
                if i > self._cursor:
                    heapq.heappush(live, i)
                return
            # outside a sweep / from another thread: flip the bit and note
            # the index on the hot queue — there is no per-tick mask to
            # pick a lone bit up, so the flip must leave a trace
            if not self._runnable[i]:
                self._runnable[i] = True
                self._hot.append(i)

        return wake

    def _note_runnable(self, i: int) -> None:
        # post-advance re-arm: still has work => service again next tick
        self._runnable[i] = True
        self._hot.append(i)

    # -- token-bucket refill events -------------------------------------- #
    def _schedule_resync(self, i: int) -> None:
        eng = self._engine
        # earliest serviceable tick: the tick being drained if we are
        # inside a drain (a churn power-on), else the next one
        t0 = eng.now + (0 if eng.draining else 1)
        at = t0 + (-(t0 + i)) % self.resync_period
        self._resync_at[i] = at
        eng.schedule(
            at, partial(self._fire_resync, i, at), phase=PHASE_SERVICE, key=i
        )

    def _fire_resync(self, i: int, at: int) -> None:
        if self._resync_at.get(i) != at:
            return  # stale: the client power-cycled since this was booked
        nxt = at + self.resync_period
        self._resync_at[i] = nxt
        self._engine.schedule(
            nxt, partial(self._fire_resync, i, nxt), phase=PHASE_SERVICE, key=i
        )
        self._due.append(i)

    def _on_gated_skip(self, i: int, t: int) -> None:
        # a straggler woke while gated: book its budget refill at the next
        # ungated slot instead of re-checking the gate every tick
        if not self._runnable[i] or i in self._release_at:
            return
        at = t + (-(t + i)) % self.straggler_period
        self._release_at[i] = at
        self._engine.schedule(
            at, partial(self._fire_release, i, at), phase=PHASE_SERVICE, key=i
        )

    def _fire_release(self, i: int, at: int) -> None:
        if self._release_at.get(i) != at:
            return
        del self._release_at[i]
        if self._runnable[i] and self._clients[i] is not None:
            self._due.append(i)

    # -- pool membership hooks -------------------------------------------- #
    def client_powered_on(self, index: int, client: "EdgeClient") -> None:
        super().client_powered_on(index, client)
        if self._runnable[index]:
            self._hot.append(index)
        self._engine.bind_wake(client.client_id, self._make_wake(index))
        self._schedule_resync(index)

    def client_powered_off(self, index: int) -> None:
        if index < self._capacity:
            c = self._clients[index]
            if c is not None:
                self._engine.unbind_wake(c.client_id)
        super().client_powered_off(index)
        # pending refill events go stale rather than being heap-deleted
        self._resync_at.pop(index, None)
        self._release_at.pop(index, None)

    # -- the per-tick service step ---------------------------------------- #
    def tick(self, t: int) -> None:
        """Service exactly the clients with a due event this tick: refill
        events collected by the engine drain plus hot-queue wakes — no
        fleet-wide mask, O(due + runnable)."""
        live = self._due
        self._due = []
        hot = self._hot
        while hot:
            i = hot.popleft()
            if self._runnable[i] and self._clients[i] is not None:
                live.append(i)
        heapq.heapify(live)
        self._sweep(live, t)


class CalendarService(EngineService):
    """`EngineService` with the periodic refill schedule moved out of the
    Python heap into numpy `CalendarLane`s — the 100k+ fast path.

    The heap version books one entry per online client per resync period
    and re-pushes it on every fire: O(online) heappush/pop per period,
    pure Python, the dominant cost of a mostly-idle mega-fleet tick. But
    the resync schedule is time-invariant — client ``i`` refills exactly
    when ``(t + i) % resync_period == 0`` — so membership in calendar
    bucket ``i % period`` plus a powered-on bit reproduces the heap's
    fire set with ONE vectorized gather per tick:

    * **resync lane** (periodic): the membership bit IS the power state;
      `_schedule_resync`/power-off set/clear it. No re-arming, no stale
      checks — a cleared bit is the stale check.
    * **release lane** (one-shot): `_on_gated_skip` arms the bit; the
      lane fires it at the next ungated slot — the heap's
      ``t + (-(t + i)) % straggler_period`` booking — and clears it.

    Everything else — the hot wake queue, `_due` consumption, `_sweep`
    order and discipline — is inherited unchanged, so the bit-for-bit
    parity argument reduces to lane-fires == heap-fires, which
    `tests/test_calendar.py` proves over random schedules and a dense
    grid. The heap `EngineService` stays the parity oracle per house
    style.
    """

    def __init__(
        self,
        engine: EventEngine,
        pool: "FleetPool",
        *,
        steps_per_tick: int,
        resync_period: int,
        straggler_period: int,
        straggler_indices: Iterable[int] = (),
    ):
        cap = max(1, len(pool.vehicles))
        self._resync_lane = CalendarLane(
            resync_period, self._lane_resync, capacity=cap
        )
        self._release_lane = CalendarLane(
            straggler_period, self._lane_release, one_shot=True, capacity=cap
        )
        engine.add_lane(self._resync_lane)
        engine.add_lane(self._release_lane)
        # super() powers on every live vehicle, which routes through the
        # lane-backed _schedule_resync below — lanes must already exist
        super().__init__(
            engine,
            pool,
            steps_per_tick=steps_per_tick,
            resync_period=resync_period,
            straggler_period=straggler_period,
            straggler_indices=straggler_indices,
        )

    # -- lane callbacks (whole due batch per tick) ----------------------- #
    def _lane_resync(self, idx: "np.ndarray", t: int) -> None:
        # the heap's _fire_resync appended unconditionally (staleness was
        # the power check); membership already encodes power state here
        self._due.extend(idx.tolist())

    def _lane_release(self, idx: "np.ndarray", t: int) -> None:
        runnable = self._runnable
        clients = self._clients
        for i in idx.tolist():
            if runnable[i] and clients[i] is not None:
                self._due.append(i)

    # -- lane-backed refill schedule -------------------------------------- #
    def _schedule_resync(self, i: int) -> None:
        self._resync_lane.set_member(i, True)

    def _on_gated_skip(self, i: int, t: int) -> None:
        if not self._runnable[i] or self._release_lane.member(i):
            return
        self._release_lane.set_member(i, True)

    def client_powered_off(self, index: int) -> None:
        super().client_powered_off(index)
        self._resync_lane.set_member(index, False)
        self._release_lane.set_member(index, False)
