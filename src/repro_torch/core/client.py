"""The AutoSPADA edge client: Algorithm 1 (the sync loop) made executable.

The client keeps its local task state synchronized with the centralized
server state in a *state-based* (not RPC-based) fashion:

* the broker delivers only a logical-clock value ("your state changed");
* `fetchState` pulls the authoritative snapshot;
* `submit` pushes locally-buffered results / terminal statuses, then pulls
  a fresh snapshot ("both fetchState and submit send a new state back");
* `syncContainers` starts/stops task containers to match the active set;
* `syncingState` ensures at most one state exchange is in flight and
  `dirtyState` guarantees results arriving *during* an exchange trigger a
  follow-up `submit` (paper §4.2.1).

Everything durable lives on `LocalDisk`, which survives client "restarts"
(reconstructing `EdgeClient` over the same disk): unacknowledged results,
per-task next sequence numbers, cached immutable payload/parameter
documents, and task intermediate state (`cache_state`/`load_state`).

Determinism: spawned operations go into an op queue; `step()` executes one.
A driver (tests, simulator, or `run_until_idle`) chooses the interleaving.
Container execution is inline (synchronous) by default so property tests
are single-threaded; `thread_containers=True` runs payloads on daemon
threads for long-running/interactive use.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.core import sandbox
from repro_torch.core.broker import Broker, Subscription, client_clock_topic
from repro_torch.core.columns import FleetColumns
from repro_torch.core.documents import Result, TaskStatus
from repro_torch.core.faults import NetworkError
from repro_torch.core.payload_api import PayloadContext
from repro_torch.core.signals import SignalBroker, SignalHandler
from repro_torch.core.statestore import ClientStateSnapshot


@dataclass(slots=True)
class LocalDisk:
    """Durable client-side storage (survives restarts)."""

    payload_cache: dict[str, Any] = field(default_factory=dict)
    parameters_cache: dict[str, Any] = field(default_factory=dict)
    #: task_id -> list[Result] not yet confirmed recorded in the database
    unacked: dict[str, list[Result]] = field(default_factory=dict)
    #: task_id -> next result sequence number to assign
    next_seq: dict[str, int] = field(default_factory=dict)
    #: task_id -> (TaskStatus, log) terminal status pending upload
    terminal: dict[str, tuple[TaskStatus, str]] = field(default_factory=dict)
    #: task intermediate state (cache_state/load_state), keyed by task_id
    task_state: dict[str, Any] = field(default_factory=dict)
    #: task_ids whose terminal status the server has acknowledged
    done: set[str] = field(default_factory=set)


@dataclass(slots=True)
class _LocalTask:
    """An entry of the sync loop's `localTasks` map."""

    task_id: str
    payload_id: str
    parameters_id: str | None
    running: bool = False
    container: Any = None  # ContainerThread | None (inline => None)


class EdgeClient:
    """Slotted (no per-instance `__dict__`): at 100k+ vehicles the sync
    loop's Python-object overhead is the memory bill, so the layout is
    fixed and the fleet-wide scalars (`ts`, registration, unacked count)
    can live in a shared `FleetColumns` arena via `bind_columns` — one
    numpy element per client instead of a dict slot per object."""

    __slots__ = (
        "client_id", "server", "broker", "disk", "signal_handler",
        "_thread_containers", "_limits", "_metadata",
        "tasks", "local_tasks", "syncing_state", "dirty_state",
        "_ops", "_container_events", "_sub", "_wake_cb", "rpc_failures",
        "_cols", "_row", "_ts_local", "_registered_local",
    )

    def __init__(
        self,
        client_id: str,
        server: Any,  # Server | FlakyServer
        broker: Broker,
        disk: LocalDisk | None = None,
        signal_broker: SignalBroker | None = None,
        *,
        thread_containers: bool = False,
        limits: sandbox.ResourceLimits | None = None,
        metadata: dict[str, Any] | None = None,
    ):
        self.client_id = client_id
        self.server = server
        self.broker = broker
        self.disk = disk if disk is not None else LocalDisk()
        self.signal_handler = (
            SignalHandler(signal_broker) if signal_broker is not None else None
        )
        self._thread_containers = thread_containers
        self._limits = limits
        self._metadata = metadata or {}

        # --- columnar arena binding (optional; see bind_columns) ------- #
        self._cols: FleetColumns | None = None
        self._row = -1
        self._ts_local = 0
        self._registered_local = True

        # --- Algorithm 1 state ---------------------------------------- #
        self.ts = 0
        self.tasks: tuple = ()  # TaskSyncInfo tuple from last snapshot
        self.local_tasks: dict[str, _LocalTask] = {}
        self.syncing_state = False
        self.dirty_state = False

        # --- plumbing --------------------------------------------------#
        self._ops: list[tuple] = []  # pending spawned operations (FIFO)
        # deque, not queue.Queue: GIL-atomic append/popleft without a lock
        # acquisition per poll — the fleet scheduler reads `has_work` on
        # every serviced client and the old Queue.empty() mutex dominated
        # idle-fleet ticks.
        self._container_events: deque[tuple] = deque()
        self._sub: Subscription | None = None
        #: scheduler wake hook — called whenever new work arrives (an op is
        #: spawned, a broker notification lands, a container emits)
        self._wake_cb: Callable[[], None] | None = None
        self.rpc_failures = 0

    # ------------------------------------------------------------------ #
    # columnar arena binding                                             #
    # ------------------------------------------------------------------ #
    def bind_columns(self, cols: FleetColumns, row: int | None = None) -> None:
        """Move this client's scalar sync state (logical timestamp,
        registration flag, unacked-result count) into the shared arena.
        The attribute API is unchanged; reads/writes hit numpy columns."""
        r = cols.row_for(self.client_id) if row is None else row
        cols.client_ts[r] = self.ts
        cols.registered[r] = self._registered
        cols.unacked[r] = sum(len(v) for v in self.disk.unacked.values())
        self._cols, self._row = cols, r

    @property
    def ts(self) -> int:
        if self._cols is not None:
            return int(self._cols.client_ts[self._row])
        return self._ts_local

    @ts.setter
    def ts(self, value: int) -> None:
        if self._cols is not None:
            self._cols.client_ts[self._row] = value
        else:
            self._ts_local = int(value)

    @property
    def _registered(self) -> bool:
        if self._cols is not None:
            return bool(self._cols.registered[self._row])
        return self._registered_local

    @_registered.setter
    def _registered(self, value: bool) -> None:
        if self._cols is not None:
            self._cols.registered[self._row] = value
        else:
            self._registered_local = bool(value)

    def _recount_unacked(self) -> None:
        if self._cols is not None:
            self._cols.unacked[self._row] = sum(
                len(v) for v in self.disk.unacked.values()
            )

    # ------------------------------------------------------------------ #
    # lifecycle                                                          #
    # ------------------------------------------------------------------ #
    def bootstrap(self) -> None:
        """Register, subscribe to the per-client clock topic, and start an
        initial sync (also resumes any unacked uploads after a restart).
        Registration failure is survivable — a vehicle may reboot in a
        tunnel; the first successful op re-registers."""
        self._registered = False
        try:
            self.server.register_client(self.client_id, self._metadata)
            self._registered = True
        except NetworkError:
            self.rpc_failures += 1
        self._sub = self.broker.subscribe(client_clock_topic(self.client_id), qos=0)
        if self._wake_cb is not None:
            self._sub.wake = self._wake_cb
        self.syncing_state = True
        if any(self.disk.unacked.values()) or self.disk.terminal:
            # restart with pending uploads: go straight to submit
            self._spawn(("submit",))
        else:
            self._spawn(("fetch_state",))

    def _ensure_registered(self) -> None:
        if not self._registered:
            self.server.register_client(self.client_id, self._metadata)
            self._registered = True

    def resync(self) -> None:
        """Force a state pull (the paper's clients dial in on reconnect;
        a dropped QoS-0 notification is recovered by the next dial-in)."""
        if not self.syncing_state:
            self.syncing_state = True
            self._spawn(("fetch_state",))

    def shutdown(self) -> None:
        """Simulated crash/power-off: containers die, volatile state is
        lost; `LocalDisk` survives. Reconstruct EdgeClient to 'reboot'."""
        for lt in self.local_tasks.values():
            if lt.container is not None:
                lt.container.stop()
        if self._sub is not None:
            self.broker.unsubscribe(self._sub)

    # ------------------------------------------------------------------ #
    # event pump                                                         #
    # ------------------------------------------------------------------ #
    def poll(self) -> int:
        """Drain broker + container events through Algorithm 1's cases.
        Returns the number of events handled."""
        n = 0
        if self._sub is not None:
            for msg in self._sub.drain():
                self._on_clock(int(msg.value))
                n += 1
        while self._container_events:
            ev = self._container_events.popleft()
            self._on_container_event(*ev)
            n += 1
        return n

    def step(self) -> bool:
        """Execute one pending spawned op. Returns False if none pending."""
        if not self._ops:
            return False
        op = self._ops.pop(0)
        kind = op[0]
        if kind == "fetch_state":
            self._op_fetch_state()
        elif kind == "submit":
            self._op_submit()
        elif kind == "sync_containers":
            self._op_sync_containers(op[1])
        else:  # pragma: no cover
            raise AssertionError(op)
        return True

    def advance(self, budget: int = 1) -> int:
        """Simulator-driven stepping: run at most `budget` poll+step cycles
        and stop early once idle. Unlike `run_until_idle` this bounds the
        work done per simulation tick, so a discrete-event driver can model
        slow clients (small budgets) and fast ones (large budgets) against
        the same wall of events. Returns the number of productive cycles."""
        done = 0
        for _ in range(max(0, budget)):
            progressed = self.poll() > 0
            progressed |= self.step()
            if not progressed:
                break
            done += 1
        return done

    def run_until_idle(self, max_steps: int = 10_000) -> int:
        """Poll + step until no events and no ops remain."""
        steps = 0
        for _ in range(max_steps):
            progressed = self.poll() > 0
            progressed |= self.step()
            if not progressed:
                return steps
            steps += 1
        raise RuntimeError("sync loop did not quiesce")

    @property
    def has_work(self) -> bool:
        """O(1), lock-free: pending ops, undrained broker notifications, or
        container events. This is what an event-driven scheduler checks
        after servicing a client (and *only* then — arrival is signalled
        through the wake hook, not by polling this per tick)."""
        return bool(
            self._ops
            or (self._sub is not None and self._sub.has_pending)
            or self._container_events
        )

    @property
    def idle(self) -> bool:
        return not self.has_work

    def set_wake(self, cb: Callable[[], None] | None) -> None:
        """Install (or clear) the scheduler wake hook: `cb` fires whenever
        work arrives — a spawned op, a broker delivery to the clock topic,
        or a container result/status event. Spurious wakes are allowed
        (the scheduler re-checks `has_work`); missed wakes are not."""
        self._wake_cb = cb
        if self._sub is not None:
            self._sub.wake = cb

    def _spawn(self, op: tuple) -> None:
        self._ops.append(op)
        cb = self._wake_cb
        if cb is not None:
            cb()

    def _emit_container_event(self, ev: tuple) -> None:
        """Container -> sync-loop event enqueue (possibly from a container
        thread); wakes the scheduler so the event gets serviced."""
        self._container_events.append(ev)
        cb = self._wake_cb
        if cb is not None:
            cb()

    # ------------------------------------------------------------------ #
    # Algorithm 1 cases                                                  #
    # ------------------------------------------------------------------ #
    def _on_clock(self, ts_r: int) -> None:
        """case: received logical clock tsR from MQTT."""
        if ts_r > self.ts:
            self.ts = ts_r
            if not self.syncing_state:
                self.syncing_state = True
                self._spawn(("fetch_state",))

    def _on_state(self, s: ClientStateSnapshot) -> None:
        """case: received new state s (from fetchState or submit)."""
        if s.ts >= self.ts:
            self.ts = s.ts
            self.tasks = s.tasks
            self._absorb_acks(s)
            if self.dirty_state:
                # results/statuses arrived while syncing: go again
                self.dirty_state = False
                self._spawn(("submit",))
            else:
                self.syncing_state = False
                self._spawn(("sync_containers", s))
        else:
            # Snapshot is stale w.r.t. a clock value we already saw over
            # MQTT — fetch again (paper Algorithm 1, trailing fetchState).
            self._spawn(("fetch_state",))

    def _on_container_event(
        self,
        task_id: str,
        result_value: Any = None,
        status: TaskStatus | None = None,
        log: str = "",
    ) -> None:
        """case: received result r or status s from container for task t."""
        if task_id in self.disk.done:
            return
        if result_value is not None:
            seq = self.disk.next_seq.get(task_id, 0)
            self.disk.next_seq[task_id] = seq + 1
            self.disk.unacked.setdefault(task_id, []).append(
                Result.create(task_id, seq, result_value)
            )
            if self._cols is not None:
                self._cols.unacked[self._row] += 1
        if status is not None:
            self.disk.terminal[task_id] = (status, log)
            lt = self.local_tasks.get(task_id)
            if lt is not None:
                lt.running = False
        if self.syncing_state:
            self.dirty_state = True
        else:
            self.syncing_state = True
            self._spawn(("submit",))

    # ------------------------------------------------------------------ #
    # spawned operations                                                 #
    # ------------------------------------------------------------------ #
    def _op_fetch_state(self) -> None:
        try:
            self._ensure_registered()
            s = self.server.fetch_state(self.client_id)
        except NetworkError:
            self.rpc_failures += 1
            self._spawn(("fetch_state",))  # retry until the link returns
            return
        self._on_state(s)

    def _op_submit(self) -> None:
        """Upload buffered results/statuses, then pull a fresh snapshot."""
        try:
            self._ensure_registered()
            for task_id in sorted(
                set(self.disk.unacked) | set(self.disk.terminal)
            ):
                if task_id in self.disk.done:
                    continue
                pending = list(self.disk.unacked.get(task_id, ()))
                status, log = self.disk.terminal.get(task_id, (None, ""))
                if not pending and status is None:
                    continue
                self.server.submit(task_id, pending, status, log)
            s = self.server.fetch_state(self.client_id)
        except NetworkError:
            self.rpc_failures += 1
            self._spawn(("submit",))  # results stay on disk; retry
            return
        self._on_state(s)

    def _absorb_acks(self, s: ClientStateSnapshot) -> None:
        """Prune locally-cached results the snapshot proves are recorded
        ("persists results locally until they are confirmed to be recorded
        in the database"), and resolve terminal-status acknowledgements."""
        active = {t.task_id: t for t in s.tasks}
        for task_id, info in active.items():
            if task_id in self.disk.unacked:
                self.disk.unacked[task_id] = [
                    r for r in self.disk.unacked[task_id] if r.seq >= info.results_count
                ]
                if not self.disk.unacked[task_id]:
                    del self.disk.unacked[task_id]
            # first sight of a task: seed the sequence counter
            if task_id not in self.disk.next_seq:
                self.disk.next_seq[task_id] = info.results_count
        # Tasks we reported terminal that are no longer active: the server
        # accepted the transition. Drop everything local.
        for task_id in list(self.disk.terminal):
            if task_id not in active:
                self.disk.terminal.pop(task_id, None)
                self.disk.unacked.pop(task_id, None)
                self.disk.next_seq.pop(task_id, None)
                self.disk.task_state.pop(task_id, None)  # removed on completion
                self.disk.done.add(task_id)
        # Tasks canceled/removed server-side while we were offline:
        for task_id in list(self.disk.unacked):
            if task_id not in active and task_id not in self.disk.terminal:
                self.disk.unacked.pop(task_id, None)
                self.disk.next_seq.pop(task_id, None)
                self.disk.done.add(task_id)
        self._recount_unacked()

    def _op_sync_containers(self, s: ClientStateSnapshot) -> None:
        """Start/stop containers to match the active task set."""
        active = {t.task_id: t for t in s.tasks}
        # stop containers for tasks no longer active (canceled or removed)
        for task_id, lt in list(self.local_tasks.items()):
            if task_id not in active:
                if lt.container is not None and lt.running:
                    lt.container.stop()
                del self.local_tasks[task_id]
        # start containers for new tasks
        for task_id, info in active.items():
            if task_id in self.local_tasks or task_id in self.disk.terminal:
                continue
            if task_id in self.disk.done:
                continue
            lt = _LocalTask(
                task_id=task_id,
                payload_id=info.payload_id,
                parameters_id=info.parameters_id,
                running=True,
            )
            self.local_tasks[task_id] = lt
            self._start_container(lt)

    # ------------------------------------------------------------------ #
    # containers                                                         #
    # ------------------------------------------------------------------ #
    def _fetch_payload_cached(self, payload_id: str):
        """Immutable documents are cached on disk (paper §3.4.1) — a cache
        hit avoids a server round-trip entirely."""
        if payload_id not in self.disk.payload_cache:
            self.disk.payload_cache[payload_id] = self.server.fetch_payload(
                payload_id
            )
        return self.disk.payload_cache[payload_id]

    def _fetch_parameters_cached(self, parameters_id: str | None):
        if parameters_id is None:
            return None
        if parameters_id not in self.disk.parameters_cache:
            self.disk.parameters_cache[parameters_id] = self.server.fetch_parameters(
                parameters_id
            )
        return self.disk.parameters_cache[parameters_id]

    def _make_context(self, task_id: str, parameters: Any) -> PayloadContext:
        def get_signal(name: str) -> float | None:
            if self.signal_handler is None:
                return None
            return self.signal_handler.get(name)

        def get_signal_window(name: str, k: int) -> list[float]:
            if self.signal_handler is None:
                return []
            return self.signal_handler.window(name, k)

        def get_signal_sketch(name, k, bins, lo, hi, quantile_k):
            if self.signal_handler is None:
                return None
            from repro_torch.kernels.sketch import SketchSpec

            return self.signal_handler.sketch(
                name,
                SketchSpec(
                    window=max(1, k), bins=bins, lo=lo, hi=hi,
                    quantile_k=quantile_k,
                ),
            )

        def publish(value: Any) -> None:
            self._emit_container_event((task_id, value, None, ""))

        return PayloadContext(
            get_signal=get_signal,
            get_signal_window=get_signal_window,
            get_signal_sketch=get_signal_sketch,
            publish=publish,
            parameters=parameters,
            state_cache=self.disk.task_state,
            task_key=task_id,
        )

    def _start_container(self, lt: _LocalTask) -> None:
        try:
            payload = self._fetch_payload_cached(lt.payload_id)
            parameters = self._fetch_parameters_cached(lt.parameters_id)
        except NetworkError:
            self.rpc_failures += 1
            # Could not pull the payload — leave the task for the next
            # sync_containers pass (triggered by the retry fetch).
            del self.local_tasks[lt.task_id]
            if not self.syncing_state:
                self.syncing_state = True
                self._spawn(("fetch_state",))
            return
        ctx = self._make_context(lt.task_id, parameters.value if parameters else None)

        def on_exit(exit: sandbox.ContainerExit) -> None:
            if exit.canceled:
                # user-canceled: server already moved the task out of
                # ACTIVE; nothing to upload.
                return
            status = TaskStatus.FINISHED if exit.ok else TaskStatus.ERROR
            self._emit_container_event(
                (lt.task_id, None, status, exit.log if not exit.ok else "")
            )

        if self._thread_containers:
            lt.container = sandbox.ContainerThread(
                payload.source, ctx, on_exit, self._limits
            )
            lt.container.start()
        else:
            exit = sandbox.run_inline(payload.source, ctx, self._limits)
            lt.running = False
            on_exit(exit)
