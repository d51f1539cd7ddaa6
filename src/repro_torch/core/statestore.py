"""Centralized, versioned application-state store.

Plays the role MongoDB plays in the paper (§3.2.1): the single source of
truth that stateless servers read/modify per request. We reproduce the
properties the paper *relies on* rather than the wire protocol:

* per-client **logical clocks** (Lamport-style revision counters, §4.2.1):
  every mutation that affects a client increments that client's clock;
* **multi-document transactions** (§3.2.1 "distributed transactions are
  essential to the integrity of the platform"): `transaction()` applies a
  batch of mutations atomically — observers never see a torn write;
* **idempotent result ingestion**: results are keyed (task_id, seq) so
  retries after lost acks (the paper's intermittent-connectivity case)
  cannot duplicate data;
* **immutability** of payload/parameter documents → safe client caching.

The store is deliberately process-local; `repro_torch.core.server` keeps the
server tier stateless exactly as the paper prescribes, so pointing it at a
real MongoDB is an I/O swap, not a redesign.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, replace
from typing import Any, Callable, Iterable

from repro_torch.core.columns import FleetColumns
from repro_torch.core.documents import (
    Assignment,
    InvalidTransition,
    Parameters,
    Payload,
    Result,
    Task,
    TaskStatus,
)


class DocumentExists(Exception):
    pass


class NoSuchDocument(Exception):
    pass


class StaleWrite(Exception):
    """Optimistic-concurrency failure inside a transaction."""


class ClientRecord:
    """Per-client registry row. Slim slotted layout: when the store is
    attached to a `FleetColumns` arena the logical clock and online flag
    live in the shared numpy columns (one int64/bool per client fleet-wide
    instead of a dict slot per object); detached records (unit tests, bare
    stores) fall back to local scalars. Either way the attribute API is
    unchanged — `rec.logical_clock += 1` works identically."""

    __slots__ = ("client_id", "metadata", "_cols", "_row", "_clock", "_online")

    def __init__(
        self,
        client_id: str,
        logical_clock: int = 0,
        online: bool = True,
        metadata: dict[str, Any] | None = None,
    ):
        self.client_id = client_id
        self.metadata = {} if metadata is None else metadata
        self._cols: FleetColumns | None = None
        self._row = -1
        self._clock = int(logical_clock)
        self._online = bool(online)

    def bind(self, cols: FleetColumns) -> None:
        """Move this record's scalars into the shared arena."""
        row = cols.row_for(self.client_id)
        cols.clock[row] = self._clock
        cols.online[row] = self._online
        self._cols, self._row = cols, row

    @property
    def logical_clock(self) -> int:
        if self._cols is not None:
            return int(self._cols.clock[self._row])
        return self._clock

    @logical_clock.setter
    def logical_clock(self, value: int) -> None:
        if self._cols is not None:
            self._cols.clock[self._row] = value
        else:
            self._clock = int(value)

    @property
    def online(self) -> bool:
        if self._cols is not None:
            return bool(self._cols.online[self._row])
        return self._online

    @online.setter
    def online(self, value: bool) -> None:
        if self._cols is not None:
            self._cols.online[self._row] = value
        else:
            self._online = bool(value)

    def __repr__(self) -> str:  # debugging parity with the old dataclass
        return (
            f"ClientRecord(client_id={self.client_id!r}, "
            f"logical_clock={self.logical_clock}, online={self.online}, "
            f"metadata={self.metadata!r})"
        )


class StateStore:
    """Thread-safe in-memory document store with per-client logical clocks.

    A single lock guards each transaction — the in-process stand-in for
    MongoDB's multi-document ACID transactions. All public mutators go
    through `transaction()` so the atomicity claim is structural, not
    conventional.
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        #: optional shared columnar arena for per-client scalars
        self._columns: FleetColumns | None = None
        self._payloads: dict[str, Payload] = {}
        self._parameters: dict[str, Parameters] = {}
        self._tasks: dict[str, Task] = {}
        #: client_id -> ids of that client's possibly-ACTIVE tasks. Kept so
        #: `fetch_state` is O(client's tasks), not O(all tasks ever) — the
        #: difference between O(fleet) and O(fleet^2) per simulated round.
        #: Pruned lazily when a listed task turns out terminal.
        self._active_by_client: dict[str, list[str]] = {}
        self._assignments: dict[str, Assignment] = {}
        self._results: dict[str, list[Result]] = {}  # task_id -> dense list
        self._clients: dict[str, ClientRecord] = {}
        self._watchers: list[Callable[[str, int], None]] = []

    # ------------------------------------------------------------------ #
    # transactions                                                       #
    # ------------------------------------------------------------------ #
    def transaction(self, fn: Callable[["StateStore"], Any]) -> Any:
        """Run `fn(store)` atomically. Mutations inside `fn` must use the
        underscore-free helpers below. On exception nothing is observed
        half-applied (helpers mutate only after validation; the lock keeps
        readers out for the duration)."""
        with self._lock:
            return fn(self)

    # ------------------------------------------------------------------ #
    # clients + logical clocks                                           #
    # ------------------------------------------------------------------ #
    def attach_columns(self, cols: FleetColumns) -> None:
        """Bind this store to a shared `FleetColumns` arena: existing and
        future `ClientRecord`s keep their clocks/online flags in the
        arena's numpy columns (fleet-wide gauges become one reduction)."""
        with self._lock:
            self._columns = cols
            for rec in self._clients.values():
                rec.bind(cols)

    @property
    def columns(self) -> FleetColumns | None:
        return self._columns

    def register_client(
        self, client_id: str, metadata: dict[str, Any] | None = None
    ) -> ClientRecord:
        with self._lock:
            rec = self._clients.get(client_id)
            if rec is None:
                rec = ClientRecord(client_id=client_id, metadata=metadata or {})
                if self._columns is not None:
                    rec.bind(self._columns)
                self._clients[client_id] = rec
            elif metadata:
                rec.metadata.update(metadata)
            rec.online = True
            return rec

    def set_online(self, client_id: str, online: bool) -> None:
        with self._lock:
            self._require_client(client_id).online = online

    def doc_counts(self) -> dict[str, int]:
        """O(1) platform-inventory gauge: how many documents of each kind
        the store holds (``result_streams`` = tasks with >= 1 recorded
        result). The serve gateway's ``platform`` query reads this — dict
        `len` is constant-time, so the read never scans a collection."""
        with self._lock:
            return {
                "clients": len(self._clients),
                "payloads": len(self._payloads),
                "parameters": len(self._parameters),
                "assignments": len(self._assignments),
                "tasks": len(self._tasks),
                "result_streams": len(self._results),
            }

    def online_clients(self) -> list[str]:
        with self._lock:
            return sorted(c.client_id for c in self._clients.values() if c.online)

    def clients(self) -> list[ClientRecord]:
        with self._lock:
            return list(self._clients.values())

    def logical_clock(self, client_id: str) -> int:
        with self._lock:
            return self._require_client(client_id).logical_clock

    def _require_client(self, client_id: str) -> ClientRecord:
        rec = self._clients.get(client_id)
        if rec is None:
            raise NoSuchDocument(f"client {client_id}")
        return rec

    def _bump_clock(self, client_id: str) -> int:
        rec = self.register_client(client_id)
        rec.logical_clock += 1
        for w in list(self._watchers):
            w(client_id, rec.logical_clock)
        return rec.logical_clock

    def watch_clocks(self, fn: Callable[[str, int], None]) -> None:
        """Register a clock-change observer (the server uses this to push
        MQTT notifications)."""
        self._watchers.append(fn)

    # ------------------------------------------------------------------ #
    # document creation (user-initiated)                                 #
    # ------------------------------------------------------------------ #
    def put_payload(self, payload: Payload) -> Payload:
        with self._lock:
            if payload.payload_id in self._payloads:
                raise DocumentExists(payload.payload_id)
            self._payloads[payload.payload_id] = payload
            return payload

    def put_parameters(self, parameters: Parameters) -> Parameters:
        with self._lock:
            if parameters.parameters_id in self._parameters:
                raise DocumentExists(parameters.parameters_id)
            self._parameters[parameters.parameters_id] = parameters
            return parameters

    def put_assignment(
        self, assignment: Assignment, tasks: Iterable[Task]
    ) -> Assignment:
        """Atomically create an assignment with its tasks; bumps each target
        client's clock (task creation is a client-visible change)."""

        def txn(store: "StateStore") -> Assignment:
            tasks_list = list(tasks)
            if assignment.assignment_id in store._assignments:
                raise DocumentExists(assignment.assignment_id)
            for t in tasks_list:
                if t.task_id in store._tasks:
                    raise DocumentExists(t.task_id)
                if t.payload_id not in store._payloads:
                    raise NoSuchDocument(f"payload {t.payload_id}")
                if t.parameters_id and t.parameters_id not in store._parameters:
                    raise NoSuchDocument(f"parameters {t.parameters_id}")
            store._assignments[assignment.assignment_id] = assignment
            for t in tasks_list:
                store._tasks[t.task_id] = t
                store._results[t.task_id] = []
                store._active_by_client.setdefault(t.client_id, []).append(
                    t.task_id
                )
                store._bump_clock(t.client_id)
            return assignment

        return self.transaction(txn)

    # ------------------------------------------------------------------ #
    # task state (client- or user-initiated)                             #
    # ------------------------------------------------------------------ #
    def get_task(self, task_id: str) -> Task:
        with self._lock:
            t = self._tasks.get(task_id)
            if t is None:
                raise NoSuchDocument(f"task {task_id}")
            return t

    def get_payload(self, payload_id: str) -> Payload:
        with self._lock:
            p = self._payloads.get(payload_id)
            if p is None:
                raise NoSuchDocument(f"payload {payload_id}")
            return p

    def get_parameters(self, parameters_id: str) -> Parameters:
        with self._lock:
            p = self._parameters.get(parameters_id)
            if p is None:
                raise NoSuchDocument(f"parameters {parameters_id}")
            return p

    def get_assignment(self, assignment_id: str) -> Assignment:
        with self._lock:
            a = self._assignments.get(assignment_id)
            if a is None:
                raise NoSuchDocument(f"assignment {assignment_id}")
            return a

    def active_tasks_for(self, client_id: str) -> list[Task]:
        with self._lock:
            ids = self._active_by_client.get(client_id)
            if not ids:
                return []
            active = [
                t
                for i in ids
                if (t := self._tasks[i]).status == TaskStatus.ACTIVE
            ]
            if len(active) != len(ids):  # lazy prune of terminal tasks
                self._active_by_client[client_id] = [
                    t.task_id for t in active
                ]
            return sorted(active, key=lambda t: t.task_id)

    def submit_results(
        self,
        task_id: str,
        results: Iterable[Result],
        status: TaskStatus | None = None,
        error_log: str = "",
    ) -> int:
        """Client upload path. Atomic; idempotent on (task_id, seq).

        Per paper §4.1.1 the server only accepts results/status changes for
        ACTIVE tasks — anything else is *ignored* (returns 0), not an error:
        the client may legitimately race a user's cancel.
        Returns the number of newly recorded results.
        """

        def txn(store: "StateStore") -> int:
            task = store._tasks.get(task_id)
            if task is None:
                raise NoSuchDocument(f"task {task_id}")
            if task.status != TaskStatus.ACTIVE:
                return 0
            stored = store._results[task_id]
            accepted = 0
            for r in sorted(results, key=lambda r: r.seq):
                if r.task_id != task_id:
                    raise ValueError("result/task mismatch")
                if r.seq < len(stored):
                    continue  # duplicate retry — idempotent
                if r.seq != len(stored):
                    raise StaleWrite(
                        f"gap in result sequence for {task_id}: "
                        f"got {r.seq}, expected {len(stored)}"
                    )
                stored.append(r)
                accepted += 1
            new_task = task
            if accepted:
                new_task = replace(new_task, results_count=len(stored))
            if status is not None and status != TaskStatus.ACTIVE:
                new_task = new_task.with_status(status)
                if status == TaskStatus.ERROR and error_log:
                    new_task = replace(new_task, error_log=error_log)
            if new_task is not task:
                store._tasks[task_id] = new_task
                store._bump_clock(task.client_id)
            return accepted

        return self.transaction(txn)

    def cancel_task(self, task_id: str) -> bool:
        """User-initiated cancel. Only ACTIVE tasks can be canceled
        (paper §4.1.1); canceling a finished task is a no-op -> False."""

        def txn(store: "StateStore") -> bool:
            task = store._tasks.get(task_id)
            if task is None:
                raise NoSuchDocument(f"task {task_id}")
            if task.status != TaskStatus.ACTIVE:
                return False
            try:
                store._tasks[task_id] = task.with_status(TaskStatus.CANCELED)
            except InvalidTransition:
                return False
            store._bump_clock(task.client_id)
            return True

        return self.transaction(txn)

    def results_for(self, task_id: str, since_seq: int = 0) -> list[Result]:
        with self._lock:
            if task_id not in self._results:
                raise NoSuchDocument(f"task {task_id}")
            return list(self._results[task_id][since_seq:])

    # ------------------------------------------------------------------ #
    # client sync snapshot                                               #
    # ------------------------------------------------------------------ #
    def client_state(self, client_id: str) -> "ClientStateSnapshot":
        """What `fetchState` returns (paper §4.2.1): the client's current
        logical clock and all its ACTIVE tasks with result counts."""
        with self._lock:
            rec = self._require_client(client_id)
            tasks = self.active_tasks_for(client_id)
            return ClientStateSnapshot(
                client_id=client_id,
                ts=rec.logical_clock,
                tasks=tuple(
                    TaskSyncInfo(
                        task_id=t.task_id,
                        payload_id=t.payload_id,
                        parameters_id=t.parameters_id,
                        results_count=t.results_count,
                    )
                    for t in tasks
                ),
            )


@dataclass(frozen=True, slots=True)
class TaskSyncInfo:
    task_id: str
    payload_id: str
    parameters_id: str | None
    results_count: int


@dataclass(frozen=True, slots=True)
class ClientStateSnapshot:
    client_id: str
    ts: int
    tasks: tuple[TaskSyncInfo, ...]
