"""The user library (paper §5.2): `User`, document builders, method
chaining, and streaming/await result retrieval.

Mirrors the paper's workflow::

    user    = User(server, broker)
    payload = user.payload(source)
    params  = user.parameter({"seconds": 5, "signal_name": name})
    tasks   = [user.task(c, payload, params) for c in user.online_clients()]
    assign  = user.assignment("Mean speed", tasks)
    results = assign.commit().await_results(pump)

Documents are *builders* until `commit()` — nothing touches the database
before that, matching "this payload object has not yet been committed".
`await_results`/`stream` consume the AMQP-style topics the server publishes
result/status updates on; `results()` is the on-demand retrieval path.

Because the whole platform is simulated in-process, blocking waits take a
`pump` callable that advances the world (delivers broker messages, steps
clients). Live deployments would simply block on the queue.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

from repro_torch.core.broker import (
    Broker,
    assignment_results_topic,
    assignment_status_topic,
)
from repro_torch.core.documents import TaskStatus

TERMINAL = {TaskStatus.FINISHED, TaskStatus.ERROR, TaskStatus.CANCELED}
_TERMINAL_VALUES = {s.value for s in TERMINAL}


@dataclass(frozen=True)
class TaskCounts:
    """O(1) snapshot of an assignment's task lifecycle — maintained by
    status *events* (the broker's status stream), never by re-scanning
    every task. `pump_until_deadline` closes rounds on these."""

    finished: int = 0
    error: int = 0
    canceled: int = 0
    active: int = 0

    @property
    def terminal(self) -> int:
        return self.finished + self.error + self.canceled


@dataclass
class PayloadDoc:
    user: "User"
    source: str
    name: str = ""
    payload_id: str | None = None

    def commit(self) -> "PayloadDoc":
        if self.payload_id is None:
            self.payload_id = self.user.server.create_payload(
                self.source, self.name
            ).payload_id
        return self


@dataclass
class ParametersDoc:
    user: "User"
    value: Any
    parameters_id: str | None = None

    def commit(self) -> "ParametersDoc":
        if self.parameters_id is None:
            self.parameters_id = self.user.server.create_parameters(
                self.value
            ).parameters_id
        return self


@dataclass
class TaskDoc:
    user: "User"
    client_id: str
    payload: PayloadDoc
    parameters: ParametersDoc | None = None
    task_id: str | None = None


@dataclass
class AssignmentDoc:
    user: "User"
    name: str
    tasks: list[TaskDoc]
    assignment_id: str | None = None
    _results_sub: Any = field(default=None, repr=False)
    _status_sub: Any = field(default=None, repr=False)
    #: task_id -> terminal status value, folded in from status events; the
    #: dict makes the fold idempotent under QoS-1 redeliveries
    _terminal: dict = field(default_factory=dict, repr=False)
    _n_finished: int = field(default=0, repr=False)
    _n_error: int = field(default=0, repr=False)
    _n_canceled: int = field(default=0, repr=False)
    _task_ids: set = field(default_factory=set, repr=False)

    # ------------------------------------------------------------------ #
    def commit(self) -> "AssignmentDoc":
        """Commit the assignment and every related uncommitted document
        (paper: 'including all related documents if they have not been
        committed yet'). Subscribes to result/status streams *before* the
        tasks become visible so no update can be missed."""
        if self.assignment_id is not None:
            return self
        for t in self.tasks:
            t.payload.commit()
            if t.parameters is not None:
                t.parameters.commit()
        specs = [
            (
                t.client_id,
                t.payload.payload_id,
                t.parameters.parameters_id if t.parameters else None,
            )
            for t in self.tasks
        ]
        # Pre-subscribe with a wildcard: the assignment id is not known
        # until creation, but subscribing before task visibility matters
        # more; we filter by assignment afterwards. The subscriptions are
        # `reliable` — the user's AMQP queue sits next to the server, so
        # the vehicle-link delay faults don't apply (duplicates still do:
        # the terminal fold below is idempotent per task).
        results_sub = self.user.broker.subscribe(
            "assignments/*/results", qos=1, reliable=True
        )
        status_sub = self.user.broker.subscribe(
            "assignments/*/status", qos=1, reliable=True
        )
        assignment = self.user.server.create_assignment(self.name, specs)
        self.assignment_id = assignment.assignment_id
        for t, task_id in zip(self.tasks, assignment.task_ids):
            t.task_id = task_id
        self._results_sub = results_sub
        self._status_sub = status_sub
        self._task_ids = {t.task_id for t in self.tasks}
        # every FINISHED/ERROR/CANCELED transition lands here the moment
        # the server publishes it — counts() never rebuilds statuses
        status_sub.wake = self._absorb_status_events
        self._absorb_status_events()
        return self

    # ------------------------------------------------------------------ #
    def _my_topic(self, kind: str) -> str:
        assert self.assignment_id is not None
        return (
            assignment_results_topic(self.assignment_id)
            if kind == "results"
            else assignment_status_topic(self.assignment_id)
        )

    def stream_results(self) -> Iterator[dict]:
        """Lazy iterator over result messages received so far."""
        topic = self._my_topic("results")
        for msg in self._results_sub.drain():
            if msg.topic == topic:
                yield msg.value

    def statuses(self) -> dict[str, str]:
        """Current task statuses via a bulk server re-scan — O(n_tasks)
        per call. Deprecated on hot paths (the parity oracles and tests
        keep using it); drivers close rounds on `counts()` instead."""
        out = {}
        for t in self.tasks:
            assert t.task_id is not None
            out[t.task_id] = self.user.server.task(t.task_id).status.value
        return out

    # -- event-maintained lifecycle counters --------------------------- #
    def _absorb_status_events(self) -> None:
        """Fold pending status messages into the per-task terminal dict.
        Runs from the subscription's `wake` hook, i.e. synchronously with
        the store transition (reliable sub), so the counters never lag the
        server truth. Idempotent: duplicates and foreign assignments'
        wildcard-matched messages are discarded."""
        sub = self._status_sub
        if sub is None:
            return
        topic = self._my_topic("status")
        for msg in sub.drain():
            if msg.topic != topic:
                continue
            v = msg.value
            tid, status = v["task_id"], v["status"]
            if tid not in self._task_ids or tid in self._terminal:
                continue
            if status not in _TERMINAL_VALUES:
                continue
            self._terminal[tid] = status
            if status == TaskStatus.FINISHED.value:
                self._n_finished += 1
            elif status == TaskStatus.ERROR.value:
                self._n_error += 1
            else:
                self._n_canceled += 1

    def counts(self) -> TaskCounts:
        """O(1) lifecycle counters (finished/error/canceled/active),
        maintained by status events — the hot-path replacement for
        `statuses()` scans in `pump_until_deadline`/`await_results`."""
        assert self.assignment_id is not None, "commit() first"
        done = self._n_finished + self._n_error + self._n_canceled
        return TaskCounts(
            finished=self._n_finished,
            error=self._n_error,
            canceled=self._n_canceled,
            active=len(self.tasks) - done,
        )

    def await_results(
        self,
        pump: Callable[[], None],
        max_pumps: int = 100_000,
    ) -> dict[str, list[Any]]:
        """Wait for all tasks to finish, then return all results
        (paper §5.2.1's `assign.commit().await_results()`).

        `pump()` advances the simulated world one step; a real deployment
        would block on the AMQP queue instead."""
        assert self.assignment_id is not None, "commit() first"
        for _ in range(max_pumps):
            if self.counts().active == 0:
                return self.results()
            pump()
        raise TimeoutError("assignment did not finish")

    def results(self) -> dict[str, list[Any]]:
        """On-demand retrieval of every recorded result per task."""
        out: dict[str, list[Any]] = {}
        for t in self.tasks:
            assert t.task_id is not None
            out[t.task_id] = [
                r.value for r in self.user.server.results(t.task_id)
            ]
        return out

    def cancel(self) -> int:
        n = 0
        for t in self.tasks:
            assert t.task_id is not None
            n += bool(self.user.server.cancel_task(t.task_id))
        return n


class User:
    """Entry point for everything a user does (paper §5.2: 'provides the
    User class through which all actions to the server are made')."""

    def __init__(self, server: Any, broker: Broker):
        self.server = server
        self.broker = broker

    def online_clients(self) -> list[str]:
        return self.server.online_clients()

    def payload(self, source: str, name: str = "") -> PayloadDoc:
        return PayloadDoc(self, source, name)

    def parameter(self, value: Any) -> ParametersDoc:
        return ParametersDoc(self, value)

    def task(
        self,
        client_id: str,
        payload: PayloadDoc,
        parameters: ParametersDoc | None = None,
    ) -> TaskDoc:
        return TaskDoc(self, client_id, payload, parameters)

    def assignment(self, name: str, tasks: list[TaskDoc]) -> AssignmentDoc:
        return AssignmentDoc(self, name, tasks)
