"""Stateless server tier (paper §3.2).

Every public method reads the state it needs from the store, mutates it
transactionally, and returns — no state is retained between requests, so
any number of `Server` instances over the same store behave identically
(horizontal scaling). The tests exercise this by round-robining requests
over several instances.

Responsibilities (paper §4): persist user-created documents, serve client
`fetchState`/`submit` (the gRPC surface), and emit
  * per-client MQTT clock notifications (via `StateStore.watch_clocks`),
  * per-assignment AMQP result/status streams for users.
"""
from __future__ import annotations

from typing import Any, Iterable, Sequence

from repro_torch.core.broker import (
    Broker,
    assignment_results_topic,
    assignment_status_topic,
    client_clock_topic,
)
from repro_torch.core.documents import (
    Assignment,
    Parameters,
    Payload,
    Result,
    Task,
    TaskStatus,
    new_id,
)
from repro_torch.core.statestore import ClientStateSnapshot, StateStore


class Server:
    """One stateless server instance. Construct as many as you like over
    the same (store, broker) pair."""

    def __init__(self, store: StateStore, broker: Broker):
        self._store = store
        self._broker = broker

    # -------------------------------------------------------------- #
    # user-facing API (wrapped by repro_torch.core.user)                    #
    # -------------------------------------------------------------- #
    def create_payload(self, source: str, name: str = "") -> Payload:
        return self._store.put_payload(Payload.create(source, name))

    def create_parameters(self, value: Any) -> Parameters:
        return self._store.put_parameters(Parameters.create(value))

    def create_assignment(
        self,
        name: str,
        specs: Sequence[tuple[str, str, str | None]],
    ) -> Assignment:
        """specs: (client_id, payload_id, parameters_id|None) per task."""
        assignment_id = new_id("asg")
        tasks = [
            Task(
                task_id=new_id("tsk"),
                assignment_id=assignment_id,
                client_id=client_id,
                payload_id=payload_id,
                parameters_id=parameters_id,
            )
            for client_id, payload_id, parameters_id in specs
        ]
        assignment = Assignment(
            assignment_id=assignment_id,
            name=name,
            task_ids=tuple(t.task_id for t in tasks),
        )
        return self._store.put_assignment(assignment, tasks)

    def cancel_task(self, task_id: str) -> bool:
        ok = self._store.cancel_task(task_id)
        if ok:
            # fan the terminal transition out on the status stream, exactly
            # like `submit` does for FINISHED/ERROR: event-driven consumers
            # (AssignmentDoc.counts) must see every lifecycle edge
            task = self._store.get_task(task_id)
            self._broker.publish(
                assignment_status_topic(task.assignment_id),
                {"task_id": task_id, "status": task.status.value},
                qos=1,
            )
        return ok

    def online_clients(self) -> list[str]:
        return self._store.online_clients()

    def task(self, task_id: str) -> Task:
        return self._store.get_task(task_id)

    def assignment(self, assignment_id: str) -> Assignment:
        return self._store.get_assignment(assignment_id)

    def results(self, task_id: str, since_seq: int = 0) -> list[Result]:
        return self._store.results_for(task_id, since_seq)

    # -------------------------------------------------------------- #
    # client-facing API (the client gRPC surface)                     #
    # -------------------------------------------------------------- #
    def register_client(
        self, client_id: str, metadata: dict[str, Any] | None = None
    ) -> int:
        rec = self._store.register_client(client_id, metadata)
        return rec.logical_clock

    def fetch_state(self, client_id: str) -> ClientStateSnapshot:
        return self._store.client_state(client_id)

    def fetch_payload(self, payload_id: str) -> Payload:
        return self._store.get_payload(payload_id)

    def fetch_parameters(self, parameters_id: str) -> Parameters:
        return self._store.get_parameters(parameters_id)

    def submit(
        self,
        task_id: str,
        results: Iterable[Result],
        status: TaskStatus | None = None,
        error_log: str = "",
    ) -> int:
        """Client upload. Also fans accepted results / terminal statuses out
        to the user-facing AMQP streams."""
        results = list(results)
        task_before = self._store.get_task(task_id)
        accepted = self._store.submit_results(task_id, results, status, error_log)
        task_after = self._store.get_task(task_id)
        if accepted:
            base = task_before.results_count
            topic = assignment_results_topic(task_after.assignment_id)
            for r in results:
                if r.seq >= base:
                    self._broker.publish(
                        topic,
                        {"task_id": task_id, "seq": r.seq, "value": r.value},
                        qos=1,
                    )
        if task_after.status != task_before.status:
            self._broker.publish(
                assignment_status_topic(task_after.assignment_id),
                {"task_id": task_id, "status": task_after.status.value},
                qos=1,
            )
        return accepted


def make_platform(
    broker: Broker | None = None,
    store: StateStore | None = None,
    n_servers: int = 1,
) -> tuple[StateStore, Broker, list[Server]]:
    """Wire up a platform: store + broker + N stateless server instances.

    Installs the clock watcher that publishes the minimal MQTT notification
    (just the revision number) on every client-visible state change —
    paper §4: "The state update notification is a running count of the
    state revision for the individual client."
    """
    store = store or StateStore()
    broker = broker or Broker()

    def notify(client_id: str, clock: int) -> None:
        broker.publish(client_clock_topic(client_id), clock, qos=0)

    store.watch_clocks(notify)
    servers = [Server(store, broker) for _ in range(max(1, n_servers))]
    return store, broker, servers
