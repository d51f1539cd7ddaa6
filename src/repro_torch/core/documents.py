"""Application-state data model (paper Fig. 3).

Users create *assignments* containing a set of *tasks*. Tasks reference
their assignment, a *payload* (the code to be executed), optional
*parameters*, and the ID of the client the task is intended for.

Task lifecycle (paper §4.1.1): tasks are ACTIVE upon creation and the only
valid transitions are ACTIVE -> {FINISHED, ERROR, CANCELED}. The server
ignores results submitted for non-active tasks.
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
from repro_torch.core.counter import Counter
import json
from typing import Any, Mapping


class TaskStatus(str, enum.Enum):
    ACTIVE = "ACTIVE"
    FINISHED = "FINISHED"
    ERROR = "ERROR"
    CANCELED = "CANCELED"


#: The only transitions the state machine accepts (paper §4.1.1).
VALID_TRANSITIONS: Mapping[TaskStatus, frozenset[TaskStatus]] = {
    TaskStatus.ACTIVE: frozenset(
        {TaskStatus.FINISHED, TaskStatus.ERROR, TaskStatus.CANCELED}
    ),
    TaskStatus.FINISHED: frozenset(),
    TaskStatus.ERROR: frozenset(),
    TaskStatus.CANCELED: frozenset(),
}


def is_valid_transition(src: TaskStatus, dst: TaskStatus) -> bool:
    return dst in VALID_TRANSITIONS[src]


_ids = Counter()


def new_id(prefix: str) -> str:
    """Process-unique monotone document ids.

    Monotone (not random) ids matter twice at fleet scale: clients iterate
    pending uploads in sorted-id order, so random ids made the broker
    message interleaving — and with it any seeded fault schedule —
    irreproducible run to run; and uuid4's urandom call showed up in
    profiles of 1000-client simulations. Zero-padded hex keeps
    lexicographic order == creation order."""
    return f"{prefix}-{next(_ids):012x}"


def _json_canonical(value: Any) -> str:
    return json.dumps(value, sort_keys=True, separators=(",", ":"), default=str)


@dataclasses.dataclass(frozen=True, slots=True)
class Payload:
    """Immutable code document. Immutability (paper §3.4.1) is what makes
    client-side payload caching sound: the digest is the cache key."""

    payload_id: str
    source: str  # python source of the payload ("general Python scripts")
    name: str = ""

    @property
    def digest(self) -> str:
        return hashlib.sha256(self.source.encode()).hexdigest()

    @staticmethod
    def create(source: str, name: str = "") -> "Payload":
        return Payload(payload_id=new_id("pay"), source=source, name=name)


@dataclasses.dataclass(frozen=True, slots=True)
class Parameters:
    """Optional JSON-serializable value readable by the payload via the
    client library (paper §4.1) — e.g. distribute a model to many clients
    or point the same payload at different signal names per client."""

    parameters_id: str
    value_json: str

    @property
    def value(self) -> Any:
        return json.loads(self.value_json)

    @staticmethod
    def create(value: Any) -> "Parameters":
        return Parameters(
            parameters_id=new_id("par"), value_json=_json_canonical(value)
        )


@dataclasses.dataclass(frozen=True, slots=True)
class Task:
    """Client-specific unit of work. `results_count` mirrors the paper's
    sync-state summary ("each task has an ID and the number of results
    submitted")."""

    task_id: str
    assignment_id: str
    client_id: str
    payload_id: str
    parameters_id: str | None
    status: TaskStatus = TaskStatus.ACTIVE
    results_count: int = 0
    error_log: str = ""

    def with_status(self, status: TaskStatus) -> "Task":
        if not is_valid_transition(self.status, status):
            raise InvalidTransition(self.status, status)
        return dataclasses.replace(self, status=status)


class InvalidTransition(Exception):
    def __init__(self, src: TaskStatus, dst: TaskStatus):
        super().__init__(f"invalid task transition {src.value} -> {dst.value}")
        self.src, self.dst = src, dst


@dataclasses.dataclass(frozen=True, slots=True)
class Assignment:
    """Groups related tasks; every task needs an assignment (paper §5.2.1)."""

    assignment_id: str
    name: str
    task_ids: tuple[str, ...]


@dataclasses.dataclass(frozen=True, slots=True)
class Result:
    """A single published result for a task. `seq` is the per-task result
    sequence number (dense, starting at 0) — it is what makes result upload
    idempotent: re-submitting (task_id, seq) is a no-op."""

    task_id: str
    seq: int
    value_json: str

    @property
    def value(self) -> Any:
        return json.loads(self.value_json)

    @staticmethod
    def create(task_id: str, seq: int, value: Any) -> "Result":
        return Result(task_id=task_id, seq=seq, value_json=_json_canonical(value))
