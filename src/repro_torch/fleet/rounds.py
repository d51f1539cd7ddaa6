"""Platform-driven federated rounds.

One round == one AutoSPADA assignment (DESIGN.md §2):

1. the user commits an assignment whose tasks carry the current global
   model in the Parameters document (paper §4.1: "distribute a model to
   many clients");
2. each online vehicle's task container trains locally on data derived
   from its signals and publishes a quantized delta as an ordinary result;
3. the driver awaits the deadline fraction of FINISHED tasks, cancels the
   stragglers (only ACTIVE tasks can be canceled — the lifecycle rules do
   the bookkeeping), and FedAvg-aggregates what arrived.

Deltas travel as base64-packed int8 + scales inside JSON results — the
same network-budget discipline the paper applies with protobuf/MQTT.
"""
from __future__ import annotations

import base64
import dataclasses
import math
from typing import Any, Callable

import numpy as np

from repro_torch.core.documents import TaskStatus
from repro_torch.core.user import AssignmentDoc, User
from repro_torch.fleet.federated import FEDERATED_PENDING, FedConfig


# --------------------------------------------------------------------- #
# shared deadline-driven assignment pump (FedAvg rounds, analytics       #
# windows — every platform workload closes rounds the same way)          #
# --------------------------------------------------------------------- #
class DeadlinePump:
    """Resumable deadline-driven assignment pump.

    Pumps the world until `need` tasks are FINISHED, every task is
    terminal, or the deadline passes (the paper's wall-clock round
    deadline: close on time with whatever arrived).

    The quorum check reads `AssignmentDoc.counts()` — O(1) counters
    maintained by status events — never a per-pump `statuses()` rebuild.
    With an `engine`, the deadline itself is a heap entry: the round
    closes when the timer fires (identical to the pump budget whenever
    one pump == one tick, i.e. every driver in this repo).
    `status_oracle=True` restores the dense per-pump statuses() scan —
    the parity oracle the engine path is tested against bit-for-bit.

    `on_counts` (if given) sees every per-pump `TaskCounts` snapshot —
    the free live-progress feed (`FleetMetrics.update_progress`): the
    quorum check already holds the counters, so gauges cost zero extra
    store scans. The oracle branch feeds it from its statuses() scan,
    keeping the two paths observationally identical.

    The pump is an explicit object (not a loop) so a round can be
    suspended *mid-flight*: `step()` advances one pump and reports
    whether the round closed, and all progress lives in plain fields
    (`pumps`, `closed`, `deadline`) that `repro.fleet.checkpoint`
    snapshots and restores bit-for-bit."""

    def __init__(
        self,
        assign: AssignmentDoc,
        n_tasks: int,
        *,
        need: int,
        budget: int | None,
        pump: Callable[[], None],
        engine: Any = None,
        status_oracle: bool = False,
        on_counts: Callable[[Any], None] | None = None,
    ):
        self.assign = assign
        self.n_tasks = n_tasks
        self.need = need
        self.budget = budget
        self.pump = pump
        self.engine = engine
        self.status_oracle = status_oracle
        self.on_counts = on_counts
        self.hard = budget if budget is not None else 100_000
        self.pumps = 0
        self.closed = False
        self.deadline = None
        if not status_oracle and engine is not None and budget is not None:
            self.deadline = engine.schedule(engine.now + budget)

    def step(self) -> bool:
        """One pump of the world plus one quorum check. Returns True once
        the round is closed (idempotent after that)."""
        if self.closed:
            return True
        if self.status_oracle:
            return self._step_oracle()
        self.pumps += 1
        self.pump()
        c = self.assign.counts()
        if self.on_counts is not None:
            self.on_counts(c)
        if c.finished >= self.need or c.active == 0:
            if self.deadline is not None:
                self.deadline.cancel()
            self.closed = True
        elif self.deadline is not None:
            if self.deadline.fired:
                self.closed = True
        elif self.pumps >= self.hard:
            if self.budget is None:  # pragma: no cover
                raise TimeoutError(
                    "assignment did not reach its deadline quorum"
                )
            self.closed = True
        return self.closed

    def _step_oracle(self) -> bool:
        from repro_torch.core.user import TaskCounts

        # budget exhaustion is checked *before* pumping: the original
        # `for pumps in range(1, hard + 1)` loop never pumped past `hard`
        # (and never pumped at all for hard == 0)
        if self.pumps >= self.hard:
            if self.budget is None:  # pragma: no cover
                raise TimeoutError(
                    "assignment did not reach its deadline quorum"
                )
            self.closed = True
            return True
        self.pumps += 1
        self.pump()
        statuses = self.assign.statuses()
        done = sum(s == TaskStatus.FINISHED.value for s in statuses.values())
        err = sum(s == TaskStatus.ERROR.value for s in statuses.values())
        canc = sum(s == TaskStatus.CANCELED.value for s in statuses.values())
        dead = err + canc
        if self.on_counts is not None:
            self.on_counts(
                TaskCounts(
                    finished=done,
                    error=err,
                    canceled=canc,
                    active=self.n_tasks - done - dead,
                )
            )
        if done >= self.need or done + dead == self.n_tasks:
            self.closed = True
        return self.closed

    def run(self) -> int:
        """Pump to close; returns total pumps used (across suspensions)."""
        while not self.step():
            pass
        return self.pumps


def pump_until_deadline(
    assign: AssignmentDoc,
    n_tasks: int,
    *,
    need: int,
    budget: int | None,
    pump: Callable[[], None],
    engine: Any = None,
    status_oracle: bool = False,
    on_counts: Callable[[Any], None] | None = None,
) -> int:
    """One-shot wrapper over `DeadlinePump`: pump to close, return pumps
    used. Raises TimeoutError only for unbounded waits that never
    quiesce."""
    return DeadlinePump(
        assign,
        n_tasks,
        need=need,
        budget=budget,
        pump=pump,
        engine=engine,
        status_oracle=status_oracle,
        on_counts=on_counts,
    ).run()


# --------------------------------------------------------------------- #
# wire format: int8 delta <-> JSON-safe dict                             #
# --------------------------------------------------------------------- #
def pack_delta(flat: np.ndarray, row: int = 4096) -> dict[str, Any]:
    """int8-quantize a flat delta for the wire (the int8 codec kernel
    comes with the federated slice of the port)."""
    raise NotImplementedError(FEDERATED_PENDING)


def unpack_delta(msg: dict[str, Any]) -> np.ndarray:
    q = np.frombuffer(base64.b64decode(msg["q"]), np.int8).reshape(
        -1, msg["row"]
    )
    s = np.asarray(msg["s"], np.float32)[:, None]
    return (q.astype(np.float32) * s).reshape(-1)[: msg["n"]]


# --------------------------------------------------------------------- #
# vectorized aggregation: stack every client's packed delta, dequantize  #
# and weighted-sum in one batched op                                     #
# --------------------------------------------------------------------- #
def stack_deltas(
    msgs: list[dict[str, Any]]
) -> tuple[np.ndarray, np.ndarray, int, int] | None:
    """Stack homogeneous packed-delta messages into (N, R, row) int8 q and
    (N, R) f32 scales without ever materializing per-client f32 vectors.
    Returns None when shapes are mixed (callers fall back to the loop)."""
    n, row = msgs[0]["n"], msgs[0]["row"]
    if any(m["n"] != n or m["row"] != row for m in msgs):
        return None
    # one decode pass, one buffer, one reshape — no per-client np arrays
    raw = b"".join(base64.b64decode(m["q"]) for m in msgs)
    q = np.frombuffer(raw, np.int8).reshape(len(msgs), -1, row)
    s = np.asarray([m["s"] for m in msgs], np.float32)
    return q, s, n, row


def aggregate_packed(
    msgs: list[dict[str, Any]], weights: np.ndarray | None = None
) -> np.ndarray:
    """FedAvg server step over packed int8 deltas via the batched path
    (`repro.fleet.compression.batched_dequant_mean` in the JAX package):
    one contraction over the client axis instead of a per-client Python
    loop. Comes with the federated slice of the port."""
    raise NotImplementedError(FEDERATED_PENDING)


def aggregate_reference(
    msgs: list[dict[str, Any]], weights: np.ndarray | None = None
) -> np.ndarray:
    """The pre-vectorization per-client loop, kept as the correctness
    oracle and the benchmark baseline (`benchmarks/fleet_scale.py`)."""
    deltas = [unpack_delta(m) for m in msgs]
    if weights is None:
        return np.mean(np.stack(deltas), axis=0)
    w = np.asarray(weights, np.float32)
    w = w / w.sum()
    out = np.zeros_like(deltas[0])
    for d, wi in zip(deltas, w):
        out += wi * d
    return out


#: Payload template executed inside every vehicle's task container.
#: Local data = a per-vehicle synthetic regression problem whose bias
#: comes from a *vehicle signal* (data heterogeneity driven by the fleet).
ROUND_PAYLOAD = """
import autospada
import numpy as np

p = autospada.get_parameters()
w = np.asarray(p["weights"], dtype=np.float32)
bias_sig = autospada.get_signal(p["bias_signal"])
bias = 0.0 if bias_sig is None else float(bias_sig)
rng = np.random.default_rng(int(p["data_seed"]))
X = rng.standard_normal((int(p["n_samples"]), w.shape[0])).astype(np.float32)
w_true = np.asarray(p["w_true"], dtype=np.float32) + bias
y = X @ w_true
lr = float(p["local_lr"])
w0 = w.copy()
for step in range(int(p["local_steps"])):
    g = X.T @ (X @ w - y) / X.shape[0]
    w = w - lr * g
delta = w - w0
# network-budget discipline: int8-quantize the upload
row = 256
n = delta.shape[0]
pad = (-n) % row
x = np.pad(delta, (0, pad)).reshape(-1, row)
absmax = np.maximum(np.abs(x).max(axis=1, keepdims=True), 1e-12)
s = absmax / 127.0
q = np.clip(np.round(x / s), -127, 127).astype(np.int8)
import base64
autospada.publish({
    "round": int(p["round"]),
    "q": base64.b64encode(q.tobytes()).decode(),
    "s": [float(v) for v in s[:, 0]],
    "n": int(n),
    "row": row,
    "n_samples": int(p["n_samples"]),
    "loss": float(np.mean((X @ w - y) ** 2)),
})
"""


def mean_reported_loss(msgs: list[dict[str, Any]]) -> float | None:
    """Fleet-mean of the client-reported training losses.

    A client may legitimately publish a result without a ``loss`` (legacy
    payloads, custom uploads) or with a non-finite one; those must not
    poison the round metric — ``mean(.., nan)`` turned the whole metrics
    table NaN. Missing/non-finite entries are filtered; None when no
    client reported a usable loss."""
    losses = []
    for m in msgs:
        try:
            loss = float(m["loss"])
        except (KeyError, TypeError, ValueError):
            continue
        if math.isfinite(loss):
            losses.append(loss)
    return float(np.mean(losses)) if losses else None


class FederatedDriver:
    """Runs FedAvg rounds through the platform."""

    def __init__(
        self,
        user: User,
        cfg: FedConfig,
        dim: int,
        w_true: np.ndarray,
        *,
        bias_signal: str = "Vehicle.RoadGrade",
        n_samples: int = 64,
        n_samples_fn: Callable[[int], int] | None = None,
        payload_source: str | None = None,
        engine: Any = None,
        status_oracle: bool = False,
        metrics: Any = None,
    ):
        self.user = user
        self.cfg = cfg
        #: unified event engine: round deadlines become heap entries
        self.engine = engine
        #: True = close rounds on dense statuses() scans (parity oracle)
        self.status_oracle = status_oracle
        #: FleetMetrics sink for live per-round progress gauges (fed from
        #: the same status-event counters the deadline check reads)
        self.metrics = metrics
        #: task container source; override to exercise bespoke uploads
        self.payload_source = payload_source or ROUND_PAYLOAD
        self.w = np.zeros((dim,), np.float32)
        self.w_true = w_true
        self.bias_signal = bias_signal
        self.n_samples = n_samples
        #: optional per-client dataset size (by client index within the
        #: round) — realistic fleets are data-heterogeneous, and FedAvg
        #: weights the aggregate by sample count
        self.n_samples_fn = n_samples_fn
        self.history: list[dict[str, Any]] = []
        #: raw packed deltas of the most recent round (exposed so tests can
        #: replay the aggregation against the reference loop)
        self.last_msgs: list[dict[str, Any]] = []

    def start_round(self, rnd: int, pump: Callable[[], None]) -> "RoundInFlight":
        """Commit one round's assignment and arm its deadline pump without
        pumping — the suspension point `repro.fleet.checkpoint` uses to
        snapshot a round mid-flight."""
        clients = self.user.online_clients()
        payload = self.user.payload(self.payload_source, name=f"fedavg-r{rnd}")
        tasks = []
        for i, c in enumerate(clients):
            ns = self.n_samples_fn(i) if self.n_samples_fn else self.n_samples
            params = self.user.parameter(
                {
                    "weights": [float(v) for v in self.w],
                    "w_true": [float(v) for v in self.w_true],
                    "bias_signal": self.bias_signal,
                    "data_seed": 1000 * rnd + i,
                    "n_samples": int(ns),
                    "local_lr": self.cfg.local_lr,
                    "local_steps": self.cfg.local_steps,
                    "round": rnd,
                }
            )
            tasks.append(self.user.task(c, payload, params))
        assign = self.user.assignment(f"fedavg round {rnd}", tasks).commit()

        need = max(1, int(len(clients) * self.cfg.deadline_fraction))
        on_counts = None
        if self.metrics is not None:
            self.metrics.begin_round(rnd, len(clients))
            on_counts = self.metrics.update_progress
        dpump = DeadlinePump(
            assign,
            len(clients),
            need=need,
            budget=self.cfg.deadline_pumps,
            pump=pump,
            engine=self.engine,
            status_oracle=self.status_oracle,
            on_counts=on_counts,
        )
        return RoundInFlight(
            rnd=rnd, n_clients=len(clients), assign=assign, pump=dpump
        )

    def finish_round(self, rif: "RoundInFlight") -> dict[str, Any]:
        """Pump an in-flight round to its close and aggregate."""
        rnd = rif.rnd
        assign = rif.assign
        pumps = rif.pump.run()
        # deadline reached: cancel stragglers (paper lifecycle semantics)
        canceled = assign.cancel()
        if self.metrics is not None:
            # final gauge including the deadline cancels
            self.metrics.update_progress(assign.counts())
        msgs = []
        for task_id, values in assign.results().items():
            for v in values:
                if isinstance(v, dict) and v.get("round") == rnd and "q" in v:
                    msgs.append(v)
        self.last_msgs = msgs
        weights = None
        if msgs:
            # FedAvg proper: weight each client's delta by its local sample
            # count (uploads carry n_samples; legacy results without it
            # count as 1). Uniform counts reduce to the plain mean.
            weights = np.asarray(
                [float(m.get("n_samples", 1)) for m in msgs], np.float32
            )
            # batched path: one fused dequant + weighted-sum over clients
            mean_delta = aggregate_packed(msgs, weights)
            self.w = self.w + self.cfg.server_lr * mean_delta
        rec = {
            "round": rnd,
            "participants": len(msgs),
            "canceled": canceled,
            "pumps": pumps,
            "weights": None if weights is None else [float(v) for v in weights],
            "mean_client_loss": mean_reported_loss(msgs),
            "dist_to_optimum": float(np.linalg.norm(self.w - self.w_true)),
        }
        self.history.append(rec)
        return rec

    def run_round(self, rnd: int, pump: Callable[[], None]) -> dict[str, Any]:
        return self.finish_round(self.start_round(rnd, pump))


@dataclasses.dataclass
class RoundInFlight:
    """A committed-but-not-closed FedAvg round: the assignment plus its
    armed `DeadlinePump`. Produced by `FederatedDriver.start_round`,
    consumed by `finish_round` — and by `repro.fleet.checkpoint`, which
    snapshots/restores one to checkpoint mid-round with tasks in flight."""

    rnd: int
    n_clients: int
    assign: AssignmentDoc
    pump: DeadlinePump
