"""MQTT/AMQP-like topic broker (paper §3.4.1).

The paper uses RabbitMQ: an MQTT bridge toward clients (minimal
notifications — just the client's current logical-clock value) and AMQP
toward users (streaming results/status updates). We reproduce the delivery
semantics the platform depends on:

* topic-based pub/sub with per-subscriber FIFO queues;
* QoS 0 ("at most once") and QoS 1 ("at least once" — RabbitMQ's MQTT
  plugin caps at QoS 1, which the paper calls out) — QoS 1 redelivers
  until acked and may therefore duplicate;
* **fault injection** (drop / duplicate / delay) so the resiliency claims
  (§2.3, §3.3.1) are *testable*: the sync-loop property tests and the
  fleet simulator drive the platform through lossy-broker schedules.

Because the notification payload is only a monotone counter, dropped,
duplicated, or late notifications are harmless by design — that is the
paper's core resiliency argument; tests/test_syncloop_prop.py checks it
per-client and tests/test_simulator.py checks it at fleet scale.

Scale note: exact-topic subscriptions (every per-client clock topic) are
indexed in a dict so a publish fans out in O(matching subscribers), not
O(all subscribers) — with thousands of simulated vehicles the previous
fnmatch scan made every clock bump O(fleet).

Time: the broker carries a logical tick clock (`now`). Messages a
`FaultPlan.delay` holds back are queued on a heap and released by
`advance()`, which discrete-event drivers (the fleet simulator) call once
per tick. Delivery order is deterministic: (due tick, enqueue order).
"""
from __future__ import annotations

import fnmatch
import heapq
from repro_torch.core.counter import Counter
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Iterator


@dataclass(frozen=True)
class Message:
    topic: str
    value: Any
    msg_id: int
    qos: int = 0


@dataclass
class FaultPlan:
    """Deterministic fault schedule: callables decide per message.

    `delay` returns the number of broker ticks to hold a delivery back;
    0 means deliver immediately (the default, and the behaviour when the
    driver never calls `Broker.advance`).
    """

    drop: Callable[[Message], bool] = lambda m: False
    duplicate: Callable[[Message], bool] = lambda m: False
    delay: Callable[[Message], int] = lambda m: 0


# --------------------------------------------------------------------- #
# seeded fault plans (fleet simulator)                                   #
# --------------------------------------------------------------------- #
_MASK64 = (1 << 64) - 1


def _hash01(seed: int, msg_id: int, salt: int) -> float:
    """Stateless splitmix64-style hash -> [0, 1). Deterministic in
    (seed, msg_id, salt) and independent of call order, so a fault plan
    built from it gives the same schedule no matter how the simulation
    interleaves publishes."""
    x = (
        seed * 0x9E3779B97F4A7C15
        + msg_id * 0xBF58476D1CE4E5B9
        + salt * 0x94D049BB133111EB
        + 0x2545F4914F6CDD1D
    ) & _MASK64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return x / 2.0**64


def seeded_fault_plan(
    seed: int,
    *,
    p_drop: float = 0.0,
    p_duplicate: float = 0.0,
    max_delay: int = 0,
) -> FaultPlan:
    """A deterministic lossy-broker schedule keyed by message id.

    Same seed => same drops/duplicates/delays for the same message ids,
    which is what makes whole fleet simulations replayable.
    """

    def drop(m: Message) -> bool:
        return _hash01(seed, m.msg_id, 1) < p_drop

    def duplicate(m: Message) -> bool:
        return _hash01(seed, m.msg_id, 2) < p_duplicate

    def delay(m: Message) -> int:
        if max_delay <= 0:
            return 0
        return int(_hash01(seed, m.msg_id, 3) * (max_delay + 1))

    return FaultPlan(drop=drop, duplicate=duplicate, delay=delay)


class Subscription:
    """A per-subscriber FIFO queue. `poll()` is non-blocking (the simulated
    clients run event loops, not threads); `drain()` yields all pending.

    `wake` is the delivery hook event-driven schedulers rely on: when set,
    it is invoked (outside the queue lock) after every `_offer`, so a
    subscriber becomes runnable the moment a message lands instead of
    being polled every tick.

    `reliable` models the user-side AMQP leg (paper §3.4.1): the user's
    queue lives in the datacenter next to the server, so the vehicle-link
    fault schedule's *delay* does not apply — deliveries land the same
    tick they are published. Duplicates still occur (AMQP is at-least-once
    here too), so reliable consumers must stay idempotent. Event-driven
    round accounting (`AssignmentDoc.counts`) depends on this: a status
    transition is observed the instant the store commits it, which is what
    keeps the event counters bit-for-bit in step with the dense
    `statuses()` oracle."""

    def __init__(
        self, pattern: str, qos: int, order: int = 0, reliable: bool = False
    ):
        self.pattern = pattern
        self.qos = qos
        self.order = order  # broker-wide subscription sequence number
        self.reliable = reliable
        self.wake: Callable[[], None] | None = None
        self._queue: deque[Message] = deque()
        self._lock = threading.Lock()

    def _offer(self, msg: Message) -> None:
        with self._lock:
            self._queue.append(msg)
        cb = self.wake
        if cb is not None:
            cb()

    @property
    def has_pending(self) -> bool:
        """Lock-free pending check (GIL-atomic deque truthiness) — the O(1)
        read `EdgeClient.has_work` does per serviced client, not per tick."""
        return bool(self._queue)

    def poll(self) -> Message | None:
        with self._lock:
            return self._queue.popleft() if self._queue else None

    def drain(self) -> Iterator[Message]:
        while True:
            m = self.poll()
            if m is None:
                return
            yield m

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)


def _is_exact(pattern: str) -> bool:
    return not any(ch in pattern for ch in "*?[")


class Broker:
    def __init__(self, faults: FaultPlan | None = None):
        #: exact-topic subscriptions, indexed by topic string
        self._exact: dict[str, list[Subscription]] = {}
        #: wildcard subscriptions, matched by fnmatch on publish
        self._wild: list[Subscription] = []
        self._faults = faults or FaultPlan()
        self._ids = Counter()
        self._sub_order = Counter()
        self._lock = threading.Lock()
        self.published = 0
        self.delivered = 0
        self.dropped = 0
        # -- logical time (discrete-event simulation hook) -------------- #
        self.now = 0
        self._delay_order = Counter()
        #: (due_tick, enqueue_order, subscription, message)
        self._delayed: list[tuple[int, int, Subscription, Message]] = []

    def subscribe(
        self, pattern: str, qos: int = 0, *, reliable: bool = False
    ) -> Subscription:
        sub = Subscription(
            pattern, qos, order=next(self._sub_order), reliable=reliable
        )
        with self._lock:
            if _is_exact(pattern):
                self._exact.setdefault(pattern, []).append(sub)
            else:
                self._wild.append(sub)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            if _is_exact(sub.pattern):
                subs = self._exact.get(sub.pattern, [])
                if sub in subs:
                    subs.remove(sub)
                    if not subs:
                        del self._exact[sub.pattern]
            elif sub in self._wild:
                self._wild.remove(sub)
            # pending delayed deliveries to a dead subscriber are dropped
            self._delayed = [e for e in self._delayed if e[2] is not sub]
            heapq.heapify(self._delayed)

    def publish(self, topic: str, value: Any, qos: int = 0) -> Message:
        msg = Message(topic=topic, value=value, msg_id=next(self._ids), qos=qos)
        self.published += 1
        with self._lock:
            subs = list(self._exact.get(topic, ()))
            subs += [s for s in self._wild if fnmatch.fnmatch(topic, s.pattern)]
        # deterministic fan-out order = subscription order, exactly as the
        # previous single-list implementation delivered
        subs.sort(key=lambda s: s.order)
        for sub in subs:
            eff_qos = min(qos, sub.qos)
            if eff_qos == 0 and not sub.reliable and self._faults.drop(msg):
                self.dropped += 1
                continue
            self._deliver(sub, msg)
            # QoS 1 = at-least-once: fault plan may force a redelivery.
            if eff_qos >= 1 and self._faults.duplicate(msg):
                self._deliver(sub, msg)
        return msg

    def _deliver(self, sub: Subscription, msg: Message) -> None:
        ticks = 0 if sub.reliable else self._faults.delay(msg)
        if ticks > 0:
            with self._lock:
                heapq.heappush(
                    self._delayed,
                    (self.now + ticks, next(self._delay_order), sub, msg),
                )
            return
        sub._offer(msg)
        self.delivered += 1

    # ------------------------------------------------------------------ #
    # logical time                                                       #
    # ------------------------------------------------------------------ #
    def advance(self, ticks: int = 1) -> int:
        """Advance the broker clock, releasing due delayed messages in
        deterministic (due, enqueue-order) order. Returns #released."""
        with self._lock:
            self.now += ticks
            now = self.now
        released = 0
        while True:
            with self._lock:
                if not self._delayed or self._delayed[0][0] > now:
                    return released
                _, _, sub, msg = heapq.heappop(self._delayed)
            sub._offer(msg)
            self.delivered += 1
            released += 1

    @property
    def in_flight(self) -> int:
        """Delayed messages not yet released (simulator quiescence check)."""
        with self._lock:
            return len(self._delayed)


# Topic helpers -------------------------------------------------------- #
def client_clock_topic(client_id: str) -> str:
    """Per-client MQTT topic carrying only the state revision counter."""
    return f"clients/{client_id}/clock"


def assignment_results_topic(assignment_id: str) -> str:
    """AMQP-style topic users subscribe to for streaming results."""
    return f"assignments/{assignment_id}/results"


def assignment_status_topic(assignment_id: str) -> str:
    return f"assignments/{assignment_id}/status"
