"""Deterministic discrete-event fleet simulator.

Drives hundreds-to-thousands of `EdgeClient` instances against one
`StateStore`/`Broker` pair under a *seeded* schedule of

* broker faults — drop / duplicate / delay via `seeded_fault_plan`
  (paper §2.3 intermittent connectivity, §3.3.1 resiliency);
* client churn — vehicles power off and return mid-round through
  `FleetPool.power_off/power_on`, and brand-new vehicles can join
  (`FleetPool.add_vehicle`);
* stragglers — a seeded subset of clients only gets sync-loop budget
  every `straggler_period`-th tick, so they miss round deadlines and the
  driver's cancel path is exercised at scale.

Time is an integer tick. One `tick()`:

1. drains the unified event engine (`repro_torch.fleet.engine.EventEngine`,
   the default): churn toggles, token-bucket service refills, straggler
   releases, and round-deadline timers all pop off ONE time-ordered
   heap in O(events due) — phase ordering (churn < service < timer)
   reproduces the legacy subsystem order exactly;
2. advances the broker clock, releasing delayed messages (`Broker.advance`);
3. advances the fleet's signals — ONE columnar `FleetSignalPlane` step
   (a scenario from `repro_torch.fleet.scenarios`, written into the ring
   on `SimConfig.device`) instead of the old O(n_clients × n_signals)
   per-vehicle iterator loop;
4. services the fleet's sync loops: `EngineService` under the engine
   (heap-fed refills + wakes, only due/woken clients touched), the
   numpy-masked `FleetServiceScheduler`, or the original
   `DensePollService` O(N) loop. With `Backends(engine="dense")` the
   legacy per-subsystem tick (churn scan, then service sweep) runs
   instead — kept as the bit-for-bit parity oracle. Stragglers get a
   sync-loop budget only every `straggler_period`-th tick; idle clients
   periodically dial in (`resync`) — the paper's recovery story for
   dropped QoS-0 notifications.

Backend selection is typed: `SimConfig.backends` is a `Backends`
sub-config of enum members (`PlaneBackend`, `ServiceBackend`,
`ChurnBackend`, `EngineBackend`); strings coerce, typos raise
`ValueError`, and the legacy `SimConfig(plane=/service=/churn=)` kwargs
still work as overrides.

Everything observable is a deterministic function of `SimConfig`
(including the seed): same config => same event interleaving => same
results, bit-for-bit.

`run_federated` is the next slice of the port and raises
`NotImplementedError`; `run_analytics` and the gateway work.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np

from repro_torch.core.broker import Broker, seeded_fault_plan
from repro_torch.core.columns import FleetColumns, deep_sizeof
from repro_torch.core.server import make_platform
from repro_torch.core.user import User
from repro_torch.device import resolve_device
from repro_torch.fleet.analytics import AnalyticsConfig, AnalyticsDriver
from repro_torch.fleet.churn import make_churn
from repro_torch.fleet.elastic import FleetPool
from repro_torch.fleet.engine import CalendarService, EngineService, EventEngine
from repro_torch.fleet.federated import FEDERATED_PENDING, FedConfig
from repro_torch.fleet.metrics import FleetMetrics, RoundMetrics
from repro_torch.fleet.rounds import FederatedDriver
from repro_torch.fleet.scenarios import build_plane
from repro_torch.fleet.service import make_service


# --------------------------------------------------------------------- #
# typed backend selection (the Backends sub-config)                      #
# --------------------------------------------------------------------- #
class PlaneBackend(str, enum.Enum):
    """Signal-plane implementation: one plane whose ring lives on one
    device, or rows sharded across devices (not ported yet: selecting it
    raises `NotImplementedError`)."""

    HOST = "host"
    SHARDED = "sharded"


class ServiceBackend(str, enum.Enum):
    """Fleet sync-loop service: the event-driven scheduler (O(runnable)
    per tick; engine-native when the engine backend is "event"), the
    calendar-queue service (periodic refills in numpy lanes — the 100k+
    fast path; requires the event engine), or the original dense O(N)
    poll loop, kept as the parity oracle."""

    SCHEDULER = "scheduler"
    CALENDAR = "calendar"
    DENSE = "dense"


class ChurnBackend(str, enum.Enum):
    """Ignition churn: seeded geometric inter-arrival *events* (O(events)
    per tick) or the O(N)-scan oracle over the same per-vehicle streams."""

    EVENT = "event"
    DENSE = "dense"


class EngineBackend(str, enum.Enum):
    """Tick orchestration: "event" drains one unified time-ordered heap
    (churn toggles, service refills, round deadlines — O(events) per
    tick); "dense" is the legacy per-subsystem tick, the parity oracle."""

    EVENT = "event"
    DENSE = "dense"


def _coerce_backend(enum_cls: type, value, knob: str):
    if isinstance(value, enum_cls):
        return value
    try:
        return enum_cls(value)
    except ValueError:
        valid = ", ".join(repr(e.value) for e in enum_cls)
        raise ValueError(
            f"unknown {knob} backend {value!r}; valid choices: {valid}"
        ) from None


@dataclass(frozen=True)
class Backends:
    """Which implementation runs each simulator subsystem.

    Every knob is a typed enum; plain strings are accepted and coerced
    (``Backends(plane="sharded")``), and a typo raises a ValueError
    naming the valid choices. Each "dense" choice is the corresponding
    O(N) parity oracle — any mix must yield bit-for-bit identical runs.
    """

    plane: PlaneBackend = PlaneBackend.HOST
    service: ServiceBackend = ServiceBackend.SCHEDULER
    churn: ChurnBackend = ChurnBackend.EVENT
    engine: EngineBackend = EngineBackend.EVENT

    def __post_init__(self):
        object.__setattr__(
            self, "plane", _coerce_backend(PlaneBackend, self.plane, "plane")
        )
        object.__setattr__(
            self, "service",
            _coerce_backend(ServiceBackend, self.service, "service"),
        )
        object.__setattr__(
            self, "churn", _coerce_backend(ChurnBackend, self.churn, "churn")
        )
        object.__setattr__(
            self, "engine",
            _coerce_backend(EngineBackend, self.engine, "engine"),
        )


@dataclass(frozen=True)
class SimConfig:
    """Everything that determines a simulation, seed included."""

    n_clients: int = 32
    seed: int = 0
    # -- signals --------------------------------------------------------- #
    #: drive-cycle scenario feeding the columnar signal plane
    #: (repro_torch.fleet.scenarios.SCENARIOS). The default is the legacy
    #: time-invariant per-vehicle road grade, so rounds that consume
    #: different tick counts (lossy vs fault-free) see identical signals.
    scenario: str = "road-grade"
    #: plane history ring depth (backs `autospada.get_signal_window`)
    signal_history: int = 256
    # -- broker faults -------------------------------------------------- #
    p_drop: float = 0.0        # QoS-0 notification drop probability
    p_duplicate: float = 0.0   # QoS-1 redelivery probability
    max_delay: int = 0         # uniform message delay in ticks
    # -- churn ---------------------------------------------------------- #
    p_leave: float = 0.0       # per-online-client per-tick ignition-off
    p_return: float = 0.0      # per-offline-client per-tick ignition-on
    # -- stragglers ----------------------------------------------------- #
    straggler_fraction: float = 0.0
    straggler_period: int = 4  # stragglers act once every `period` ticks
    # -- service rates -------------------------------------------------- #
    steps_per_tick: int = 8    # sync-loop op budget per client per tick
    resync_period: int = 4     # idle clients dial in every k ticks
    # -- backend selection ---------------------------------------------- #
    #: typed per-subsystem implementation choices. The four legacy
    #: top-level knobs below stay accepted (strings or enums) and
    #: override the corresponding `backends` field; after construction
    #: they mirror the resolved enum values, so `cfg.plane == "host"`
    #: style comparisons keep working.
    backends: Backends | None = None
    plane: PlaneBackend | str | None = None
    service: ServiceBackend | str | None = None
    churn: ChurnBackend | str | None = None
    engine: EngineBackend | str | None = None
    # -- device ---------------------------------------------------------- #
    #: where the signal ring, the sketch fold and the merges run; the card
    #: unless the caller passes "cpu"
    device: str = "cuda"

    def __post_init__(self):
        b = self.backends if self.backends is not None else Backends()
        if not isinstance(b, Backends):
            raise TypeError(
                f"backends must be a Backends, got {type(b).__name__}"
            )
        overrides = {
            knob: v
            for knob in ("plane", "service", "churn", "engine")
            if (v := getattr(self, knob)) is not None
        }
        if overrides:
            # replace() re-runs Backends.__post_init__, coercing strings
            # and raising the naming ValueError on typos
            b = dataclasses.replace(b, **overrides)
        object.__setattr__(self, "backends", b)
        for knob in ("plane", "service", "churn", "engine"):
            object.__setattr__(self, knob, getattr(b, knob))


class FleetSimulator:
    """Owns the platform (store + broker + server), the vehicle pool, and
    logical time. `tick` doubles as the `pump` callable every platform
    driver in this repo expects, so the simulator slots in wherever the
    old hand-written pump loops did."""

    def __init__(
        self,
        cfg: SimConfig,
        *,
        signal_fn: Callable[[int], dict] | None = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        b = cfg.backends
        faults = seeded_fault_plan(
            cfg.seed,
            p_drop=cfg.p_drop,
            p_duplicate=cfg.p_duplicate,
            max_delay=cfg.max_delay,
        )
        self.broker = Broker(faults)
        self.store, _, (self.server,) = make_platform(broker=self.broker)
        # the columnar control plane: ONE structure-of-arrays arena holds
        # every per-client scalar (logical clocks, power/registered flags,
        # sync timestamps, unacked counts, service gating). Attached to
        # the store BEFORE the pool registers vehicles, so arena rows are
        # allocated in vehicle-index order.
        self.columns = FleetColumns(cfg.n_clients)
        self.store.attach_columns(self.columns)
        #: the unified event heap (None under the legacy dense tick path)
        self.engine = (
            EventEngine(self.broker)
            if b.engine is EngineBackend.EVENT
            else None
        )
        # Signals: an explicit signal_fn keeps the legacy per-vehicle
        # scripted path; otherwise the whole fleet shares one columnar
        # signal plane seeded from the configured drive-cycle scenario.
        self.plane = (
            None
            if signal_fn is not None
            else build_plane(
                cfg.scenario,
                cfg.n_clients,
                cfg.seed,
                history=cfg.signal_history,
                plane=b.plane.value,
                device=self.device,
            )
        )
        self.pool = FleetPool(
            self.store,
            self.broker,
            self.server,
            n_vehicles=cfg.n_clients,
            signal_fn=signal_fn,
            plane=self.plane,
            columns=self.columns,
            seed=cfg.seed,
        )
        self.user = User(self.server, self.broker)
        self.metrics = FleetMetrics(columns=self.columns)
        self.t = 0
        # churn: seeded geometric *event times* per vehicle (O(events) per
        # tick) instead of a per-vehicle per-tick coin; each vehicle draws
        # from its own stream so adding a fault knob — or another vehicle —
        # never perturbs who leaves when
        self.churn = make_churn(
            b.churn.value, cfg.seed, cfg.p_leave, cfg.p_return
        )
        if self.engine is not None and b.churn is ChurnBackend.EVENT:
            # toggle events live in the unified heap; the dense-churn
            # oracle keeps its scan and is applied before the drain
            self.churn.attach_engine(self.engine, self._toggle_ignition)
        self.pool.attach_churn(self.churn)
        for cid, v in self.pool.vehicles.items():
            self.churn.watch(
                cid, v.metadata["index"], v.client is not None, now=0
            )
        # seeded straggler subset: a fixed permutation prefix
        order = np.random.default_rng((cfg.seed, 0x57A6)).permutation(
            cfg.n_clients
        )
        k = int(round(cfg.n_clients * cfg.straggler_fraction))
        slow = set(int(i) for i in order[:k])
        # let the initial bootstrap traffic settle so round 0 starts from
        # a quiesced fleet regardless of fleet size
        for v in self.pool.vehicles.values():
            if v.client is not None:
                v.client.run_until_idle()
        # fleet service: event-driven scheduler (default; engine-native
        # when the engine backend is "event") or the dense poll-loop
        # oracle — attached after the quiesce so the scheduler's runnable
        # set starts from the fleet's true (idle) state
        if b.service is ServiceBackend.CALENDAR and self.engine is None:
            raise ValueError(
                "service backend 'calendar' needs the event engine "
                "(Backends(engine='event')) — its lanes fire from the drain"
            )
        if self.engine is not None and b.service in (
            ServiceBackend.SCHEDULER, ServiceBackend.CALENDAR
        ):
            service_cls = (
                CalendarService
                if b.service is ServiceBackend.CALENDAR
                else EngineService
            )
            self.service = service_cls(
                self.engine,
                self.pool,
                steps_per_tick=cfg.steps_per_tick,
                resync_period=cfg.resync_period,
                straggler_period=cfg.straggler_period,
                straggler_indices=slow,
            )
        else:
            self.service = make_service(
                b.service.value,
                self.pool,
                steps_per_tick=cfg.steps_per_tick,
                resync_period=cfg.resync_period,
                straggler_period=cfg.straggler_period,
                straggler_indices=slow,
            )
        self.pool.attach_service(self.service)

    # ------------------------------------------------------------------ #
    # the discrete-event loop                                            #
    # ------------------------------------------------------------------ #
    def _toggle_ignition(self, cid: str) -> None:
        """One churn-driven power transition; `notify` re-enters the
        schedule via `FleetPool.attach_churn` to draw the next gap."""
        if self.pool.vehicles[cid].client is not None:
            self.pool.power_off(cid)
        else:
            self.pool.power_on(cid)

    def tick(self) -> None:
        """One world step. Deterministic given the config."""
        self.t += 1
        cfg = self.cfg
        # 1. due events: one drain of the unified heap fires this tick's
        #    ignition toggles, service refills, and deadline timers in
        #    (tick, phase, index) order — O(events), never O(N). The
        #    legacy path (engine="dense") pops each subsystem separately;
        #    the dense-churn oracle keeps its scan in either mode.
        if self.engine is not None:
            if self.churn._engine is None and (cfg.p_leave or cfg.p_return):
                for cid in self.churn.pop_due(self.t):
                    self._toggle_ignition(cid)
            self.engine.drain(self.t)
        elif cfg.p_leave or cfg.p_return:
            for cid in self.churn.pop_due(self.t):
                self._toggle_ignition(cid)
        # 2. release delayed broker deliveries due at this tick
        self.broker.advance(1)
        # 3. advance the whole fleet's signals: ONE columnar plane step
        #    (the old path ticked n_clients iterator brokers in Python).
        #    Scripted signals keep the historical behaviour: a powered-off
        #    vehicle's iterators pause until the ignition returns.
        self.pool.tick_signals(online_only=True)
        # 4. bounded sync-loop service: O(runnable) via the event-driven
        #    scheduler (or the dense O(N) oracle — identical interleaving)
        self.service.tick(self.t)

    # `pump` alias: FederatedDriver and AssignmentDoc.await_results take a
    # zero-arg world-advancer
    def pump(self) -> None:
        self.tick()

    # ------------------------------------------------------------------ #
    # memory accounting                                                  #
    # ------------------------------------------------------------------ #
    def memory_report(self) -> dict[str, int | float]:
        """Bytes per subsystem (recursive `deep_sizeof` walk) plus the
        headline bytes/client figure. One shared identity memo across
        categories, walked in order, so shared structures (the arena, the
        store the clients reference) are billed to the first category
        that reaches them and never double-counted."""
        seen: set[int] = set()
        plane_b = deep_sizeof(self.plane, seen) if self.plane is not None else 0
        cols_b = deep_sizeof(self.columns, seen)
        docs_b = deep_sizeof(self.store, seen)
        queues_b = deep_sizeof(self.broker, seen)
        clients_b = deep_sizeof(self.pool, seen)
        other_b = deep_sizeof(self.service, seen) + deep_sizeof(
            self.churn, seen
        )
        if self.engine is not None:
            other_b += deep_sizeof(self.engine, seen)
        total = plane_b + cols_b + docs_b + queues_b + clients_b + other_b
        n = len(self.pool.vehicles)
        return {
            "n_clients": n,
            "plane": plane_b,
            "columns": cols_b,
            "docs": docs_b,
            "queues": queues_b,
            "clients": clients_b,
            "other": other_b,
            "total": total,
            "bytes_per_client": total / max(1, n),
        }

    @staticmethod
    def format_memory_report(report: dict[str, int | float]) -> str:
        """The `launch.fleet --memory-report` table."""
        lines = [
            f"memory report ({report['n_clients']} clients)",
            "  section      bytes        bytes/client",
        ]
        n = max(1, int(report["n_clients"]))
        for key in ("plane", "columns", "docs", "queues", "clients", "other",
                    "total"):
            b = int(report[key])
            lines.append(f"  {key:<11}{b:>12,}{b / n:>15,.1f}")
        return "\n".join(lines)

    # ------------------------------------------------------------------ #
    # federated-learning campaign                                        #
    # ------------------------------------------------------------------ #
    def run_federated(self, fed: FedConfig, **kwargs) -> FederatedDriver:
        """Run FedAvg rounds over the simulated fleet. Not ported yet:
        raises `NotImplementedError` (the federated round, with the int8
        codec kernel and local SGD, is the next slice of the port)."""
        raise NotImplementedError(FEDERATED_PENDING)

    # ------------------------------------------------------------------ #
    # streaming-analytics campaign (the paper's data-analytics use case)  #
    # ------------------------------------------------------------------ #
    def run_analytics(
        self,
        cfg: AnalyticsConfig,
        *,
        windows: int = 5,
        warmup_ticks: int = 0,
        driver: AnalyticsDriver | None = None,
        on_window: Callable[[int, AnalyticsDriver], None] | None = None,
    ) -> AnalyticsDriver:
        """Run `windows` streaming-statistics assignments over the fleet:
        vehicles fold their signal windows into Welford/histogram sketches
        on-board; the server merges all sketches in one batched
        reduction per window on the simulator's device. `warmup_ticks` advances the world first so
        the signal plane's history ring has data to window over.

        Pass a `driver` (e.g. one restored by `FleetCheckpoint.restore`)
        to run `windows` MORE windows continuing its history (warmup is
        skipped — the restored world already carries the ring).
        `on_window(w, driver)` fires after each window is recorded."""
        start = 0
        if driver is None:
            for _ in range(warmup_ticks):
                self.tick()
            driver = AnalyticsDriver(
                self.user,
                cfg,
                engine=self.engine,
                status_oracle=self.engine is None,
                metrics=self.metrics,
                device=self.device,
            )
        else:
            start = len(driver.history)
        for w in range(start, start + windows):
            online = len(self.pool.online())
            t0, tick0 = time.perf_counter(), self.t
            pub0, del0, drop0 = (
                self.broker.published,
                self.broker.delivered,
                self.broker.dropped,
            )
            rec = driver.run_window(w, pump=self.tick)
            self.metrics.record(
                RoundMetrics(
                    round=w,
                    online_at_start=online,
                    participants=rec.participants,
                    canceled=rec.canceled,
                    ticks=self.t - tick0,
                    published=self.broker.published - pub0,
                    delivered=self.broker.delivered - del0,
                    dropped=self.broker.dropped - drop0,
                    wall_s=time.perf_counter() - t0,
                )
            )
            if on_window is not None:
                on_window(w, driver)
        return driver
