"""The fleet query gateway: concurrent analyst sessions over a running
`FleetSimulator` (the paper's users are *analysts* who submit Python
tasks to vehicles and read results back from the cloud).

Architecture — a deterministic request plane on top of the event engine:

* **Sessions** (`AnalystSession`) submit requests between world ticks.
  Requests land in one FIFO queue; submitting arms a single engine entry
  at the next tick's `PHASE_ADMIT` (before churn, service, and timers),
  so the engine drain itself admits the queue *between ticks*: reads see
  the quiesced end-of-previous-tick snapshot, and submissions commit
  before this tick's churn toggles or service sweep can observe them.
  Admission order is arrival order (one global sequence number), so the
  response stream is a pure function of (seed, request trace) — same
  seed + same trace -> byte-identical `GatewayResponse.encode()` bytes.
  `admit_per_tick` caps admissions per boundary, which turns analyst
  overload into deterministic queueing delay (visible as response ticks
  instead of tick-time blowup.

* **Read queries** are served at admission, synchronously, against the
  snapshot: fleet gauges (`FleetMetrics.fleet_gauges` — one numpy
  reduction per gauge over the shared columns), platform doc counts
  (`StateStore.doc_counts`, O(1)), per-vehicle signal values/windows
  (plane ring reads), per-assignment round progress (O(1) status-event
  counters), and fleet-level window statistics. The statistics path is
  the load-bearing one: ``fleet_stats``/``quantile`` answers come from
  the plane's *cached per-tick sketch fold* (`fleet_sketch` — ONE fused
  device fold per (tick, signal, spec), shared with every vehicle
  payload and every other analyst that tick), then one
  `WindowStats`-style merge on the simulator's device. The ring never
  crosses device->host for these reads; only the sketch block does.

* **Submissions** (analytics windows, fused-sketch windows) commit a
  real assignment at admission and arm a
  `DeadlinePump` whose `pump` is a **no-op**: the gateway never advances
  the world from inside a request. Instead `FleetGateway.tick()` runs
  one `FleetSimulator.tick()` and then *settles* — one no-pump
  `DeadlinePump.step()` per in-flight submission, in admission order —
  so quorum/deadline checks happen exactly once per tick boundary and
  many assignments from many analysts progress concurrently over the
  same fleet. When a pump closes, the driver's finish path (the sketch
  merge) runs and the deferred response completes. Federated rounds
  (`submit_round`) are the next slice of the port: they are answered at
  admission with ``ok=False`` and the `NotImplementedError` message.

Determinism contract: reads never
perturb the world (a read-only trace leaves the simulator bit-identical
to an untouched twin), interleaved sessions see the same answers a lone
session would, and full traces replay byte-for-byte.
"""
from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

import numpy as np

from repro_torch.fleet.analytics import AnalyticsConfig, AnalyticsDriver
from repro_torch.fleet.engine import PHASE_ADMIT
from repro_torch.fleet.federated import FEDERATED_PENDING
from repro_torch.kernels.ops import (
    merge_histograms,
    merge_moments,
    merge_quantile_sketches,
)
from repro_torch.kernels.sketch import SketchSpec

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.fleet.simulator import FleetSimulator

#: request kinds served synchronously at admission
READ_KINDS = (
    "gauges", "platform", "progress", "signal", "window", "fleet_stats",
    "quantile",
)
#: request kinds that commit an assignment and answer when it closes
SUBMIT_KINDS = ("submit_round", "submit_window")


@dataclass(frozen=True)
class GatewayRequest:
    """One analyst request: what was asked, by whom, and when."""

    seq: int
    session: str
    kind: str
    params: dict[str, Any]
    submitted_tick: int


@dataclass(frozen=True)
class GatewayResponse:
    """One served request. ``served_tick - submitted_tick`` is the
    response latency in world ticks (the load benchmark's p50/p99)."""

    seq: int
    session: str
    kind: str
    submitted_tick: int
    served_tick: int
    ok: bool
    body: dict[str, Any]

    @property
    def ticks(self) -> int:
        return self.served_tick - self.submitted_tick

    def to_dict(self) -> dict[str, Any]:
        return {
            "seq": self.seq,
            "session": self.session,
            "kind": self.kind,
            "submitted_tick": self.submitted_tick,
            "served_tick": self.served_tick,
            "ok": self.ok,
            "body": self.body,
        }

    def encode(self) -> bytes:
        """Canonical wire form: sorted keys, no whitespace, shortest
        round-trip floats — the bytes the replay test pins down."""
        return json.dumps(
            self.to_dict(), sort_keys=True, separators=(",", ":")
        ).encode()


class Ticket:
    """Handle a session gets back at submission; `response` fills in when
    the request is served (immediately for reads, at round close for
    submissions)."""

    __slots__ = ("request", "response")

    def __init__(self, request: GatewayRequest):
        self.request = request
        self.response: GatewayResponse | None = None

    @property
    def done(self) -> bool:
        return self.response is not None


class AnalystSession:
    """One analyst's connection: submits requests, collects responses in
    completion order (`inbox`). Thin sugar over `FleetGateway.submit`."""

    def __init__(self, gateway: "FleetGateway", name: str):
        self.gateway = gateway
        self.name = name
        #: responses in completion order (reads at admission, submissions
        #: at round close) — appended by the gateway, drained by the user
        self.inbox: list[GatewayResponse] = []

    def ask(self, kind: str, **params: Any) -> Ticket:
        return self.gateway.submit(self.name, kind, params)

    # -- reads ----------------------------------------------------------- #
    def gauges(self) -> Ticket:
        return self.ask("gauges")

    def platform(self) -> Ticket:
        return self.ask("platform")

    def progress(self, ticket: Ticket | int | None = None) -> Ticket:
        if isinstance(ticket, Ticket):
            ticket = ticket.request.seq
        params = {} if ticket is None else {"ticket": int(ticket)}
        return self.ask("progress", **params)

    def signal(self, client: str | int, signal: str) -> Ticket:
        return self.ask("signal", client=client, signal=signal)

    def window(self, client: str | int, signal: str, k: int) -> Ticket:
        return self.ask("window", client=client, signal=signal, k=int(k))

    def fleet_stats(self, signal: str, **spec: Any) -> Ticket:
        return self.ask("fleet_stats", signal=signal, **spec)

    def quantile(self, signal: str, q: float, **spec: Any) -> Ticket:
        return self.ask("quantile", signal=signal, q=float(q), **spec)

    # -- submissions ------------------------------------------------------ #
    def submit_round(self, **params: Any) -> Ticket:
        return self.ask("submit_round", **params)

    def submit_window(self, signal: str, **params: Any) -> Ticket:
        return self.ask("submit_window", signal=signal, **params)


@dataclass(frozen=True)
class _FleetStats:
    """One merged fleet-level statistics snapshot (tick-cached)."""

    participants: int
    count: int
    mean: float | None
    var: float | None
    hist: tuple[int, ...]
    #: merged quantile summary (values ascending, cumulative weights);
    #: None when no vehicle sketched a sample
    qv: np.ndarray | None
    qw: np.ndarray | None

    def quantile(self, q: float) -> float | None:
        """`WindowStats.quantile` on the merged summary (same formula)."""
        if self.qv is None or self.qv.size == 0:
            return None
        total = float(self.qw[-1])
        if not total > 0:
            return None
        target = min(max(float(q), 0.0), 1.0) * total
        i = int(np.searchsorted(self.qw, target, side="left"))
        i = min(i, len(self.qv) - 1)
        while i > 0 and not np.isfinite(self.qv[i]):
            i -= 1
        return float(self.qv[i])


class _InFlight:
    """A committed submission awaiting its deadline pump's close."""

    __slots__ = ("ticket", "driver", "rif", "finish")

    def __init__(self, ticket: Ticket, driver: Any, rif: Any, finish):
        self.ticket = ticket
        self.driver = driver
        self.rif = rif
        self.finish = finish


def _noop() -> None:
    """The gateway's DeadlinePump `pump`: the world is advanced by
    `FleetGateway.tick`, never from inside a request."""


class FleetGateway:
    """Deterministic analyst gateway over one running `FleetSimulator`.

    Requires the event engine (`Backends(engine="event")`, the default):
    admissions are engine entries and round deadlines are heap timers.
    """

    def __init__(
        self,
        sim: "FleetSimulator",
        *,
        admit_per_tick: int | None = None,
    ):
        if sim.engine is None:
            raise ValueError(
                "FleetGateway needs the unified event engine "
                "(SimConfig backends engine='event'); the dense tick has "
                "no drain to admit requests from"
            )
        if admit_per_tick is not None and admit_per_tick < 1:
            raise ValueError("admit_per_tick must be >= 1")
        self.sim = sim
        self.admit_per_tick = admit_per_tick
        self._sessions: dict[str, AnalystSession] = {}
        self._pending: deque[Ticket] = deque()
        self._inflight: list[_InFlight] = []
        self._by_seq: dict[int, _InFlight] = {}
        self._seq = 0
        self._admit_armed = False
        self._window_seq: dict[str, int] = {}
        #: per-tick merged fleet statistics, keyed like the plane's fold
        #: cache: (plane tick, fleet size, signal, spec) — see _fleet_stats
        self._stats_cache: dict = {}
        #: served-request counters by kind (observability, not behavior)
        self.served: dict[str, int] = {}

    # ------------------------------------------------------------------ #
    # the request plane                                                  #
    # ------------------------------------------------------------------ #
    def session(self, name: str) -> AnalystSession:
        s = self._sessions.get(name)
        if s is None:
            s = self._sessions[name] = AnalystSession(self, name)
        return s

    def submit(self, session: str, kind: str, params: dict[str, Any]) -> Ticket:
        """Enqueue one request; it is admitted at the next tick boundary
        (or a later one under `admit_per_tick` backpressure)."""
        self.session(session)  # materialize the inbox
        req = GatewayRequest(
            seq=self._seq,
            session=session,
            kind=kind,
            params=dict(params),
            submitted_tick=self.sim.t,
        )
        self._seq += 1
        ticket = Ticket(req)
        self._pending.append(ticket)
        self._arm()
        return ticket

    def _arm(self) -> None:
        if self._admit_armed or not self._pending:
            return
        eng = self.sim.engine
        # admissions always land at a *future* tick boundary: requests
        # submitted between ticks are admitted when the next drain opens
        eng.schedule(eng.now + 1, self._admit, phase=PHASE_ADMIT, key=0)
        self._admit_armed = True

    def _admit(self) -> None:
        """Engine-drain callback (PHASE_ADMIT): drain the request queue in
        arrival order against the between-ticks snapshot."""
        self._admit_armed = False
        budget = self.admit_per_tick
        n = len(self._pending) if budget is None else min(
            budget, len(self._pending)
        )
        for _ in range(n):
            ticket = self._pending.popleft()
            self._dispatch(ticket)
        self._arm()  # backpressure: anything left waits for the next tick

    def _dispatch(self, ticket: Ticket) -> None:
        req = ticket.request
        try:
            if req.kind in READ_KINDS:
                body = getattr(self, f"_read_{req.kind}")(req.params)
                self._complete(ticket, ok=True, body=body)
            elif req.kind in SUBMIT_KINDS:
                getattr(self, f"_start_{req.kind}")(ticket)
            else:
                raise ValueError(f"unknown request kind {req.kind!r}")
        except (KeyError, ValueError, TypeError, NotImplementedError) as e:
            # a service answers bad requests (and requests for what is not
            # ported yet), it doesn't crash the world
            self._complete(ticket, ok=False, body={"error": str(e)})

    def _complete(self, ticket: Ticket, *, ok: bool, body: dict) -> None:
        req = ticket.request
        resp = GatewayResponse(
            seq=req.seq,
            session=req.session,
            kind=req.kind,
            submitted_tick=req.submitted_tick,
            served_tick=self.sim.t,
            ok=ok,
            body=body,
        )
        ticket.response = resp
        self._sessions[req.session].inbox.append(resp)
        self.served[req.kind] = self.served.get(req.kind, 0) + 1

    # ------------------------------------------------------------------ #
    # world advancement                                                  #
    # ------------------------------------------------------------------ #
    def tick(self) -> None:
        """One world step: the engine drain admits queued requests at the
        boundary, the simulator ticks, then every in-flight submission
        gets exactly one no-pump quorum/deadline check."""
        self.sim.tick()
        self._settle()

    def _settle(self) -> None:
        if not self._inflight:
            return
        still = []
        for inf in self._inflight:
            if inf.rif.pump.step():  # no-op pump: pure quorum check
                self._by_seq.pop(inf.ticket.request.seq, None)
                inf.finish(inf)
            else:
                still.append(inf)
        self._inflight = still

    @property
    def idle(self) -> bool:
        return not self._pending and not self._inflight

    def run_until_idle(self, max_ticks: int = 100_000) -> int:
        """Tick until every request is served; returns ticks used."""
        used = 0
        while not self.idle:
            if used >= max_ticks:
                raise TimeoutError("gateway did not quiesce")
            self.tick()
            used += 1
        return used

    # ------------------------------------------------------------------ #
    # read handlers (admission-time, snapshot-consistent)                #
    # ------------------------------------------------------------------ #
    def _read_gauges(self, params: dict) -> dict:
        g = self.sim.metrics.fleet_gauges()
        g["tick"] = self.sim.t
        return g

    def _read_platform(self, params: dict) -> dict:
        b = self.sim.broker
        out: dict[str, Any] = dict(self.sim.store.doc_counts())
        out.update(
            published=b.published, delivered=b.delivered, dropped=b.dropped
        )
        return out

    def _read_progress(self, params: dict) -> dict:
        seq = params.get("ticket")
        if seq is None:
            p = self.sim.metrics.progress
            return {"active": 0} if p is None else p.to_dict()
        inf = self._by_seq.get(int(seq))
        if inf is None:
            raise ValueError(f"no in-flight submission with seq {seq}")
        c = inf.rif.assign.counts()
        return {
            "ticket": int(seq),
            "total": inf.rif.n_clients,
            "finished": c.finished,
            "error": c.error,
            "canceled": c.canceled,
            "active": c.active,
        }

    def _plane(self):
        plane = self.sim.plane
        if plane is None:
            raise ValueError("simulator has no signal plane (scripted "
                             "signal_fn worlds serve no signal queries)")
        return plane

    def _row(self, client: str | int) -> int:
        if isinstance(client, str):
            v = self.sim.pool.vehicles.get(client)
            if v is None:
                raise ValueError(f"unknown client {client!r}")
            return int(v.metadata["index"])
        return int(client)

    def _read_signal(self, params: dict) -> dict:
        plane = self._plane()
        val = plane.read(self._row(params["client"]), params["signal"])
        return {"signal": params["signal"], "value": val}

    def _read_window(self, params: dict) -> dict:
        plane = self._plane()
        vals = plane.window(
            self._row(params["client"]), params["signal"], int(params["k"])
        )
        return {"signal": params["signal"], "values": vals}

    def _spec(self, params: dict) -> SketchSpec:
        return SketchSpec(
            window=int(params.get("window", 64)),
            bins=int(params.get("bins", 16)),
            lo=float(params.get("lo", 0.0)),
            hi=float(params.get("hi", 12.0)),
            quantile_k=int(params.get("quantile_k", 32)),
        )

    def _fleet_stats(self, signal: str, spec: SketchSpec) -> "_FleetStats":
        """Fleet-level window statistics out of the cached per-tick fold:
        one `fleet_sketch` hit (shared with vehicle payloads and every
        other analyst this tick) + the batched `WindowStats` merges. The
        merged result is itself cached per tick — under many-analyst
        load, the whole fleet pays ONE ring fold and ONE merge per
        (tick, signal, spec), and every statistics query after the first
        is a dict hit. The ring never crosses device->host on this
        path."""
        plane = self._plane()
        key = (plane.t, plane.n_clients, signal, spec)
        st = self._stats_cache.get(key)
        if st is not None:
            return st
        self._stats_cache.clear()
        sk = plane.fleet_sketch(signal, spec)
        counts = sk.counts.astype(np.float32)
        dev = self.sim.device
        c, mean, m2 = merge_moments(counts, sk.means, sk.m2s, device=dev)
        hist = merge_histograms(sk.hists, device=dev)
        qv = qw = None
        if c > 0:
            qv, qw = merge_quantile_sketches(sk.qvals, counts, device=dev)
        st = _FleetStats(
            participants=int(np.count_nonzero(sk.counts)),
            count=int(c),
            mean=float(mean) if c > 0 else None,
            var=float(m2 / c) if c > 0 else None,
            hist=tuple(int(v) for v in hist),
            qv=qv,
            qw=qw,
        )
        self._stats_cache[key] = st
        return st

    def _read_fleet_stats(self, params: dict) -> dict:
        st = self._fleet_stats(params["signal"], self._spec(params))
        qs = [float(v) for v in params.get("quantiles", (0.5, 0.9))]
        return {
            "signal": params["signal"],
            "participants": st.participants,
            "count": st.count,
            "mean": st.mean,
            "var": st.var,
            "hist": list(st.hist),
            "quantiles": {
                f"p{round(100 * v):02d}": st.quantile(v) for v in qs
            },
        }

    def _read_quantile(self, params: dict) -> dict:
        st = self._fleet_stats(params["signal"], self._spec(params))
        qq = float(params["q"])
        return {
            "signal": params["signal"],
            "q": qq,
            "count": st.count,
            "value": st.quantile(qq),
        }

    # ------------------------------------------------------------------ #
    # submission handlers (deferred responses)                           #
    # ------------------------------------------------------------------ #
    def _start_submit_round(self, ticket: Ticket) -> None:
        """Federated rounds are the next slice of the port: the request is
        answered at admission with the `NotImplementedError` message."""
        raise NotImplementedError(FEDERATED_PENDING)

    def _start_submit_window(self, ticket: Ticket) -> None:
        req = ticket.request
        p = req.params
        cfg = AnalyticsConfig(
            signal=p["signal"],
            window=int(p.get("window", 64)),
            bins=int(p.get("bins", 16)),
            lo=float(p.get("lo", 0.0)),
            hi=float(p.get("hi", 12.0)),
            quantile_k=int(p.get("quantile_k", 32)),
            sketch=bool(p.get("sketch", False)),
            deadline_fraction=float(p.get("deadline_fraction", 0.9)),
            deadline_pumps=int(p.get("deadline_pumps", 64)),
        )
        # one driver per submission: windows from different analysts (or
        # different specs) run concurrently without sharing history
        driver = AnalyticsDriver(
            self.sim.user, cfg, engine=self.sim.engine, device=self.sim.device
        )
        wid = self._window_seq.get(req.session, 0)
        self._window_seq[req.session] = wid + 1
        wif = driver.start_window(wid, pump=_noop)
        inf = _InFlight(ticket, driver, wif, self._finish_window)
        self._inflight.append(inf)
        self._by_seq[req.seq] = inf

    def _finish_window(self, inf: _InFlight) -> None:
        rec = inf.driver.finish_window(inf.rif)
        body = {
            "window_id": rec.window_id,
            "participants": rec.participants,
            "canceled": rec.canceled,
            "pumps": rec.pumps,
            "count": rec.count,
            "mean": None if np.isnan(rec.mean) else float(rec.mean),
            "var": None if np.isnan(rec.var) else float(rec.var),
            "hist": [int(v) for v in rec.hist],
            "p50": _nan_none(rec.quantile(0.5)),
            "p90": _nan_none(rec.quantile(0.9)),
        }
        self._complete(inf.ticket, ok=True, body=body)


def _nan_none(v: float) -> float | None:
    return None if np.isnan(v) else float(v)
