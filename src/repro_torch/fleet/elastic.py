"""Elastic client pool: vehicles join, drop, and return (paper §2.3 —
no availability assumption is ever made).

The pool owns the simulated fleet: each vehicle is an EdgeClient over its
own LocalDisk (so a returning vehicle resumes with its cached state) plus
a signal source. Signals come in two flavours:

* **plane-backed** (the fleet-scale default): every vehicle's broker is a
  `PlaneSignalView` — a row of one columnar `FleetSignalPlane` advanced by
  a single step per tick (`tick_signals`), not n per-vehicle iterators;
* **scripted** (`signal_fn`): the legacy per-vehicle `ScriptedSignalBroker`
  path, kept for tests and bespoke scripting.

`pump()` advances every *online* vehicle's sync loop; offline vehicles
simply do not run — exactly a vehicle with the ignition off. Deterministic
dropout schedules make the fault-tolerance tests reproducible.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from repro_torch.core.broker import Broker
from repro_torch.core.client import EdgeClient, LocalDisk
from repro_torch.core.columns import FleetColumns
from repro_torch.core.signals import (
    FleetSignalPlane,
    ScriptedSignalBroker,
    SignalBroker,
    constant,
)
from repro_torch.core.statestore import StateStore


@dataclass(slots=True)
class Vehicle:
    client_id: str
    disk: LocalDisk
    signals: SignalBroker
    client: EdgeClient | None = None  # None => powered off
    metadata: dict[str, Any] = field(default_factory=dict)


class FleetPool:
    def __init__(
        self,
        store: StateStore,
        broker: Broker,
        server: Any,
        *,
        n_vehicles: int,
        signal_fn: Callable[[int], dict] | None = None,
        plane: FleetSignalPlane | None = None,
        columns: FleetColumns | None = None,
        seed: int = 0,
    ):
        if signal_fn is not None and plane is not None:
            raise ValueError("pass signal_fn or plane, not both")
        self.store = store
        self.broker = broker
        self.server = server
        self.rng = np.random.default_rng(seed)
        self._signal_fn = signal_fn
        self.plane = plane
        #: shared columnar arena for per-client scalars (clients bind on
        #: power-on; None keeps the legacy per-object scalars)
        self.columns = columns
        # one shared sensors list for plane-backed fleets: every vehicle
        # sees the same signal catalog, so 100k copies is pure overhead
        self._plane_sensors: list[str] | None = None
        #: attached fleet service (repro_torch.fleet.service) notified on power
        #: transitions so wake hooks follow the live EdgeClient instance
        self._service = None
        #: attached churn schedule (repro_torch.fleet.churn) notified on power
        #: transitions so event times always reschedule from the actual
        #: ignition state, even when tests/drivers toggle power directly
        self._churn = None
        self._next_index = 0
        self.vehicles: dict[str, Vehicle] = {}
        if plane is not None and n_vehicles > plane.n_clients:
            # mass admission: reserve plane capacity once up front
            plane.add_clients(n_vehicles - plane.n_clients)
        for _ in range(n_vehicles):
            self.add_vehicle()

    def attach_service(self, service) -> None:
        """Register a fleet service (scheduler or dense oracle) to receive
        power-transition hooks for wake re-wiring."""
        self._service = service

    def attach_churn(self, churn) -> None:
        """Register a churn schedule (repro_torch.fleet.churn) to receive power
        transitions, so geometric event times follow the real ignition
        state."""
        self._churn = churn

    # -- fleet membership ----------------------------------------------- #
    def _make_vehicle(self, i: int) -> Vehicle:
        cid = f"veh-{i:03d}"
        if self.plane is not None:
            while i >= self.plane.n_clients:
                self.plane.add_client()
            signals: SignalBroker = self.plane.view(i)
            if self._plane_sensors is None:
                self._plane_sensors = list(self.plane.names)
            sensors = self._plane_sensors
        else:
            signals = ScriptedSignalBroker(
                self._signal_fn(i)
                if self._signal_fn
                else {"Vehicle.RoadGrade": constant(0.1 * i)}
            )
            sensors = ["Vehicle.RoadGrade"]
        return Vehicle(
            client_id=cid,
            disk=LocalDisk(),
            signals=signals,
            metadata={"sensors": sensors, "index": i},
        )

    def add_vehicle(self) -> str:
        """A brand-new vehicle joins the fleet (paper §2.3: membership is
        elastic in both directions) and powers on immediately."""
        i = self._next_index
        self._next_index += 1
        v = self._make_vehicle(i)
        self.vehicles[v.client_id] = v
        self.power_on(v.client_id)
        return v.client_id

    # -- power control -------------------------------------------------- #
    def power_on(self, cid: str) -> None:
        v = self.vehicles[cid]
        if v.client is not None:
            return
        v.client = EdgeClient(
            cid, self.server, self.broker, disk=v.disk,
            signal_broker=v.signals, metadata=v.metadata,
        )
        if self.columns is not None:
            v.client.bind_columns(self.columns)
        v.client.bootstrap()
        self.store.set_online(cid, True)
        i = v.metadata["index"]
        if self.plane is not None:
            # history-ring masking resumes recording from this tick on
            self.plane.set_online(i, True)
        if self._service is not None:
            self._service.client_powered_on(i, v.client)
        if self._churn is not None:
            self._churn.notify(cid, i, True)

    def power_off(self, cid: str) -> None:
        """Ignition off mid-anything: volatile state is lost, disk survives."""
        v = self.vehicles[cid]
        if v.client is None:
            return
        v.client.shutdown()
        v.client = None
        self.store.set_online(cid, False)
        i = v.metadata["index"]
        if self.plane is not None:
            # plane time keeps running fleet-globally, but nothing is
            # "observed" by a powered-off vehicle: NaN-mask its ring rows
            self.plane.set_online(i, False)
        if self._service is not None:
            self._service.client_powered_off(i)
        if self._churn is not None:
            self._churn.notify(cid, i, False)

    def online(self) -> list[str]:
        return [cid for cid, v in self.vehicles.items() if v.client is not None]

    # -- simulation ------------------------------------------------------#
    def tick_signals(self, *, online_only: bool = False) -> None:
        """Advance the fleet's signals one tick: a single columnar plane
        step when plane-backed (the vectorized hot path; plane time is
        fleet-global, so every row advances), else the legacy per-vehicle
        iterator loop. `online_only` preserves the scripted-path semantics
        of the simulator, where a powered-off vehicle's iterators pause
        until the ignition returns."""
        if self.plane is not None:
            self.plane.step()
            return
        for v in self.vehicles.values():
            if online_only and v.client is None:
                continue
            v.signals.tick()

    def pump(self, dropout_prob: float = 0.0) -> None:
        """One world step: random dropout/return, signal ticks, sync loops."""
        for cid, v in self.vehicles.items():
            if dropout_prob and self.rng.random() < dropout_prob:
                if v.client is None:
                    self.power_on(cid)
                else:
                    self.power_off(cid)
        self.tick_signals()
        for v in self.vehicles.values():
            if v.client is not None:
                v.client.run_until_idle()
