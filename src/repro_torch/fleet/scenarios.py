"""Seeded scenario generators for the fleet signal plane.

Each scenario is a pure function ``(seed, client, t) -> signals``
evaluated for the whole `(n_clients, n_signals)` plane per tick:

* ``road-grade`` — the legacy constant per-vehicle grade (exactly
                   ``0.01 * (i % 7)``), time-invariant: the simulator's
                   default, preserving the fault-free == lossy aggregate
                   property that the resiliency tests pin down.
* ``highway``, ``urban``, ``idle``, ``mixed`` — the drive cycles. The JAX
                   package draws them from `jax.random` (threefry keys per
                   client and tick); the port raises `NotImplementedError`
                   for them until its threefry twin lands (ROADMAP queue 1,
                   "drive-cycle scenarios").

Row stability: the same (seed, i) yields the same stream at any fleet
size, so a vehicle joining mid-experiment never perturbs existing rows
(`FleetSignalPlane.add_client` relies on this).

`scripted_brokers` renders the same streams through the legacy
per-vehicle `ScriptedSignalBroker` path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.signals import FleetSignalPlane, ScriptedSignalBroker

#: canonical signal names every scenario publishes, column order fixed
SIGNALS: tuple[str, ...] = (
    "Vehicle.Speed",          # km/h
    "Vehicle.FuelRate",       # L/h
    "Vehicle.RoadGrade",      # dimensionless slope
    "Engine.Temperature",     # deg C
)

SCENARIOS = ("road-grade", "highway", "urban", "idle", "mixed")

#: what the drive cycles raise until they are ported
DRIVE_CYCLES_PENDING = (
    "drive-cycle scenarios ({name!r}) are not ported yet: ROADMAP queue 1, "
    "'drive-cycle scenarios, with threefry parity'; use scenario='road-grade'"
)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, seeded scenario. `series(n)` is the host step
    `t -> (n, len(SIGNALS))` float32 numpy matrix the plane calls once per
    tick."""

    name: str
    seed: int = 0
    signals: tuple[str, ...] = SIGNALS

    def series(self, n_clients: int) -> Callable[[int], np.ndarray]:
        if self.name == "road-grade":
            # the step is constant in t, so the hot tick returns one
            # cached numpy array
            vals = _constant_road_grade_values(n_clients)
            return lambda t: vals
        if self.name not in SCENARIOS:
            raise ValueError(
                f"unknown scenario {self.name!r}; pick one of {SCENARIOS}"
            )
        raise NotImplementedError(DRIVE_CYCLES_PENDING.format(name=self.name))

    def plane(
        self, n_clients: int, *, history: int = 256, device="cuda"
    ) -> FleetSignalPlane:
        return FleetSignalPlane(
            self.signals,
            self.series(n_clients),
            history=history,
            grow_fn=self.series,
            device=device,
        )


#: plane implementations `build_plane` can select
PLANES = ("host", "sharded")


def build_plane(
    name: str,
    n_clients: int,
    seed: int = 0,
    *,
    history: int = 256,
    plane: str = "host",
    device="cuda",
) -> FleetSignalPlane:
    """The one-liner the simulator uses. ``plane="host"`` is the one-device
    plane, its ring on `device`; the client-sharded multi-GPU plane is not
    ported yet."""
    if plane == "host":
        return Scenario(name, seed).plane(n_clients, history=history, device=device)
    if plane == "sharded":
        raise NotImplementedError(
            "the sharded plane is not ported yet: ROADMAP queue 1, "
            "'the multi-GPU plane'"
        )
    raise ValueError(f"unknown plane {plane!r}; pick one of {PLANES}")


# --------------------------------------------------------------------- #
# the legacy constant default                                            #
# --------------------------------------------------------------------- #
def _constant_road_grade_values(n: int) -> np.ndarray:
    """Time-invariant per-vehicle signals; `Vehicle.RoadGrade` reproduces
    the historical ``constant(0.01 * (i % 7))`` exactly. Constant in t so
    runs whose rounds consume different tick counts (lossy vs fault-free)
    still see identical payload inputs."""
    i = np.arange(n, dtype=np.float32)
    grade = np.float32(0.01) * (i % np.float32(7))
    speed = np.full(n, 80.0, np.float32)
    fuel = (0.6 + 0.04 * speed + 60.0 * np.maximum(grade, 0.0)).astype(np.float32)
    temp = np.full(n, 90.0, np.float32)
    return np.stack([speed, fuel, grade, temp], axis=1).astype(np.float32)


# --------------------------------------------------------------------- #
# legacy-path adapters (parity testing, per-vehicle scripting)           #
# --------------------------------------------------------------------- #
def scenario_trace(
    scenario: Scenario, n_clients: int, n_ticks: int
) -> np.ndarray:
    """Materialize `(n_ticks, n_clients, n_signals)` of the scenario —
    tick 0 is the plane's initial state."""
    series = scenario.series(n_clients)
    return np.stack([series(t) for t in range(n_ticks)], axis=0)


def scripted_brokers(
    scenario: Scenario, n_clients: int, n_ticks: int
) -> list[ScriptedSignalBroker]:
    """The same streams through the legacy per-vehicle iterator path.
    Broker i's iterator for signal j yields the identical float32 values
    the plane's row i column j takes at ticks 0..n_ticks-1 (then holds)."""
    trace = scenario_trace(scenario, n_clients, n_ticks)
    return [
        ScriptedSignalBroker(
            {
                name: iter([float(v) for v in trace[:, i, j]])
                for j, name in enumerate(scenario.signals)
            }
        )
        for i in range(n_clients)
    ]
