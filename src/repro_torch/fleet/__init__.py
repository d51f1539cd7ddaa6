"""repro_torch.fleet — the simulated vehicle fleet: event engine, churn,
service, analytics windows and the simulator that drives them.

The federated round's math, the sharded plane and checkpoints are later
slices of the port (ROADMAP queue 1).
"""
from repro_torch.fleet.analytics import (
    AnalyticsConfig,
    AnalyticsDriver,
    WindowInFlight,
    WindowStats,
    merge_moments_reference,
)
from repro_torch.fleet.churn import DenseChurn, EventChurn, geometric_gap, make_churn
from repro_torch.fleet.engine import (
    PHASE_ADMIT,
    PHASE_CHURN,
    PHASE_SERVICE,
    PHASE_TIMER,
    EngineService,
    EventEngine,
)
from repro_torch.fleet.elastic import FleetPool
from repro_torch.fleet.federated import FEDERATED_PENDING, FedConfig
from repro_torch.fleet.metrics import FleetMetrics, RoundMetrics
from repro_torch.fleet.rounds import (
    DeadlinePump,
    FederatedDriver,
    RoundInFlight,
    mean_reported_loss,
    pump_until_deadline,
)
from repro_torch.fleet.scenarios import PLANES, SCENARIOS, SIGNALS, Scenario, build_plane
from repro_torch.fleet.service import (
    DensePollService,
    FleetServiceScheduler,
    make_service,
)
from repro_torch.fleet.simulator import (
    Backends,
    ChurnBackend,
    EngineBackend,
    FleetSimulator,
    PlaneBackend,
    ServiceBackend,
    SimConfig,
)

__all__ = [
    "AnalyticsConfig", "AnalyticsDriver", "Backends", "ChurnBackend",
    "DeadlinePump", "DenseChurn", "DensePollService", "EngineBackend",
    "EngineService", "EventChurn", "EventEngine", "FEDERATED_PENDING",
    "FedConfig", "FederatedDriver", "FleetMetrics", "FleetPool",
    "FleetServiceScheduler", "FleetSimulator", "PHASE_ADMIT", "PHASE_CHURN",
    "PHASE_SERVICE", "PHASE_TIMER", "PLANES", "PlaneBackend", "RoundInFlight",
    "RoundMetrics", "SCENARIOS", "SIGNALS", "Scenario", "ServiceBackend",
    "SimConfig", "WindowInFlight", "WindowStats", "build_plane",
    "geometric_gap", "make_churn", "make_service", "mean_reported_loss",
    "merge_moments_reference", "pump_until_deadline",
]
