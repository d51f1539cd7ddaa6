"""repro_torch.fleet — the simulated vehicle fleet: event engine, churn,
service, federated rounds, analytics windows and the simulator that
drives them.

The sharded plane, checkpoints and the drive-cycle scenarios are later
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
from repro_torch.fleet.compression import (
    ErrorFeedback,
    batched_dequant_mean,
    make_codec,
)
from repro_torch.fleet.elastic import FleetPool
from repro_torch.fleet.federated import (
    FEDERATED_PENDING,
    FedConfig,
    aggregate_deltas,
    client_delta,
    local_sgd,
)
from repro_torch.fleet.metrics import FleetMetrics, RoundMetrics
from repro_torch.fleet.rounds import (
    DeadlinePump,
    FederatedDriver,
    RoundInFlight,
    aggregate_packed,
    aggregate_reference,
    mean_reported_loss,
    pump_until_deadline,
    stack_deltas,
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
    "EngineService", "ErrorFeedback", "EventChurn", "EventEngine",
    "FEDERATED_PENDING", "FedConfig", "FederatedDriver", "FleetMetrics",
    "FleetPool", "FleetServiceScheduler", "FleetSimulator", "PHASE_ADMIT",
    "PHASE_CHURN", "PHASE_SERVICE", "PHASE_TIMER", "PLANES", "PlaneBackend",
    "RoundInFlight", "RoundMetrics", "SCENARIOS", "SIGNALS", "Scenario",
    "ServiceBackend", "SimConfig", "WindowInFlight", "WindowStats",
    "aggregate_deltas", "aggregate_packed", "aggregate_reference",
    "batched_dequant_mean", "build_plane", "client_delta", "geometric_gap",
    "local_sgd", "make_churn", "make_codec", "make_service",
    "mean_reported_loss", "merge_moments_reference", "pump_until_deadline",
    "stack_deltas",
]
