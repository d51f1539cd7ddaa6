"""repro_torch.core — the AutoSPADA platform: the paper's primary contribution.

State-based task orchestration for unreliable distributed workers:
centralized versioned state, logical-clock notifications, an Algorithm-1
sync loop on every client, container-semantics task execution, and a
plain-Python user programming model.
"""
from repro_torch.core.broker import (
    Broker,
    FaultPlan,
    client_clock_topic,
    seeded_fault_plan,
)
from repro_torch.core.client import EdgeClient, LocalDisk
from repro_torch.core.documents import (
    Assignment,
    Parameters,
    Payload,
    Result,
    Task,
    TaskStatus,
)
from repro_torch.core.faults import FlakyServer, NetworkError
from repro_torch.core.payload_api import PayloadContext, TaskCanceled, dummy_context
from repro_torch.core.sandbox import ContainerExit, ResourceLimits, run_inline
from repro_torch.core.server import Server, make_platform
from repro_torch.core.signals import (
    CsvSignalBroker,
    FleetSignalPlane,
    PlaneSignalView,
    RandomSignalBroker,
    ScriptedSignalBroker,
    SignalHandler,
)
from repro_torch.core.statestore import StateStore
from repro_torch.core.user import TaskCounts, User

__all__ = [
    "Assignment", "Broker", "ContainerExit", "CsvSignalBroker", "EdgeClient",
    "FaultPlan", "FlakyServer", "FleetSignalPlane", "LocalDisk",
    "NetworkError", "Parameters", "Payload", "PayloadContext",
    "PlaneSignalView", "RandomSignalBroker", "ResourceLimits", "Result",
    "ScriptedSignalBroker", "Server", "SignalHandler", "StateStore", "Task",
    "TaskCanceled", "TaskCounts", "TaskStatus", "User", "client_clock_topic",
    "dummy_context", "make_platform", "run_inline", "seeded_fault_plan",
]
