"""Serving: the fleet analyst gateway (`repro_torch.serve.gateway`).
The LLM serving engine is not ported yet (ROADMAP queue 1)."""
from repro_torch.serve.gateway import (
    AnalystSession,
    FleetGateway,
    GatewayRequest,
    GatewayResponse,
    Ticket,
)

__all__ = [
    "AnalystSession", "FleetGateway", "GatewayRequest", "GatewayResponse",
    "Ticket",
]
