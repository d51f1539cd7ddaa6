"""Serving: the fleet analyst gateway (`repro_torch.serve.gateway`) and the
LLM serving engine (`repro_torch.serve.engine`)."""
from repro_torch.serve.engine import Request, ServeEngine, serve_loop
from repro_torch.serve.gateway import (
    AnalystSession,
    FleetGateway,
    GatewayRequest,
    GatewayResponse,
    Ticket,
)

__all__ = [
    "AnalystSession", "FleetGateway", "GatewayRequest", "GatewayResponse",
    "Request", "ServeEngine", "Ticket", "serve_loop",
]
