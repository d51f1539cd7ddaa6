"""Network fault injection for the client<->server RPC path.

The paper's resiliency claims (§2.3, §3.3.1) are about intermittent client
availability and unreliable mobile links. `FlakyServer` wraps a stateless
`Server` and fails RPCs according to a deterministic schedule so tests can
drive the sync loop through arbitrary loss patterns.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.server import Server


class NetworkError(Exception):
    """A dropped / timed-out RPC."""


class FlakyServer:
    """Proxy for Server whose calls fail when `should_fail(method, calls)`
    says so. Failure happens *before* the server observes the request for
    fetch-type calls and — worst case for the protocol — *after* the server
    applied it for submit-type calls (the ack is lost, forcing the client
    to retry and exercising idempotency)."""

    #: methods whose ack may be lost after the side effect was applied
    _ACK_LOSS = {"submit"}

    def __init__(
        self,
        inner: Server,
        should_fail: Callable[[str, int], bool] = lambda m, n: False,
    ):
        self._inner = inner
        self._should_fail = should_fail
        self.calls = 0
        self.failed = 0

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if not callable(attr):
            return attr

        def wrapper(*args, **kwargs):
            self.calls += 1
            fail = self._should_fail(name, self.calls)
            if fail and name not in self._ACK_LOSS:
                self.failed += 1
                raise NetworkError(f"{name} dropped (call {self.calls})")
            out = attr(*args, **kwargs)
            if fail:
                self.failed += 1
                raise NetworkError(f"{name} ack lost (call {self.calls})")
            return out

        return wrapper
