"""The in-payload `autospada` client library (paper §5.1).

Core functionality available to payload code:
  * ``get_signal(name)``        — read the latest value of a vehicle signal
  * ``publish(value)``          — publish a JSON-serializable result
  * ``get_parameters()``        — read the task's parameters document
  * ``cache_state(value)``      — persist intermediate state (survives
                                  client restarts; removed on completion)
  * ``load_state()``            — read previously cached state
  * ``sleep(seconds)``          — cancellation-aware sleep

Two modes, matching §5.1.1:
  * **attached** — wired to a live client's signal/result handlers (the
    containerized production path);
  * **dummy**    — stand-alone: random signal values, publishes print to
    stdout, so any payload runs as an ordinary Python script.

Cancellation: a cooperative flag checked on every API call (the in-process
analogue of `docker stop`'s SIGTERM): raises ``TaskCanceled``.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable

import numpy as np


class TaskCanceled(Exception):
    """Raised inside payload code when the task has been canceled."""


#: The frozen user-facing `autospada` contract (paper §5.1). Payload code
#: may rely on exactly these names — in every execution mode (attached,
#: dummy, containerized) and every future release; additions are
#: deliberate API changes and removals are breaking. The sandbox binds
#: the `PayloadContext` instance itself as the `autospada` module, so
#: `autospada.__all__` inside a payload enumerates this same tuple.
#: tests/test_api_surface.py pins it against accidental drift.
AUTOSPADA_API = (
    "get_signal",
    "get_signal_window",
    "get_signal_sketch",
    "publish",
    "get_parameters",
    "cache_state",
    "load_state",
    "clear_state",
    "sleep",
    "time",
)

__all__ = ["AUTOSPADA_API", "PayloadContext", "TaskCanceled", "dummy_context"]


class PayloadContext:
    """One task-container's view of the world.

    The public methods named in `AUTOSPADA_API` are the whole payload
    surface. Two cross-cutting guarantees every method shares:

    * **determinism** — attached contexts read simulated state (signal
      plane rows, parameter documents, the injected clock) that is a pure
      function of the simulation config and tick; a payload that calls
      only this API is replayable bit-for-bit at a fixed seed.
    * **virtual clocks** — `sleep`/`time` run against the injected clock;
      under a simulated (virtual) clock, `sleep` never burns wall time
      and `time` advances only when the world pumps.

    `cancel()` is deliberately *not* part of the payload surface: it is
    the host-side control edge (the `docker stop` analogue).
    """

    #: `import autospada` resolves to this object inside payloads, so the
    #: conventional `__all__` lookup works there too
    __all__ = AUTOSPADA_API

    def __init__(
        self,
        *,
        get_signal: Callable[[str], float | None],
        publish: Callable[[Any], None],
        parameters: Any = None,
        state_cache: dict[str, Any] | None = None,
        task_key: str = "local",
        cancel_event: threading.Event | None = None,
        clock: Callable[[], float] = time.monotonic,
        get_signal_window: Callable[[str, int], list[float]] | None = None,
        get_signal_sketch: Callable[..., dict | None] | None = None,
        virtual_clock: bool | None = None,
    ):
        self._get_signal = get_signal
        self._get_signal_window = get_signal_window
        self._get_signal_sketch = get_signal_sketch
        self._publish = publish
        self._parameters = parameters
        self._state_cache = state_cache if state_cache is not None else {}
        self._task_key = task_key
        self._cancel = cancel_event or threading.Event()
        self._clock = clock
        # A virtual (simulated) clock means `sleep` must never burn real
        # wall-clock waiting on it — fleet-scale sims inject clocks that
        # only advance when the world pumps. Callers injecting a wrapped
        # wall clock should pass virtual_clock=False explicitly; the
        # default recognizes the stdlib wall clocks by identity.
        if virtual_clock is None:
            virtual_clock = clock not in (
                time.monotonic, time.time, time.perf_counter
            )
        self._virtual_clock = virtual_clock
        self.published_count = 0

    # -- cancellation ------------------------------------------------- #
    def _check_cancel(self) -> None:
        if self._cancel.is_set():
            raise TaskCanceled(self._task_key)

    def cancel(self) -> None:
        self._cancel.set()

    # -- the user-facing API (AUTOSPADA_API — the frozen contract) ----- #
    def get_signal(self, name: str) -> float | None:
        """Latest value of a vehicle signal, or None if unknown. Attached
        contexts read the deterministic signal plane (a pure function of
        scenario, seed, and tick); the dummy context draws seeded
        randoms."""
        self._check_cancel()
        return self._get_signal(name)

    def get_signal_window(self, name: str, k: int) -> list[float]:
        """Last `k` *observed* values of a signal, oldest first — the
        input to on-vehicle windowed analytics. "Observed" means ticks
        the vehicle was powered on: offline ticks record nothing, so
        the list may be shorter than `k` (as may a vehicle younger than
        `k` ticks, or a history ring smaller than `k`). Unknown signals
        return ``[]``. Sources without history fall back to a single
        latest-value sample; attached contexts serve the signal plane's
        ring, synced to the host lazily on first read."""
        self._check_cancel()
        if self._get_signal_window is not None:
            return [float(v) for v in self._get_signal_window(name, k)]
        v = self._get_signal(name)
        return [] if v is None else [float(v)]

    def get_signal_sketch(
        self,
        name: str,
        k: int,
        *,
        bins: int = 16,
        lo: float = 0.0,
        hi: float = 12.0,
        quantile_k: int = 32,
    ) -> dict:
        """Compact mergeable sketch of the last `k` observed values of a
        signal: ``{"count", "mean", "m2", "hist", "qsk"}`` — sample
        count, float32 Welford mean and sum of squared deviations, a
        `bins`-bin [lo, hi) histogram (outliers clipped to the edge
        bins), and `quantile_k` equal-weight ranked values (a KLL-style
        quantile summary; empty when count is 0). Sketches from many
        vehicles merge exactly (`kernels.ops.merge_moments` /
        `merge_histograms` / `merge_quantile_sketches`), which is the
        point: only sketch-sized results leave the vehicle, never the
        window itself.

        Exactly the observations `get_signal_window(name, k)` would
        return are folded — offline-tick masking and short histories
        included. Plane-attached contexts answer from one fused fleet-
        wide device fold over the signal ring (cached per tick, the
        ring never syncs to the host); every other source folds the
        window through the identical float32 reference formula
        (`kernels.sketch.sketch_reference`), so the result is
        bit-for-bit the same either way."""
        self._check_cancel()
        if self._get_signal_sketch is not None:
            sk = self._get_signal_sketch(
                name, int(k), int(bins), float(lo), float(hi), int(quantile_k)
            )
            if sk is not None:
                return sk
        from repro_torch.kernels.sketch import SketchSpec, sketch_reference

        spec = SketchSpec(
            window=max(1, int(k)), bins=int(bins), lo=float(lo), hi=float(hi),
            quantile_k=int(quantile_k),
        )
        return sketch_reference(self.get_signal_window(name, int(k)), spec)

    def publish(self, value: Any) -> None:
        """Publish a JSON-serializable result to the platform. Delivery
        is at-least-once (QoS 1): the server deduplicates by sequence
        number, so publishing is idempotent end to end."""
        self._check_cancel()
        json.dumps(value, default=str)  # enforce JSON-serializability
        self._publish(value)
        self.published_count += 1

    def get_parameters(self) -> Any:
        """The task's immutable Parameters document (None if the task
        carries none). Identical on every read and every re-run."""
        self._check_cancel()
        return self._parameters

    def cache_state(self, value: Any) -> None:
        """Persist intermediate state under the task's key: it survives
        client restarts and is removed when the task completes."""
        self._check_cancel()
        self._state_cache[self._task_key] = value

    def load_state(self) -> Any:
        """Previously cached state for this task, or None."""
        self._check_cancel()
        return self._state_cache.get(self._task_key)

    def clear_state(self) -> None:
        """Drop this task's cached state (idempotent)."""
        self._state_cache.pop(self._task_key, None)

    def sleep(self, seconds: float) -> None:
        """Cancellation-aware sleep; in simulation the clock is virtual.

        With a wall clock this naps in small slices so cancellation stays
        responsive. With an injected virtual clock it must NOT nap for
        real — a simulated 5 s sleep across 1000 vehicles would otherwise
        burn actual wall-clock — so it only yields the GIL between
        cancellation checks while waiting for the simulation to advance
        the clock."""
        deadline = self._clock() + seconds
        while self._clock() < deadline:
            self._check_cancel()
            if self._virtual_clock:
                time.sleep(0)  # yield only; virtual time is free
            else:
                time.sleep(min(0.002, max(0.0, deadline - self._clock())))

    def time(self) -> float:
        """The task's clock. Under a virtual (simulated) clock this is
        logical time that advances only when the world pumps — never
        wall time — so payload timing logic stays deterministic."""
        return self._clock()


def dummy_context(seed: int = 0, parameters: Any = None) -> PayloadContext:
    """Paper §5.1.1: 'By default, the autospada library acts as a dummy
    library that returns random values for any signal and prints messages
    to standard output when side effects occur.'"""
    rng = np.random.default_rng(seed)

    def get_signal(name: str) -> float:
        return float(rng.standard_normal())

    def get_signal_window(name: str, k: int) -> list[float]:
        return [float(v) for v in rng.standard_normal(max(0, int(k)))]

    def publish(value: Any) -> None:
        print(f"[autospada dummy] publish: {json.dumps(value, default=str)}")

    return PayloadContext(
        get_signal=get_signal,
        get_signal_window=get_signal_window,
        publish=publish,
        parameters=parameters,
    )
