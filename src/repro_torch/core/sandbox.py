"""Container-semantics payload runner (paper §3.6, §4.2.2).

Docker gives the paper three things: (1) isolation of task code from the
host, (2) per-task resource limits, (3) a supervision contract — exit code
0 => FINISHED, non-zero => ERROR with logs uploaded, `docker stop` =>
forced exit on cancel. There is no Docker daemon in this environment, so
we reproduce the *contract*:

* payload source is executed in a restricted namespace (fresh module dict,
  curated builtins — no file/network access by default) — the isolation
  boundary is best-effort in-process, and documented as such in DESIGN.md;
* stdout/stderr are captured as the container log; an uncaught exception
  is a non-zero exit whose log is uploaded with the ERROR status;
* a cooperative cancel flag plays SIGTERM;
* resource accounting: wall/CPU time and published-result quotas, checked
  cooperatively (the paper's future-work §8.1.2 resource quotas).

Two run modes:
* ``run_inline``  — execute to completion on the caller's thread
  (deterministic simulation / property tests);
* ``ContainerThread`` — daemon-thread execution with an event queue
  (live examples, long-running payloads).
"""
from __future__ import annotations

import builtins
import contextlib
import dataclasses
import io
import threading
import time
import traceback
from typing import Any, Callable

from repro_torch.core.payload_api import PayloadContext, TaskCanceled

# Builtins exposed to payload code. Deliberately excludes open/__import__-
# anything-goes; `import` of a whitelisted module set is allowed below.
_SAFE_BUILTIN_NAMES = [
    "abs", "all", "any", "bool", "bytes", "callable", "chr", "dict", "divmod",
    "enumerate", "filter", "float", "format", "frozenset", "getattr", "hasattr",
    "hash", "int", "isinstance", "issubclass", "iter", "len", "list", "map",
    "max", "min", "next", "object", "ord", "pow", "print", "range", "repr",
    "reversed", "round", "set", "setattr", "slice", "sorted", "str", "sum",
    "tuple", "type", "zip", "Exception", "ValueError", "TypeError", "KeyError",
    "IndexError", "RuntimeError", "StopIteration", "ZeroDivisionError", "True",
    "False", "None", "__build_class__", "__name__",
]

_ALLOWED_MODULES = {
    "math", "statistics", "json", "random", "collections", "itertools",
    "functools", "time", "base64", "struct", "numpy",
}


def _make_safe_import(ctx: "PayloadContext"):
    """`import autospada` inside a payload binds the task's context object
    (paper Listing 1); everything else resolves against a whitelist."""

    def _safe_import(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "autospada":
            return ctx
        root = name.split(".")[0]
        if name in _ALLOWED_MODULES or root in {
            m.split(".")[0] for m in _ALLOWED_MODULES
        }:
            return builtins.__import__(name, globals, locals, fromlist, level)
        raise ImportError(
            f"module {name!r} is not available inside task containers"
        )

    return _safe_import


@dataclasses.dataclass
class ResourceLimits:
    """Cooperative quotas (paper §8.1.2 — 'amount of CPU and RAM that a
    task can allocate needs to be controllable')."""

    max_wall_seconds: float | None = None
    max_results: int | None = None


@dataclasses.dataclass
class ContainerExit:
    exit_code: int
    log: str
    canceled: bool = False

    @property
    def ok(self) -> bool:
        return self.exit_code == 0 and not self.canceled


class QuotaExceeded(Exception):
    pass


# Payload documents are immutable (paper §3.4.1) and one payload is shared
# by every task of an assignment, so at fleet scale the same source runs
# thousands of times per round. Cache the compiled code object per source.
_CODE_CACHE: dict[str, Any] = {}
_CODE_CACHE_MAX = 256


def _compiled(source: str):
    code = _CODE_CACHE.get(source)
    if code is None:
        if len(_CODE_CACHE) >= _CODE_CACHE_MAX:
            # evict the oldest entry (dict preserves insertion order) so
            # hot payloads survive a churn of one-off sources
            _CODE_CACHE.pop(next(iter(_CODE_CACHE)))
        code = compile(source, "<payload>", "exec")
        _CODE_CACHE[source] = code
    return code


def run_inline(
    source: str,
    ctx: PayloadContext,
    limits: ResourceLimits | None = None,
    extra_globals: dict[str, Any] | None = None,
) -> ContainerExit:
    """Execute payload `source` to completion under container semantics."""
    limits = limits or ResourceLimits()
    log = io.StringIO()
    start = time.monotonic()

    original_publish = ctx.publish

    def quota_publish(value: Any) -> None:
        if (
            limits.max_results is not None
            and ctx.published_count >= limits.max_results
        ):
            raise QuotaExceeded(f"max_results={limits.max_results}")
        if (
            limits.max_wall_seconds is not None
            and time.monotonic() - start > limits.max_wall_seconds
        ):
            raise QuotaExceeded(f"max_wall_seconds={limits.max_wall_seconds}")
        original_publish(value)

    ctx.publish = quota_publish  # type: ignore[method-assign]

    safe_builtins = {n: getattr(builtins, n) for n in _SAFE_BUILTIN_NAMES
                     if hasattr(builtins, n)}
    safe_builtins["True"], safe_builtins["False"], safe_builtins["None"] = (
        True, False, None,
    )
    safe_builtins["__import__"] = _make_safe_import(ctx)
    glb: dict[str, Any] = {
        "__builtins__": safe_builtins,
        "__name__": "__autospada_payload__",
        "autospada": ctx,
    }
    if extra_globals:
        glb.update(extra_globals)

    try:
        with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
            exec(_compiled(source), glb)  # noqa: S102
        return ContainerExit(exit_code=0, log=log.getvalue())
    except TaskCanceled:
        return ContainerExit(exit_code=137, log=log.getvalue(), canceled=True)
    except BaseException:  # noqa: BLE001 — any crash is a container error
        log.write(traceback.format_exc())
        return ContainerExit(exit_code=1, log=log.getvalue())
    finally:
        ctx.publish = original_publish  # type: ignore[method-assign]


class ContainerThread:
    """Daemon-thread container with a supervisor callback — the in-process
    analogue of paper §4.2.2's per-task supervisor thread."""

    def __init__(
        self,
        source: str,
        ctx: PayloadContext,
        on_exit: Callable[[ContainerExit], None],
        limits: ResourceLimits | None = None,
    ):
        self._source = source
        self._ctx = ctx
        self._on_exit = on_exit
        self._limits = limits
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.exit: ContainerExit | None = None

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        self.exit = run_inline(self._source, self._ctx, self._limits)
        self._on_exit(self.exit)

    def stop(self) -> None:
        """`docker stop`: signal cancellation; the payload exits at its next
        API call."""
        self._ctx.cancel()

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)

    @property
    def running(self) -> bool:
        return self._thread.is_alive()
