"""Columnar per-client control-plane state (`FleetColumns`).

At N=100k+ vehicles the object-per-vehicle layout dominates memory and
tick cost long before the device does: every `EdgeClient`,
`ClientRecord`, and document dataclass carried a `__dict__`, and
fleet-wide scalars (logical clocks, sync sequence numbers, power flags,
straggler gating) lived scattered across those dicts. `FleetColumns` is
the structure-of-arrays arena those scalars move into — ONE numpy column
per field, indexed by a stable per-client row:

* ``clock``      int64 — statestore logical clocks (`ClientRecord`);
* ``online``     bool  — power / ignition state (`ClientRecord.online`);
* ``registered`` bool  — client bootstrap handshake (`EdgeClient`);
* ``client_ts``  int64 — client-side logical timestamps (`EdgeClient.ts`);
* ``unacked``    int32 — QoS-1 events awaiting broker acks (`LocalDisk`);
* ``runnable``   bool  — service gating (`FleetServiceScheduler`);
* ``straggler``  bool  — straggler designation (service).

`StateStore`, the service schedulers, and `FleetMetrics` all *view* these
columns instead of copying them, so a fleet-wide gauge (mean clock, count
online, total unacked) is one vectorized reduction. Rows are allocated by
`row_for(client_id)` and coincide with the pool's vehicle index for
`veh-NNN` ids; growth is geometric and preserves data, like the signal
plane's capacity doubling.

`deep_sizeof` is the memory auditor behind `FleetSimulator.memory_report`
— a recursive, memoized `sys.getsizeof` walk that understands numpy
buffers, containers, and slotted objects.
"""
from __future__ import annotations

import sys
from collections import deque
from typing import Any, Iterable

import numpy as np

#: column name -> dtype; the arena's whole schema. Checkpoint snapshots
#: save exactly these arrays (trimmed to n_rows) as content-addressed
#: blobs, so adding a column here automatically threads it through
#: `fleet/checkpoint.py`.
COLUMN_SPECS: dict[str, np.dtype] = {
    "clock": np.dtype(np.int64),
    "online": np.dtype(bool),
    "registered": np.dtype(bool),
    "client_ts": np.dtype(np.int64),
    "unacked": np.dtype(np.int32),
    "runnable": np.dtype(bool),
    "straggler": np.dtype(bool),
}

#: per-column fill for freshly allocated rows
_DEFAULTS: dict[str, Any] = {
    "clock": 0,
    "online": True,
    "registered": True,
    "client_ts": 0,
    "unacked": 0,
    "runnable": False,
    "straggler": False,
}


class FleetColumns:
    """The shared structure-of-arrays arena for per-client scalars.

    One instance per simulated fleet; every control-plane layer holds a
    reference and dereferences `cols.<name>` *at use time* (growth
    reallocates the arrays, so cached references go stale — viewers use
    properties, never stored arrays).
    """

    __slots__ = ("_cap", "n_rows", "_row", *COLUMN_SPECS)

    def __init__(self, capacity: int = 0):
        self._cap = max(1, int(capacity))
        self.n_rows = 0
        #: client_id -> row registry. `veh-NNN` ids land on row NNN by
        #: construction order, matching the pool / plane row index.
        self._row: dict[str, int] = {}
        for name, dtype in COLUMN_SPECS.items():
            setattr(self, name, np.full(self._cap, _DEFAULTS[name], dtype))

    # -- rows ----------------------------------------------------------- #
    def row_of(self, client_id: str) -> int | None:
        """The row for a known client, or None."""
        return self._row.get(client_id)

    def row_for(self, client_id: str) -> int:
        """The row for a client, allocating (and defaulting) a new one."""
        row = self._row.get(client_id)
        if row is None:
            row = self.n_rows
            self.ensure(row + 1)
            self.n_rows = row + 1
            self._row[client_id] = row
            for name in COLUMN_SPECS:
                getattr(self, name)[row] = _DEFAULTS[name]
        return row

    def ensure(self, n: int) -> None:
        """Grow capacity geometrically to hold at least n rows,
        preserving existing data (cheap amortized, like the plane)."""
        if n <= self._cap:
            return
        cap = max(int(n), 2 * self._cap)
        for name, dtype in COLUMN_SPECS.items():
            old = getattr(self, name)
            new = np.full(cap, _DEFAULTS[name], dtype)
            new[: self._cap] = old
            setattr(self, name, new)
        self._cap = cap

    @property
    def capacity(self) -> int:
        return self._cap

    def client_ids(self) -> Iterable[str]:
        return self._row.keys()

    # -- checkpoint surface --------------------------------------------- #
    def snapshot(self) -> dict[str, np.ndarray]:
        """Copies of every column trimmed to live rows (blob payload)."""
        n = self.n_rows
        return {name: getattr(self, name)[:n].copy() for name in COLUMN_SPECS}

    def load(self, arrays: dict[str, np.ndarray], ids: list[str]) -> None:
        """Overwrite the arena from a snapshot: row registry from `ids`
        (in row order), column data from `arrays`."""
        n = len(ids)
        self.ensure(n)
        self.n_rows = n
        self._row = {cid: i for i, cid in enumerate(ids)}
        for name, dtype in COLUMN_SPECS.items():
            col = getattr(self, name)
            col[:n] = np.asarray(arrays[name], dtype)
            col[n : self._cap] = _DEFAULTS[name]

    # -- memory accounting ---------------------------------------------- #
    def nbytes(self) -> int:
        return sum(getattr(self, name).nbytes for name in COLUMN_SPECS)


def deep_sizeof(obj: Any, _seen: set[int] | None = None) -> int:
    """Recursive, memoized memory footprint of a Python object graph.

    numpy arrays count their buffer (`nbytes`), containers recurse, and
    both `__dict__`- and `__slots__`-backed objects walk their fields.
    Shared objects are counted once (identity memo), so columnar views
    don't double-bill the arena.
    """
    seen = _seen if _seen is not None else set()
    oid = id(obj)
    if oid in seen:
        return 0
    seen.add(oid)
    if isinstance(obj, np.ndarray):
        # __sizeof__ counts the buffer only for owning arrays; a view's
        # buffer is billed to its base (walked separately if reachable)
        return int(obj.__sizeof__())
    size = sys.getsizeof(obj)
    if isinstance(obj, dict):
        for k, v in obj.items():
            size += deep_sizeof(k, seen) + deep_sizeof(v, seen)
    elif isinstance(obj, (list, tuple, set, frozenset, deque)):
        for item in obj:
            size += deep_sizeof(item, seen)
    elif isinstance(obj, (str, bytes, bytearray, int, float, bool, complex)):
        pass
    else:
        d = getattr(obj, "__dict__", None)
        if d is not None:
            size += deep_sizeof(d, seen)
        for klass in type(obj).__mro__:
            for slot in getattr(klass, "__slots__", ()):
                if slot in ("__dict__", "__weakref__"):
                    continue
                try:
                    size += deep_sizeof(getattr(obj, slot), seen)
                except AttributeError:
                    pass
    return size
