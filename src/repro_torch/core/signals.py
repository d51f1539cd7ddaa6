"""Signal sources (paper §4.2.4).

The paper's Signal Handler subscribes to the WICE Signal Broker (CAN /
FlexRay buses) and keeps the *latest observed value* per signal in memory —
"the simplest way to determine the present value of stateful and infrequent
signals". We reproduce that normalization layer:

* `SignalBroker` — abstract pub/sub signal source;
* `RandomSignalBroker` — the paper's §5.1.1 "dummy library" behaviour
  (random values for any signal) used for local payload testing;
* `CsvSignalBroker` — the paper's §5.1.1 CSV playback ("control the values
  of signals by providing a CSV file with hard-coded signal values");
* `ScriptedSignalBroker` — deterministic programmable source for tests and
  single-vehicle scripting;
* `SignalHandler` — the client-side proxy + latest-value cache that tasks
  actually read from, insulating payloads from the concrete source.

Fleet scale changed the shape of this layer. Per-vehicle iterator brokers
cost O(n_clients × n_signals) Python per simulation tick — the dominant
cost at 1000+ vehicles — so the fleet's signals now live in one columnar
structure of arrays:

* `FleetSignalPlane` — the whole fleet's latest values as a single
  `(n_clients, n_signals)` float32 matrix plus a rolling-history ring
  that lives on the plane's device, advanced by ONE call per simulator
  tick (a scenario step, see `repro_torch.fleet.scenarios`);
* `PlaneSignalView` — a per-vehicle `SignalBroker` that is just a row
  index into the plane. `SignalHandler.get` reads through it, so payload
  code (`autospada.get_signal`) is unchanged.

`ScriptedSignalBroker`/`CsvSignalBroker` remain supported both standalone
(push semantics, exactly as before) and as *adapters* into the plane:
`FleetSignalPlane.from_trace` / `from_csv_fleet` load their columns and
play them back with identical latest-value semantics (blank cells hold the
previous value; exhausted columns hold their last value).
"""
from __future__ import annotations

import csv
import io
import itertools
import math
import threading
from collections import deque
from typing import Callable, Iterable, Iterator, Mapping, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


class SignalBroker:
    """Pub/sub source of (signal_name, value) observations."""

    def subscribe(self, names: Iterable[str], cb: Callable[[str, float], None]) -> None:
        raise NotImplementedError

    def tick(self) -> None:
        """Advance the source one step (simulation hook)."""
        raise NotImplementedError


class RandomSignalBroker(SignalBroker):
    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._subs: list[tuple[list[str], Callable[[str, float], None]]] = []

    def subscribe(self, names, cb):
        self._subs.append((list(names), cb))
        for n in list(names):  # immediately provide a value
            cb(n, float(self._rng.standard_normal()))

    def tick(self):
        for names, cb in self._subs:
            for n in names:
                cb(n, float(self._rng.standard_normal()))


class ScriptedSignalBroker(SignalBroker):
    """Signals driven by user-supplied iterators — deterministic tests.

    Subscription delivers the next scripted value immediately (MQTT
    retained-message semantics): a late subscriber still observes the
    signal's current value, matching the paper's latest-value cache intent.

    An iterator may yield ``None`` to mean "no observation this tick" —
    the subscriber's latest-value cache simply holds the previous value.
    This keeps multi-column sources (CSV playback) tick-aligned when one
    column has gaps.
    """

    def __init__(self, scripts: Mapping[str, Iterator[float]]):
        self._scripts = {k: iter(v) for k, v in scripts.items()}
        self._subs: list[tuple[list[str], Callable[[str, float], None]]] = []

    def _emit(self, name: str, cb: Callable[[str, float], None]) -> None:
        it = self._scripts.get(name)
        if it is None:
            return
        try:
            v = next(it)
        except StopIteration:
            return
        if v is not None:
            cb(name, float(v))

    def subscribe(self, names, cb):
        self._subs.append((list(names), cb))
        for n in list(names):
            self._emit(n, cb)

    def tick(self):
        for names, cb in self._subs:
            for n in names:
                self._emit(n, cb)


class CsvSignalBroker(ScriptedSignalBroker):
    """CSV playback: one column per signal, one row per tick.

    Robust to real-world CSVs: blank cells are skipped (the latest-value
    cache holds the previous observation for that tick), ragged rows and
    non-numeric cells raise errors naming the offending column and row.
    """

    def __init__(self, csv_text: str):
        columns = parse_signal_csv(csv_text)
        super().__init__({k: iter(v) for k, v in columns.items()})


def iter_signal_csv(csv_text: str) -> Iterator[list]:
    """Stream a signals CSV: yields the stripped header row first, then
    one ``list[float | None]`` per data tick (blank cells -> ``None``,
    header-aligned). This is the single source of CSV validation — a row
    with more or fewer cells than the header, or a non-numeric cell,
    raises ``ValueError`` naming the column and the 1-based data row
    (blank lines count toward row numbers but yield no tick).
    """
    reader = csv.reader(io.StringIO(csv_text))
    try:
        header = next(reader)
    except StopIteration:
        raise ValueError("signals CSV is empty (no header row)") from None
    header = [h.strip() for h in header]
    dupes = {n for n in header if header.count(n) > 1}
    if dupes:
        raise ValueError(
            f"signals CSV header repeats column(s): {', '.join(sorted(dupes))}"
        )
    yield header
    for rownum, row in enumerate(reader, start=1):
        if not row or (len(row) == 1 and not row[0].strip()):
            continue  # ignore trailing/blank lines entirely
        if len(row) != len(header):
            raise ValueError(
                f"signals CSV row {rownum} has {len(row)} cells, expected "
                f"{len(header)} (columns: {', '.join(header)})"
            )
        parsed: list[float | None] = []
        for name, cell in zip(header, row):
            cell = cell.strip()
            if not cell:
                parsed.append(None)  # blank: hold previous value
                continue
            try:
                parsed.append(float(cell))
            except ValueError:
                raise ValueError(
                    f"signals CSV column {name!r}, row {rownum}: "
                    f"cannot parse {cell!r} as a number"
                ) from None
        yield parsed


def parse_signal_csv(csv_text: str) -> dict[str, list[float | None]]:
    """Parse a signals CSV into tick-aligned columns (the materializing
    wrapper over `iter_signal_csv`; identical validation and errors)."""
    rows = iter_signal_csv(csv_text)
    header = next(rows)
    columns: dict[str, list[float | None]] = {name: [] for name in header}
    for parsed in rows:
        for name, v in zip(header, parsed):
            columns[name].append(v)
    return columns


class CsvFleetStream:
    """Constant-memory playback of one-CSV-per-vehicle signal traces.

    The materializing loader builds the whole `(n_ticks, n_vehicles,
    n_signals)` trace before the plane sees a single row — O(T·N·S)
    float32, the ingestion bottleneck of a 100k-vehicle campaign. This
    streams instead: pass 1 replays every CSV once through
    `iter_signal_csv` to validate all cells (the same errors the
    materializing path raises, still eager at construction) and collect
    the signal-name union; pass 2 replays rows one tick at a time into a
    single `(n_vehicles, n_signals)` latest-value matrix with per-cell
    forward fill. The working set is that one matrix — independent of
    trace length.

    `series` satisfies the plane's ``series_fn`` contract and is
    forward-only (monotonic ticks; asking for the current tick again
    returns the cached row). Exhausted vehicles hold their last row and
    signals a vehicle never reports stay NaN, so the resulting plane is
    bit-for-bit identical to `from_trace` over the materialized trace —
    `tests/test_signal_plane.py` pins the parity.
    """

    def __init__(self, csv_texts: Sequence[str]):
        self._texts = list(csv_texts)
        names: set[str] = set()
        for text in self._texts:  # pass 1: validate everything, eagerly
            rows = iter_signal_csv(text)
            names.update(next(rows))
            for _ in rows:
                pass
        self.names: tuple[str, ...] = tuple(sorted(names))
        col = {n: j for j, n in enumerate(self.names)}
        self._iters: list[Iterator[list]] = []
        self._cols: list[list[int]] = []  # header position -> plane column
        for text in self._texts:  # pass 2: playback iterators
            rows = iter_signal_csv(text)
            self._cols.append([col[n] for n in next(rows)])
            self._iters.append(rows)
        self._current = np.full(
            (len(self._texts), len(self.names)), np.nan, np.float32
        )
        self._t = -1

    def series(self, t: int) -> np.ndarray:
        if t == self._t:
            return self._current
        if t != self._t + 1:
            raise ValueError(
                f"CSV stream is forward-only: asked for tick {t} "
                f"at tick {self._t}"
            )
        self._t = t
        cur = self._current
        for i, rows in enumerate(self._iters):
            parsed = next(rows, None)
            if parsed is None:
                continue  # exhausted: hold the last row (latest-value)
            for j, v in zip(self._cols[i], parsed):
                if v is not None:
                    cur[i, j] = v
        return cur


# --------------------------------------------------------------------- #
# the columnar fleet signal plane                                        #
# --------------------------------------------------------------------- #
class FleetSignalPlane:
    """Structure-of-arrays latest-value store for an entire fleet, with its
    history ring as a tensor on the plane's device.

    ``values`` is the `(n_clients, n_signals)` float32 host matrix of
    every vehicle's current signal readings; ``step()`` advances the whole
    fleet with ONE call to ``series_fn(t)`` (a scenario step from
    `repro_torch.fleet.scenarios`, or a trace playback) and writes one ring
    slot in place on the device. The ring of the last ``history`` ticks
    backs windowed on-vehicle analytics (`autospada.get_signal_window`)
    and the fleet-wide sketch fold, which runs where the ring lives: only
    the `(3 + bins + K, n)` sketch block moves to the host.

    The ring is signal-major, `(history, n_signals, capacity)`, so that one
    signal's window is a `(W, capacity)` block whose client columns are
    contiguous and the fold's reads coalesce. (The JAX package keeps it
    client-major, `(history, capacity, n_signals)`; `plane_from_reference`
    and `plane_to_numpy` transpose between the two.) `window()` returns
    exactly what the JAX package's plane returns.

    Per-vehicle access goes through `view(row)` — a `PlaneSignalView`
    satisfying the `SignalBroker` interface, so `SignalHandler` and every
    payload keep working unchanged.

    NaN is the "no observation yet" marker: `read` maps it to ``None``
    (exactly what `SignalHandler.get` returns before a push broker's first
    callback).

    Growth is amortized: rows are overallocated geometrically (capacity
    doubling, controlled by ``growth``), so mass admission of N vehicles
    rebuilds the series and reallocates the history ring only O(log N)
    times, not N times. The generators are row-stable, so computing the
    spare capacity rows is harmless; ``values`` always exposes exactly the
    `n_clients` live rows.

    Offline semantics: plane *time* is fleet-global (every row's current
    value advances each `step`), but the history ring NaN-masks rows whose
    vehicle is powered off (`set_online`), so
    ``autospada.get_signal_window`` after re-ignition only contains values
    observed while the ignition was on. The `values` matrix itself is
    untouched by masking.
    """

    def __init__(
        self,
        names: Sequence[str],
        series_fn: Callable[[int], np.ndarray],
        *,
        history: int = 256,
        grow_fn: Callable[[int], Callable[[int], np.ndarray]] | None = None,
        growth: float = 2.0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.names: tuple[str, ...] = tuple(names)
        self._col = {n: j for j, n in enumerate(self.names)}
        self._series_fn = series_fn
        self._grow_fn = grow_fn
        self._growth = max(1.0, float(growth))
        self.t = 0
        self._values = np.array(series_fn(0), np.float32, copy=True)
        if self._values.ndim != 2 or self._values.shape[1] != len(self.names):
            raise ValueError(
                f"series_fn must return (n_clients, {len(self.names)}), "
                f"got {self._values.shape}"
            )
        self.n_clients = self._values.shape[0]
        self._capacity = self._values.shape[0]
        self._offline = np.zeros(self._capacity, bool)
        self._hist_cap = max(1, int(history))
        self._hist = torch.full(
            (self._hist_cap, len(self.names), self._capacity),
            torch.nan,
            dtype=torch.float32,
            device=self.device,
        )
        self._write_slot(0, self._values)
        self._hist_len = 1
        # one fleet-wide sketch per (tick, fleet size, signal, spec) —
        # see sketch_row
        self._sketch_cache: dict = {}

    @property
    def values(self) -> np.ndarray:
        """The live fleet's `(n_clients, n_signals)` latest values (a view
        into the capacity-sized backing array)."""
        return self._values[: self.n_clients]

    # -- construction adapters ----------------------------------------- #
    @classmethod
    def from_trace(
        cls,
        names: Sequence[str],
        trace: np.ndarray,
        *,
        history: int = 256,
        device="cuda",
    ) -> "FleetSignalPlane":
        """Play back a precomputed `(n_ticks, n_clients, n_signals)` trace.

        Ticks past the end hold the final row (latest-value semantics, the
        plane analogue of an exhausted scripted iterator)."""
        trace = np.asarray(trace, np.float32)
        if trace.ndim != 3 or trace.shape[2] != len(names):
            raise ValueError(f"trace must be (T, n, {len(names)}), got {trace.shape}")
        last = trace.shape[0] - 1

        def series(t: int) -> np.ndarray:
            return trace[min(t, last)]

        return cls(names, series, history=history, device=device)

    @classmethod
    def from_csv_fleet(
        cls,
        csv_texts: Sequence[str],
        *,
        history: int = 256,
        streamed: bool = True,
        device="cuda",
    ) -> "FleetSignalPlane":
        """Load one CSV per vehicle into a single plane (the
        `CsvSignalBroker` adapter path). Columns are tick-aligned; blank
        cells hold the previous value (leading blanks read as ``None``),
        short columns hold their last value.

        ``streamed`` (the default) replays rows through `CsvFleetStream`
        — one latest-value matrix of working memory regardless of trace
        length. ``streamed=False`` keeps the whole-trace materialization
        as the parity oracle; both produce bit-identical planes."""
        if streamed:
            stream = CsvFleetStream(csv_texts)
            return cls(stream.names, stream.series, history=history, device=device)
        per_vehicle = [parse_signal_csv(text) for text in csv_texts]
        names = sorted({n for cols in per_vehicle for n in cols})
        n_ticks = max(
            (len(v) for cols in per_vehicle for v in cols.values()), default=0
        )
        n_ticks = max(1, n_ticks)
        trace = np.full((n_ticks, len(csv_texts), len(names)), np.nan, np.float32)
        for i, cols in enumerate(per_vehicle):
            for j, name in enumerate(names):
                col = cols.get(name, [])
                last = math.nan
                for t in range(n_ticks):
                    v = col[t] if t < len(col) else None
                    if v is not None:
                        last = v
                    trace[t, i, j] = last
        return cls.from_trace(names, trace, history=history, device=device)

    # -- the hot path --------------------------------------------------- #
    def _write_slot(self, slot: int, rows: np.ndarray) -> None:
        """Copy a `(capacity, n_signals)` host matrix into ring slot `slot`
        in place: one host->device copy of the transposed matrix."""
        self._hist[slot].copy_(torch.from_numpy(np.ascontiguousarray(rows.T)))

    def step(self) -> None:
        """Advance every vehicle's every signal: one series_fn call, one
        ring write. This is the whole fleet's per-tick signal cost.
        Offline rows are NaN-masked in the ring (not in `values`): a
        powered-off vehicle observes nothing while the ignition is off."""
        self.t += 1
        self._values = np.asarray(self._series_fn(self.t), np.float32)
        rows = self._values
        if self._offline.any():
            rows = rows.copy()
            rows[self._offline] = np.nan
        self._write_slot(self.t % self._hist_cap, rows)
        self._hist_len = min(self._hist_len + 1, self._hist_cap)

    def _check_row(self, row: int) -> int:
        """Spare capacity rows hold real scenario values (step computes the
        whole backing array), so an out-of-range row must fail fast rather
        than silently return a phantom vehicle's signals."""
        row = int(row)
        if not 0 <= row < self.n_clients:
            raise IndexError(
                f"row {row} out of range for a {self.n_clients}-vehicle plane"
            )
        return row

    def set_online(self, row: int, online: bool) -> None:
        """Ignition state for history-ring masking. While a row is offline
        its ring entries are NaN ("nothing observed"); the latest-value
        matrix keeps advancing because plane time is fleet-global."""
        self._offline[self._check_row(row)] = not online

    # -- per-vehicle reads ---------------------------------------------- #
    def read(self, row: int, name: str) -> float | None:
        row = self._check_row(row)
        j = self._col.get(name)
        if j is None:
            return None
        v = float(self._values[row, j])
        return None if math.isnan(v) else v

    def window(self, row: int, name: str, k: int) -> list[float]:
        """Last `k` observed values for one vehicle's signal, oldest
        first (at most `history`; NaN "not yet observed" entries are
        skipped, mirroring a push subscriber that saw no callback)."""
        row = self._check_row(row)
        j = self._col.get(name)
        if j is None:
            return []
        k = max(0, min(int(k), self._hist_len))
        start = self.t - k + 1
        idx = [(start + i) % self._hist_cap for i in range(k)]
        vals = self._hist[idx, j, row].cpu().numpy()
        return [float(v) for v in vals if not math.isnan(v)]

    # -- fused windowed sketches ---------------------------------------- #
    def compute_sketches(self, name: str, spec):
        """Fold every vehicle's last-`spec.window` observations of one
        signal into compact sketches (Welford moments, fixed-bin
        histogram, quantile summary) in one fold over the ring where it
        lives — `kernels.sketch.sketch_ring`, the CUDA kernel on the card —
        instead of n_clients `window()` reads + Python folds.

        Each row is bit-identical to `sketch_reference` over that
        vehicle's `window()` (offline-NaN and short-history truncation
        included)."""
        from repro_torch.kernels import sketch as _sk

        col = self._col.get(name)
        n = self.n_clients
        if col is None or n == 0:
            return _sk.empty_fleet_sketches(spec, n)
        out = _sk.sketch_ring(self._hist, self.t, self._hist_len, col, spec)
        return _sk.sketches_from_device(spec, out[:, :n].cpu().numpy())

    def fleet_sketch(self, name: str, spec):
        """The fleet-wide sketch fold, served from the per-tick cache:
        the first caller at a given (tick, fleet size) triggers one
        `compute_sketches` call; every other caller that tick — another
        vehicle's payload, an analyst's gateway query — gets the cached
        `FleetSketches` back without touching the ring. The key carries
        `t` and `n_clients` so `step()`/`add_client` invalidate for free
        (`set_online` only affects *future* ring writes, so it doesn't
        need to)."""
        key = (self.t, self.n_clients, name, spec)
        sk = self._sketch_cache.get(key)
        if sk is None:
            self._sketch_cache.clear()
            sk = self.compute_sketches(name, spec)
            self._sketch_cache[key] = sk
        return sk

    def sketch_row(self, row: int, name: str, spec) -> dict:
        """One vehicle's windowed sketch out of the cached fleet-wide
        fold (`fleet_sketch`) — an O(1) dict build on every cache hit."""
        row = self._check_row(row)
        return self.fleet_sketch(name, spec).row(row)

    def view(self, row: int) -> "PlaneSignalView":
        return PlaneSignalView(self, self._check_row(row))

    # -- fleet growth ---------------------------------------------------- #
    def _ensure_capacity(self, n: int) -> None:
        """Grow the backing arrays to hold >= n rows, geometrically: the
        series rebuild and the history-ring reallocation happen O(log n)
        times across n joins."""
        if n <= self._capacity:
            return
        if self._grow_fn is None:
            raise ValueError(
                "this plane has a fixed fleet size (no grow_fn); "
                "construct it via a scenario to support add_client"
            )
        cap = max(n, int(math.ceil(self._capacity * self._growth)))
        self._series_fn = self._grow_fn(cap)
        # row-stable generators: rows < n_clients come back unchanged
        self._values = np.array(self._series_fn(self.t), np.float32, copy=True)
        hist = torch.full(
            (self._hist_cap, len(self.names), cap),
            torch.nan,
            dtype=torch.float32,
            device=self.device,
        )
        hist[:, :, : self._capacity] = self._hist
        self._hist = hist
        offline = np.zeros(cap, bool)
        offline[: self._capacity] = self._offline
        self._offline = offline
        self._capacity = cap

    def add_client(self) -> int:
        """A new vehicle joins. Amortized O(1): within spare capacity only
        the new row's ring history is initialized (NaN except the current
        tick — a join must not expose values 'observed' before it existed);
        past capacity the arrays double (`_ensure_capacity` raises for
        fixed-size planes). Returns the new row index."""
        i = self.n_clients
        self._ensure_capacity(i + 1)
        self.n_clients = i + 1
        self._hist[:, :, i] = torch.nan
        self._hist[self.t % self._hist_cap, :, i] = torch.from_numpy(
            self._values[i]
        ).to(self.device)
        self._offline[i] = False
        return i

    def add_clients(self, k: int) -> list[int]:
        """Mass admission: reserve capacity once, then O(1) per join."""
        if k <= 0:
            return []
        self._ensure_capacity(self.n_clients + k)
        return [self.add_client() for _ in range(k)]


def plane_from_reference(ref, device="cuda") -> FleetSignalPlane:
    """Build the port's plane from the JAX package's `FleetSignalPlane`
    state, read as numpy: its client-major ring `_hist` `(hist_cap,
    capacity, n_signals)`, `t`, `_hist_len`, `_offline`, `_values`,
    `n_clients` and `names`. The ring is transposed into the port's
    signal-major layout on `device`. Later `step()`s and growth call the
    reference plane's own `series_fn` / `grow_fn`, which return numpy."""
    values = np.array(ref._values, np.float32, copy=True)
    hist = np.asarray(ref._hist, np.float32)
    plane = FleetSignalPlane(
        ref.names, lambda t: values, history=hist.shape[0],
        grow_fn=ref._grow_fn, growth=ref._growth, device=device,
    )
    plane._series_fn = ref._series_fn
    plane._values = values
    plane._capacity = values.shape[0]
    plane.n_clients = int(ref.n_clients)
    plane.t = int(ref.t)
    plane._hist_len = int(ref._hist_len)
    plane._offline = np.array(ref._offline, bool, copy=True)
    plane._hist = torch.from_numpy(
        np.ascontiguousarray(hist.transpose(0, 2, 1))
    ).to(plane.device)
    return plane


def plane_to_numpy(plane: FleetSignalPlane) -> dict:
    """The inverse of `plane_from_reference`: the plane's state as numpy,
    with the ring back in the JAX package's client-major layout."""
    return {
        "names": plane.names,
        "t": plane.t,
        "n_clients": plane.n_clients,
        "_hist_len": plane._hist_len,
        "_offline": plane._offline.copy(),
        "_values": plane._values.copy(),
        "_hist": plane._hist.cpu().numpy().transpose(0, 2, 1).copy(),
    }


class PlaneSignalView(SignalBroker):
    """One vehicle's `SignalBroker`-shaped window into the plane.

    Reads are pull-based (`read`/`read_window` — `SignalHandler` prefers
    these when present), so the per-vehicle cost of a fleet tick is zero:
    the plane's single `step()` already advanced this row. `subscribe` and
    `tick` keep push compatibility for standalone use.
    """

    def __init__(self, plane: FleetSignalPlane, row: int):
        self.plane = plane
        self.row = row
        self._subs: list[tuple[list[str], Callable[[str, float], None]]] = []

    def subscribe(self, names, cb):
        self._subs.append((list(names), cb))
        for n in list(names):
            v = self.plane.read(self.row, n)
            if v is not None:
                cb(n, v)

    def tick(self):
        # Standalone push compatibility only — the fleet path never calls
        # this (the plane steps once for all vehicles).
        for names, cb in self._subs:
            for n in names:
                v = self.plane.read(self.row, n)
                if v is not None:
                    cb(n, v)

    # pull interface (preferred by SignalHandler)
    def read(self, name: str) -> float | None:
        return self.plane.read(self.row, name)

    def read_window(self, name: str, k: int) -> list[float]:
        return self.plane.window(self.row, name, k)

    def read_sketch(self, name: str, spec) -> dict:
        return self.plane.sketch_row(self.row, name, spec)


class SignalHandler:
    """Client component: subscribes to the broker, caches the latest value
    of every signal a task has asked about (paper Fig. 4).

    Pull-capable brokers (`PlaneSignalView`) are read through directly —
    the cache is the plane column itself. Push brokers keep the classic
    callback-fed latest-value cache; a bounded per-signal history (so
    `window()` and `autospada.get_signal_window` work on any source) is
    recorded lazily, from the first `window()` call on, to keep the
    latest-value-only hot path free of per-observation deque work.
    """

    #: history retained per signal for push-based brokers
    HISTORY = 256

    def __init__(self, broker: SignalBroker):
        self._broker = broker
        self._pull = callable(getattr(broker, "read", None))
        self._latest: dict[str, float] = {}
        self._hist: dict[str, deque] = {}
        self._lock = threading.Lock()
        self._known: set[str] = set()

    def _observe(self, name: str, value: float) -> None:
        with self._lock:
            self._latest[name] = value
            h = self._hist.get(name)
            if h is not None:
                h.append(value)

    def ensure_subscribed(self, name: str) -> None:
        with self._lock:
            if name in self._known:
                return
            self._known.add(name)
        self._broker.subscribe([name], self._observe)

    def get(self, name: str) -> float | None:
        self.ensure_subscribed(name)
        if self._pull:
            return self._broker.read(name)
        with self._lock:
            return self._latest.get(name)

    def window(self, name: str, k: int) -> list[float]:
        """Last `k` observed values, oldest first. Push brokers start
        recording on the first `window()` call (seeded with the current
        latest value); pull brokers serve the plane's history ring."""
        self.ensure_subscribed(name)
        if self._pull and callable(getattr(self._broker, "read_window", None)):
            return self._broker.read_window(name, k)
        return self._push_window(name, k)

    def sketch(self, name: str, spec) -> dict | None:
        """Windowed sketch for one vehicle, served by the plane's cached
        fleet-wide device fold when the broker supports it. Returns
        ``None`` for push sources — the payload API then folds
        `window()` through the identical reference formula, so the
        answer is bit-for-bit the same either way."""
        self.ensure_subscribed(name)
        if self._pull and callable(getattr(self._broker, "read_sketch", None)):
            return self._broker.read_sketch(name, spec)
        return None

    def _push_window(self, name: str, k: int) -> list[float]:
        with self._lock:
            h = self._hist.get(name)
            if h is None:
                h = deque(maxlen=self.HISTORY)
                if name in self._latest:
                    h.append(self._latest[name])
                self._hist[name] = h
            if not h:
                return []
            k = max(0, int(k))
            return list(h)[-k:] if k else []


def constant(v: float) -> Iterator[float]:
    return itertools.repeat(float(v))
