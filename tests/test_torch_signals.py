"""The port's signal plane (`repro_torch.core.signals`), its ring a tensor
on the plane's device, against the JAX package's host plane.

Tolerance: bitwise throughout. The ring (compared in the reference's
client-major layout through `plane_to_numpy`, NaN bit patterns included),
`window()` and every field of the fleet sketches must equal the
reference's. Both planes are fed the same seeded trace, with the same
offline toggles.
"""
import numpy as np
import pytest
import torch

from repro.core.signals import FleetSignalPlane as RefPlane
from repro.fleet.scenarios import build_plane as ref_build_plane
from repro.kernels.sketch import SketchSpec as RefSpec
from repro_torch.core.signals import (
    FleetSignalPlane,
    plane_from_reference,
    plane_to_numpy,
)
from repro_torch.fleet.scenarios import build_plane
from repro_torch.kernels.sketch import SketchSpec

NAMES = ("a", "b", "c")


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def assert_same_sketches(got, want):
    assert np.array_equal(got.counts, want.counts)
    assert np.array_equal(got.hists, want.hists)
    for f in ("means", "m2s", "qvals"):
        assert np.array_equal(bits(getattr(got, f)), bits(getattr(want, f))), f


def assert_same_state(port, ref):
    st = plane_to_numpy(port)
    assert (st["t"], st["n_clients"], st["_hist_len"]) == (ref.t, ref.n_clients, ref._hist_len)
    assert st["names"] == ref.names
    assert np.array_equal(st["_offline"], ref._offline)
    assert np.array_equal(bits(st["_values"]), bits(ref._values))
    assert np.array_equal(bits(st["_hist"]), bits(ref._hist))


def trace(seed, T, n):
    rng = np.random.default_rng(seed)
    tr = rng.normal(6.0, 3.0, (T, n, len(NAMES))).astype(np.float32)
    tr[rng.random(tr.shape) < 0.05] = np.nan  # the source itself has gaps
    return tr


@pytest.mark.parametrize("history", [8, 32])
def test_trace_plane_matches_reference_tick_by_tick(history):
    n, T = 11, 40
    tr = trace(history, T, n)
    ref = RefPlane.from_trace(NAMES, tr, history=history)
    port = FleetSignalPlane.from_trace(NAMES, tr, history=history, device="cpu")
    assert port._hist.device.type == "cpu" and port._hist.shape == (history, 3, n)
    rng = np.random.default_rng(history + 1)
    specs = [(SketchSpec(window=w, bins=6, lo=0.0, hi=12.0, quantile_k=k),
              RefSpec(window=w, bins=6, lo=0.0, hi=12.0, quantile_k=k))
             for w, k in ((4, 1), (16, 8), (64, 32))]
    for _ in range(T + 5):  # past the trace's end: it holds its last row
        for row in rng.choice(n, 2, replace=False):
            online = bool(rng.random() < 0.5)
            port.set_online(int(row), online)
            ref.set_online(int(row), online)
        port.step()
        ref.step()
        assert_same_state(port, ref)
        for row in range(n):
            for name in NAMES:
                assert port.read(row, name) == ref.read(row, name)
        for k in (0, 1, 5, history + 3):
            assert port.window(3, "b", k) == ref.window(3, "b", k)
        for spec, ref_spec in specs:
            assert_same_sketches(port.compute_sketches("c", spec),
                                 ref.compute_sketches("c", ref_spec, backend="xla"))


def test_plane_from_reference_round_trip_and_continued_run():
    n = 9
    tr = trace(5, 30, n)
    ref = RefPlane.from_trace(NAMES, tr, history=16)
    for t in range(12):
        ref.set_online(t % n, t % 3 == 0)
        ref.step()
    port = plane_from_reference(ref, "cpu")  # continues on the reference's series
    assert port._hist.shape == (16, 3, n)  # signal-major on the port side
    assert_same_state(port, ref)
    spec, ref_spec = SketchSpec(window=16), RefSpec(window=16)
    assert_same_sketches(port.compute_sketches("a", spec),
                         ref.compute_sketches("a", ref_spec, backend="xla"))
    for t in range(10):
        for p in (port, ref):
            p.set_online((5 * t) % n, t % 2 == 1)
            p.step()
        assert_same_state(port, ref)
    assert port.window(4, "a", 16) == ref.window(4, "a", 16)


def test_road_grade_plane_growth_matches_reference():
    """Geometric growth and `add_client` (NaN history except the join
    tick) on the simulator's default scenario."""
    ref = ref_build_plane("road-grade", 5, history=8)
    port = build_plane("road-grade", 5, history=8, device="cpu")
    for step in range(12):
        for p in (port, ref):
            if step % 3 == 0:
                p.add_clients(2)
            if step % 4 == 1:
                p.add_client()
            p.set_online(step % p.n_clients, step % 2 == 0)
            p.step()
        assert port._capacity == ref._capacity
        assert_same_state(port, ref)
    spec, ref_spec = SketchSpec(window=8, bins=16), RefSpec(window=8, bins=16)
    assert_same_sketches(port.compute_sketches("Vehicle.FuelRate", spec),
                         ref.compute_sketches("Vehicle.FuelRate", ref_spec, backend="xla"))
    for row in range(port.n_clients):
        assert port.sketch_row(row, "Vehicle.FuelRate", spec) == ref.sketch_row(
            row, "Vehicle.FuelRate", ref_spec)


@pytest.mark.parametrize("streamed", [True, False])
def test_csv_fleet_plane_matches_reference(streamed):
    csvs = [
        "a,b\n1.0,2.0\n,3.5\n4.0,\n",
        "b,c\n,9.0\n7.0,8.0\n7.5,8.5\n6.0,5.0\n",
    ]
    ref = RefPlane.from_csv_fleet(csvs, history=4, streamed=streamed)
    port = FleetSignalPlane.from_csv_fleet(csvs, history=4, streamed=streamed, device="cpu")
    for _ in range(6):
        assert_same_state(port, ref)
        for row in range(2):
            for name in ("a", "b", "c"):
                assert port.read(row, name) == ref.read(row, name)
                assert port.window(row, name, 4) == ref.window(row, name, 4)
        port.step()
        ref.step()


def test_unknown_signal_and_bad_rows():
    port = FleetSignalPlane.from_trace(NAMES, trace(1, 3, 4), history=4, device="cpu")
    spec = SketchSpec(window=4)
    assert port.read(0, "nope") is None and port.window(0, "nope", 3) == []
    assert port.sketch_row(2, "nope", spec) == port.compute_sketches("nope", spec).row(2)
    with pytest.raises(IndexError):
        port.window(4, "a", 2)
    with pytest.raises(ValueError, match="fixed fleet size"):
        port.add_client()


def test_fleet_sketch_is_cached_per_tick():
    port = FleetSignalPlane.from_trace(NAMES, trace(2, 6, 5), history=4, device="cpu")
    spec = SketchSpec(window=4)
    first = port.fleet_sketch("a", spec)
    assert port.fleet_sketch("a", spec) is first
    port.step()
    assert port.fleet_sketch("a", spec) is not first


def test_plane_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetSignalPlane.from_trace(NAMES, trace(0, 2, 2))
