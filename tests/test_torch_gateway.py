"""The port's analyst gateway (`repro_torch.serve`) against the JAX
package's, over one request trace on the road-grade scenario with churn
and broker faults.

Tolerances: every response equals the reference's field for field, except
the merged mean and variance (f32 sums whose order differs between XLA
and torch), which agree to 1e-6 relative. Two runs of the port give
byte-identical `GatewayResponse.encode()` streams.
"""
import pytest

from repro.fleet.simulator import FleetSimulator as RefSimulator
from repro.fleet.simulator import SimConfig as RefSimConfig
from repro.serve import FleetGateway as RefGateway
from repro_torch.fleet.federated import FEDERATED_PENDING
from repro_torch.fleet.simulator import FleetSimulator, SimConfig
from repro_torch.serve import FleetGateway

SIGNAL = "Vehicle.FuelRate"
WINDOW = 16
WORLD = dict(n_clients=24, seed=5, signal_history=32, p_leave=0.05, p_return=0.3,
             p_drop=0.05, max_delay=1, straggler_fraction=0.2)


def port_gateway():
    sim = FleetSimulator(SimConfig(device="cpu", **WORLD))
    for _ in range(WINDOW + 2):
        sim.tick()
    return FleetGateway(sim)


def ref_gateway():
    sim = RefSimulator(RefSimConfig(**WORLD))
    for _ in range(WINDOW + 2):
        sim.tick()
    return RefGateway(sim)


def drive(gw):
    """Two sessions, reads and analytics submissions in flight at once."""
    a, b = gw.session("ana"), gw.session("bob")
    a.gauges()
    b.fleet_stats(SIGNAL, window=WINDOW)
    a.quantile(SIGNAL, 0.9, window=WINDOW)
    w = b.submit_window(SIGNAL, window=WINDOW, sketch=True, deadline_fraction=1.0)
    a.submit_window("Vehicle.RoadGrade", window=WINDOW, lo=0.0, hi=0.1)
    gw.tick()
    b.progress(w)
    b.window(3, SIGNAL, 5)
    a.signal("veh-007", SIGNAL)
    a.signal("veh-999", SIGNAL)
    a.fleet_stats("Vehicle.RoadGrade", window=8, bins=1, quantile_k=1, lo=0.0, hi=0.1,
                  quantiles=(0.0, 0.5, 1.0))
    b.fleet_stats("no.such.signal")
    a.ask("no_such_kind")
    a.platform()
    gw.run_until_idle()
    out = [r for s in gw._sessions.values() for r in s.inbox]
    return sorted(out, key=lambda r: r.seq)


def test_same_trace_gives_the_reference_responses():
    port, ref = drive(port_gateway()), drive(ref_gateway())
    assert [r.seq for r in port] == [r.seq for r in ref] == list(range(len(ref)))
    for p, r in zip(port, ref):
        pd, rd = p.to_dict(), r.to_dict()
        pb, rb = pd.pop("body"), rd.pop("body")
        assert pd == rd
        for key in ("mean", "var"):
            if rb.get(key) is not None:
                assert pb.pop(key) == pytest.approx(rb.pop(key), rel=1e-6), (r.kind, key)
        assert pb == rb, r.kind
    assert any(r.kind == "submit_window" and r.ok for r in port)
    assert [r.kind for r in port if not r.ok] == ["signal", "no_such_kind"]
    assert [r.ok for r in port if r.kind == "progress"] == [True]  # still in flight


def test_replay_is_byte_identical():
    runs = [[r.encode() for r in drive(port_gateway())] for _ in range(2)]
    assert runs[0] == runs[1]


def test_submit_round_is_answered_with_the_named_error_at_admission():
    gw = port_gateway()
    t = gw.session("ana").submit_round(dim=8)
    gw.tick()
    assert t.done and not t.response.ok
    assert t.response.body == {"error": FEDERATED_PENDING}
    assert t.response.ticks == 1 and gw.idle


def test_serve_cli_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--clients", "16", "--sessions", "2", "--rounds", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 * 6 + 1 and lines[-1].startswith("-- 12 responses")
    assert sum(FEDERATED_PENDING in ln for ln in lines) == 2
