"""The port's simulator and analytics campaign (`repro_torch.fleet`)
against the JAX package's, on the simulator's default road-grade scenario.

Tolerances: everything the platform counts or selects is exact — broker
counters, participants, cancels, pumps, pooled counts, histograms, merged
quantile values and weights. The merged mean and variance are f32 sums
whose order differs between XLA and torch: 1e-6 relative.
"""
import numpy as np
import pytest
import torch

from repro.fleet.analytics import AnalyticsConfig as RefAnalyticsConfig
from repro.fleet.simulator import FleetSimulator as RefSimulator
from repro.fleet.simulator import SimConfig as RefSimConfig
from repro_torch.fleet import FEDERATED_PENDING, FedConfig
from repro_torch.fleet.analytics import AnalyticsConfig
from repro_torch.fleet.scenarios import Scenario, build_plane
from repro_torch.fleet.simulator import FleetSimulator, SimConfig

FAULTS = {"p_drop": 0.08, "p_duplicate": 0.05, "max_delay": 2}
CHURN = {"p_leave": 0.05, "p_return": 0.3}


def run_both(sketch=True, windows=3, **cfg):
    base = dict(n_clients=16, seed=11, scenario="road-grade", **cfg)
    spec = dict(sketch=sketch, window=16, quantile_k=8)
    ref_sim = RefSimulator(RefSimConfig(**base))
    ref = ref_sim.run_analytics(RefAnalyticsConfig(**spec), windows=windows, warmup_ticks=6)
    sim = FleetSimulator(SimConfig(device="cpu", **base))
    port = sim.run_analytics(AnalyticsConfig(**spec), windows=windows, warmup_ticks=6)
    return (sim, port), (ref_sim, ref)


def assert_same_campaign(port_run, ref_run):
    (sim, port), (ref_sim, ref) = port_run, ref_run
    assert len(port.history) == len(ref.history)
    for a, b in zip(port.history, ref.history):
        assert (a.window_id, a.participants, a.canceled, a.pumps, a.count) == (
            b.window_id, b.participants, b.canceled, b.pumps, b.count)
        assert np.array_equal(a.hist, b.hist)
        if b.count:
            assert a.mean == pytest.approx(b.mean, rel=1e-6)
            assert a.var == pytest.approx(b.var, rel=1e-6)
        else:
            assert np.isnan(a.mean) and np.isnan(b.mean)
        if b.q_values is None:
            assert a.q_values is None
        else:
            assert np.array_equal(a.q_values.view(np.int32), np.asarray(b.q_values).view(np.int32))
            assert np.array_equal(a.q_weights, b.q_weights)
    assert port.last_sketches == ref.last_sketches
    assert (sim.broker.published, sim.broker.delivered, sim.broker.dropped) == (
        ref_sim.broker.published, ref_sim.broker.delivered, ref_sim.broker.dropped)
    assert sim.t == ref_sim.t


@pytest.mark.parametrize("service", ["scheduler", "calendar"])
@pytest.mark.parametrize("stragglers", [0.0, 0.25])
@pytest.mark.parametrize("churn", [False, True])
@pytest.mark.parametrize("faults", [False, True])
def test_sketch_campaign_matches_reference(faults, churn, stragglers, service):
    cfg = dict(straggler_fraction=stragglers, service=service)
    if faults:
        cfg.update(FAULTS)
    if churn:
        cfg.update(CHURN)
    assert_same_campaign(*run_both(**cfg))


@pytest.mark.parametrize("engine,service", [("dense", "dense"), ("event", "dense")])
def test_payload_campaign_matches_reference_on_the_oracle_backends(engine, service):
    """The sandboxed numpy fold (`ANALYTICS_PAYLOAD`) and the dense O(N)
    parity oracles of the tick."""
    assert_same_campaign(*run_both(sketch=False, engine=engine, service=service,
                                   churn="dense", **FAULTS, **CHURN))


def test_sketch_payload_equals_the_window_payload():
    """The fused fold answers each vehicle exactly as the per-vehicle
    numpy payload does, under churn and faults."""
    (_, a), _ = run_both(sketch=True, **FAULTS, **CHURN)
    (_, b), _ = run_both(sketch=False, **FAULTS, **CHURN)
    assert a.last_sketches == b.last_sketches


def test_run_federated_raises_the_named_error():
    sim = FleetSimulator(SimConfig(n_clients=4, device="cpu"))
    with pytest.raises(NotImplementedError, match=FEDERATED_PENDING):
        sim.run_federated(FedConfig(), rounds=1)


def test_unported_scenarios_and_planes_raise():
    with pytest.raises(NotImplementedError, match="drive-cycle"):
        build_plane("mixed", 4, device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        build_plane("road-grade", 4, plane="sharded", device="cpu")
    with pytest.raises(ValueError, match="unknown scenario"):
        Scenario("nope").series(3)


def test_simulator_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetSimulator(SimConfig(n_clients=2))
