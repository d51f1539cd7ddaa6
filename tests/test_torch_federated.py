"""The port's federated round (`repro_torch.fleet.{federated,rounds}`,
`FleetSimulator.run_federated`, `launch.fleet`) against the JAX package's.

Tolerances:
* `local_sgd`, `client_delta` (null codec) and `aggregate_deltas`: the
  gradients are f32 reductions whose order differs between XLA and torch,
  so parameters and deltas agree to rtol 1e-5, atol 1e-6. Through the int8
  codec a delta agrees within one quantization step (its scale).
* `pack_delta` is bitwise: the same wire dict, byte for byte.
* `aggregate_packed` is one f32 contraction: rtol 1e-6, atol 1e-7.
* `run_federated`: the round's payload is numpy in both packages and the
  model starts at zero, so round 0's uploads are byte-identical; every
  round's participants, cancels, pumps and broker counters are exact; the
  model `w` (later rounds get it through f32 sums in another order) agrees
  to rtol 1e-5, atol 1e-6, and the losses to rtol 1e-4.
* `launch.fleet`: the same aggregate checksum to 5 decimals.
"""
import copy
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fleet import federated as ref_fed
from repro.fleet import rounds as ref_rounds
from repro.fleet.simulator import FleetSimulator as RefSimulator
from repro.fleet.simulator import SimConfig as RefSimConfig
from repro_torch.fleet import FEDERATED_PENDING
from repro_torch.fleet import federated as fed
from repro_torch.fleet import rounds
from repro_torch.fleet.simulator import FleetSimulator, SimConfig

TOL = dict(rtol=1e-5, atol=1e-6)


def problem(seed, d=12, n=40):
    """A least-squares batch and starting parameters, from numpy."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (X @ rng.standard_normal(d) + 0.3).astype(np.float32)
    params = {"w": (rng.standard_normal(d) * 0.1).astype(np.float32),
              "b": np.asarray(0.05, np.float32)}
    return params, (X, y)


def torch_loss(p, batch):
    X, y = batch
    return torch.mean((X @ p["w"] + p["b"] - y) ** 2)


def jax_loss(p, batch):
    X, y = batch
    return jnp.mean((X @ p["w"] + p["b"] - y) ** 2)


def as_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_local_sgd_matches_reference():
    params, batch = problem(0)
    got = fed.local_sgd(torch_loss, as_torch(params), as_torch(batch), steps=5, lr=0.05)
    want = ref_fed.local_sgd(jax_loss, as_jax(params), as_jax(batch), steps=5, lr=0.05)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
        assert got[k].shape == params[k].shape and got[k].dtype == torch.float32


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_client_delta_matches_reference(codec):
    params, batch = problem(1)
    cfg = fed.FedConfig(local_steps=3, local_lr=0.1, codec=codec, codec_kwargs=(("row", 8),) if codec == "int8" else ())
    ref_cfg = ref_fed.FedConfig(local_steps=3, local_lr=0.1, codec=codec, codec_kwargs=cfg.codec_kwargs)
    got = fed.client_delta(torch_loss, as_torch(params), as_torch(batch), cfg, None)
    want = ref_fed.client_delta(jax_loss, as_jax(params), as_jax(batch), ref_cfg, None)
    assert [s for s, _ in got["shapes"]] == [tuple(s) for s, _ in want["shapes"]]
    codec_obj = fed.make_codec(codec, **dict(cfg.codec_kwargs))
    ref_codec = ref_fed.make_codec(codec, **dict(cfg.codec_kwargs))
    a = codec_obj.decode(got["msg"]).numpy()
    b = np.asarray(ref_codec.decode(want["msg"]))
    if codec == "none":
        np.testing.assert_allclose(a, b, **TOL)
    else:  # the same delta up to f32 rounding: at most one step of q apart
        step = np.repeat(got["msg"]["s"].numpy(), 8)[: a.size]
        assert (np.abs(a - b) <= step * 1.0001).all()


def test_client_delta_with_error_feedback_keeps_a_residual():
    params, batch = problem(2)
    cfg = fed.FedConfig(local_steps=2, local_lr=0.1)
    ef = fed.ErrorFeedback(fed.make_codec("int8", row=16))
    out = fed.client_delta(torch_loss, as_torch(params), as_torch(batch), cfg, ef)
    assert out["msg"]["kind"] == "int8" and ef._residual is not None
    assert ef.bytes_raw == 13 * 4 and ef.compression_ratio > 1.0


@pytest.mark.parametrize("weights", [None, [1.0, 3.0, 0.5]])
def test_aggregate_deltas_matches_reference(weights):
    params, _ = problem(3)
    rng = np.random.default_rng(3)
    flats = [(rng.standard_normal(13) * 0.02).astype(np.float32) for _ in range(3)]
    cfg, ref_cfg = fed.FedConfig(server_lr=0.7), ref_fed.FedConfig(server_lr=0.7)
    tp, jp = as_torch(params), as_jax(params)
    _, td, shapes = fed.flatten_pytree(tp)
    _, jtd, jshapes = ref_fed.flatten_pytree(jp)
    codec, ref_codec = fed.make_codec("int8"), ref_fed.make_codec("int8")
    deltas = [{"msg": codec.encode(torch.from_numpy(f)), "treedef": td, "shapes": shapes} for f in flats]
    ref_deltas = [{"msg": ref_codec.encode(jnp.asarray(f)), "treedef": jtd, "shapes": jshapes} for f in flats]
    got = fed.aggregate_deltas(tp, deltas, cfg, weights)
    want = ref_fed.aggregate_deltas(jp, ref_deltas, ref_cfg, weights)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
    assert fed.aggregate_deltas(tp, [], cfg) is tp


def test_pairwise_masks_raise_the_named_error():
    with pytest.raises(NotImplementedError, match="threefry"):
        fed.pairwise_masks(3, 4, seed=0)
    assert "ROADMAP" in FEDERATED_PENDING


@pytest.mark.parametrize("n,row", [(32, 256), (5000, 4096), (4096, 4096)])
def test_pack_delta_matches_reference_bitwise(n, row):
    flat = (np.random.default_rng([n, row]).standard_normal(n) * 0.01).astype(np.float32)
    got = rounds.pack_delta(flat, row, device="cpu")
    assert got == ref_rounds.pack_delta(flat, row)
    np.testing.assert_array_equal(rounds.unpack_delta(got), ref_rounds.unpack_delta(got))


@pytest.mark.parametrize("weighted", [False, True])
def test_aggregate_packed_matches_reference(weighted):
    rng = np.random.default_rng(int(weighted))
    msgs = [ref_rounds.pack_delta((rng.standard_normal(300) * 0.01).astype(np.float32), 256)
            for _ in range(30)]
    w = rng.integers(1, 40, 30).astype(np.float32) if weighted else None
    got = rounds.aggregate_packed(msgs, w, device="cpu")
    np.testing.assert_allclose(got, ref_rounds.aggregate_packed(msgs, w), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, ref_rounds.aggregate_reference(msgs, w), rtol=1e-6, atol=1e-7)
    mixed = msgs[:3] + [ref_rounds.pack_delta(np.ones(10, np.float32), 256)]
    with pytest.raises(ValueError):  # heterogeneous shapes take the loop, as in the reference
        ref_rounds.aggregate_reference(mixed)
    with pytest.raises(ValueError):
        rounds.aggregate_packed(mixed, device="cpu")


WORLD = dict(n_clients=24, seed=3, p_drop=0.08, p_duplicate=0.05, max_delay=2,
             p_leave=0.05, p_return=0.3, straggler_fraction=0.25)
FED = dict(local_steps=3, local_lr=0.2, deadline_fraction=0.9, deadline_pumps=16)


def campaign(sim, fed_cfg, rounds_=3):
    first = []

    def on_round(rnd, driver):
        if rnd == 0:
            first.append(copy.deepcopy(driver.last_msgs))

    driver = sim.run_federated(fed_cfg, dim=16, rounds=rounds_, n_samples=16, on_round=on_round)
    return driver, first[0]


@pytest.mark.parametrize("service", ["scheduler", "calendar"])
def test_run_federated_matches_reference(service):
    sim = FleetSimulator(SimConfig(device="cpu", service=service, **WORLD))
    ref_sim = RefSimulator(RefSimConfig(service=service, **WORLD))
    port, port_first = campaign(sim, fed.FedConfig(**FED))
    ref, ref_first = campaign(ref_sim, ref_fed.FedConfig(**FED))
    assert port_first and json.dumps(port_first, sort_keys=True) == json.dumps(ref_first, sort_keys=True)
    assert len(port.history) == len(ref.history) == 3
    for a, b in zip(port.history, ref.history):
        for key in ("round", "participants", "canceled", "pumps", "weights"):
            assert a[key] == b[key], key
        assert a["mean_client_loss"] == pytest.approx(b["mean_client_loss"], rel=1e-4)
        assert a["dist_to_optimum"] == pytest.approx(b["dist_to_optimum"], rel=1e-5)
    assert any(h["canceled"] for h in ref.history) or any(
        m.dropped for m in ref_sim.metrics.rounds)  # the faults did bite
    np.testing.assert_allclose(port.w, ref.w, **TOL)
    exact = ("round", "online_at_start", "participants", "canceled", "ticks",
             "published", "delivered", "dropped")
    for a, b in zip(sim.metrics.rounds, ref_sim.metrics.rounds):
        assert [getattr(a, k) for k in exact] == [getattr(b, k) for k in exact]
    assert sim.t == ref_sim.t


def checksum(out: str) -> float:
    line = [ln for ln in out.splitlines() if ln.startswith("aggregate checksum:")]
    assert len(line) == 1, out
    return float(line[0].split(":")[1])


def test_launch_fleet_matches_reference_cli(capsys, monkeypatch):
    from repro.launch import fleet as ref_cli
    from repro_torch.launch import fleet as cli

    flags = ["--clients", "40", "--rounds", "3", "--drop", "0.1", "--stragglers", "0.2",
             "--leave", "0.05", "--return", "0.3", "--seed", "21"]
    cli.main(flags + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["repro.launch.fleet", *flags])
    ref_cli.main()
    ref_out = capsys.readouterr().out
    assert checksum(port_out) == pytest.approx(checksum(ref_out), abs=1e-5)
    assert port_out.splitlines()[-2].split(",")[:2] == ref_out.splitlines()[-2].split(",")[:2]


def test_launch_fleet_flags_of_unported_features_raise():
    from repro_torch.launch import fleet as cli

    for flags, match in ((["--checkpoint-to", "x"], "checkpoint"),
                         (["--restore-from", "x"], "checkpoint"),
                         (["--scenario", "urban"], "drive-cycle"),
                         (["--workload", "analytics"], "drive-cycle"),
                         (["--plane", "sharded"], "sharded")):
        with pytest.raises(NotImplementedError, match=match):
            cli.main(["--clients", "4", "--device", "cpu", *flags])


def test_launch_fleet_analytics_on_road_grade(capsys):
    from repro_torch.launch import fleet as cli

    cli.main(["--workload", "analytics", "--scenario", "road-grade", "--clients", "24",
              "--rounds", "2", "--sketch", "--warmup-ticks", "8", "--window", "8",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "fleet Vehicle.FuelRate: mean=" in out and "(checksum" in out
