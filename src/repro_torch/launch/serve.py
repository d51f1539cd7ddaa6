"""Serving launcher: front a running fleet with the analyst gateway.

Boots a `FleetSimulator` whose signal ring lives on `--device` (the card
by default), opens `--sessions` concurrent analyst sessions against it
through `repro_torch.serve.FleetGateway`, replays a deterministic request
mix (fleet gauges, windowed statistics, quantile queries, analytics
windows, and federated rounds, which the port answers with its
not-ported-yet error), and prints every response plus the latency
summary. Everything is a function of --seed and the request trace:
re-running prints byte-identical response bodies.

    PYTHONPATH=src python -m repro_torch.launch.serve --clients 1024 --sessions 4
    PYTHONPATH=src python -m repro_torch.launch.serve --clients 64 --device cpu

The JAX package's `--llm` mode is not ported (ROADMAP queue 1).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--clients", type=int, default=256)
    ap.add_argument("--sessions", type=int, default=4,
                    help="concurrent analyst sessions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scenario", default="road-grade")
    ap.add_argument("--device", default="cuda",
                    help="where the signal ring and the sketch fold run")
    ap.add_argument("--signal", default="Vehicle.FuelRate")
    ap.add_argument("--warmup-ticks", type=int, default=16,
                    help="world ticks before the first request")
    ap.add_argument("--rounds", type=int, default=0,
                    help="federated rounds submitted per session")
    ap.add_argument("--windows", type=int, default=1,
                    help="analytics windows submitted per session")
    ap.add_argument("--admit-per-tick", type=int, default=None,
                    help="cap admissions per tick boundary (backpressure)")
    ap.add_argument("--leave", type=float, default=0.0,
                    help="per-tick ignition-off probability")
    ap.add_argument("--return", dest="p_return", type=float, default=0.0,
                    help="per-tick ignition-on probability")
    ap.add_argument("--stragglers", type=float, default=0.0,
                    help="fraction of slow clients")
    return ap


def _fleet_main(args: argparse.Namespace) -> None:
    from repro_torch.fleet.simulator import FleetSimulator, SimConfig
    from repro_torch.serve.gateway import FleetGateway

    sim = FleetSimulator(
        SimConfig(
            n_clients=args.clients,
            seed=args.seed,
            scenario=args.scenario,
            p_leave=args.leave,
            p_return=args.p_return,
            straggler_fraction=args.stragglers,
            device=args.device,
        )
    )
    for _ in range(args.warmup_ticks):
        sim.tick()
    gw = FleetGateway(sim, admit_per_tick=args.admit_per_tick)

    # the deterministic request mix every session replays: a dashboard
    # poll, fleet-level statistics, a percentile query, then the
    # submissions — all in flight concurrently across sessions
    t0 = time.perf_counter()
    for s in range(args.sessions):
        sess = gw.session(f"analyst-{s}")
        sess.gauges()
        sess.platform()
        sess.fleet_stats(args.signal)
        sess.quantile(args.signal, 0.9)
        for _ in range(args.rounds):
            sess.submit_round()
        for _ in range(args.windows):
            sess.submit_window(args.signal, sketch=True)
    ticks = gw.run_until_idle()
    wall = time.perf_counter() - t0

    responses = [r for s in gw._sessions.values() for r in s.inbox]
    responses.sort(key=lambda r: r.seq)
    for r in responses:
        print(r.encode().decode())
    lat = np.asarray([r.ticks for r in responses], np.float64)
    print(
        f"-- {len(responses)} responses over {ticks} ticks "
        f"({len(responses) / max(wall, 1e-9):.0f} resp/s wall); "
        f"response ticks p50={np.percentile(lat, 50):.0f} "
        f"p99={np.percentile(lat, 99):.0f}"
    )


def main(argv: list[str] | None = None) -> None:
    _fleet_main(build_parser().parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
