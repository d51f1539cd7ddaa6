"""Run the fleet simulator from the command line.

Federated learning (the default workload):

    PYTHONPATH=src python -m repro_torch.launch.fleet --clients 1024 --rounds 5 \
        --drop 0.05 --duplicate 0.02 --delay 2 --stragglers 0.1

Streaming analytics (the paper's data-analytics case study — on-vehicle
Welford/histogram sketches over a signal, merged server-side in one
batched reduction per window):

    PYTHONPATH=src python -m repro_torch.launch.fleet --workload analytics \
        --clients 256 --scenario road-grade --signal Vehicle.FuelRate --rounds 6

The signal ring, the sketch fold and the FedAvg server step run on
`--device`, the card unless ``--device cpu`` is given. Prints the
per-round metrics table and the workload summary. Everything is a
deterministic function of --seed: re-running with identical flags gives
an identical final aggregate (printed as a checksum so drift is visible).

Flags of what the port does not run yet raise `NotImplementedError`
naming their ROADMAP item: the drive-cycle scenarios (`--scenario
highway|urban|idle|mixed`, and the analytics default `mixed`), `--plane
sharded`, and the checkpoint flags.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.fleet.analytics import AnalyticsConfig
from repro_torch.fleet.federated import FedConfig
from repro_torch.fleet.scenarios import PLANES, SCENARIOS
from repro_torch.fleet.simulator import Backends, FleetSimulator, SimConfig

#: what the checkpoint flags raise until `fleet/checkpoint.py` is ported
CHECKPOINT_PENDING = (
    "checkpoints are not ported yet: ROADMAP queue 1, 'checkpoint'"
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", choices=("federated", "analytics"),
                    default="federated")
    ap.add_argument("--clients", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=5,
                    help="FedAvg rounds / analytics windows")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the signal ring, the sketch fold and the "
                         "FedAvg server step run")
    ap.add_argument("--scenario", choices=SCENARIOS, default=None,
                    help="scenario for the signal plane (default: road-grade "
                         "for federated, mixed for analytics; only "
                         "road-grade is ported)")
    ap.add_argument("--plane", choices=PLANES, default="host",
                    help="signal-plane implementation (only host is ported)")
    ap.add_argument("--dim", type=int, default=32, help="model dimension")
    ap.add_argument("--drop", type=float, default=0.0, help="QoS-0 drop prob")
    ap.add_argument("--duplicate", type=float, default=0.0, help="QoS-1 dup prob")
    ap.add_argument("--delay", type=int, default=0, help="max delivery delay (ticks)")
    ap.add_argument("--leave", type=float, default=0.0, help="per-tick ignition-off prob")
    ap.add_argument("--return", dest="p_return", type=float, default=0.0,
                    help="per-tick ignition-on prob")
    ap.add_argument("--stragglers", type=float, default=0.0,
                    help="fraction of slow clients")
    ap.add_argument("--service", choices=("scheduler", "calendar", "dense"),
                    default="scheduler",
                    help="fleet service: event-driven scheduler, the "
                         "calendar-queue variant, or the dense poll-loop "
                         "oracle (identical interleaving)")
    ap.add_argument("--engine", choices=("event", "dense"), default="event",
                    help="tick orchestration: one unified event heap or the "
                         "legacy dense tick (the bit-for-bit parity oracle)")
    ap.add_argument("--churn", choices=("event", "dense"), default="event",
                    help="churn schedule: seeded geometric event heap or "
                         "the O(N)-scan oracle (identical toggles)")
    ap.add_argument("--deadline", type=float, default=0.9,
                    help="fraction of clients awaited per round")
    ap.add_argument("--deadline-pumps", type=int, default=64,
                    help="hard per-round tick budget")
    # analytics knobs
    ap.add_argument("--signal", default="Vehicle.FuelRate",
                    help="signal the analytics workload sketches")
    ap.add_argument("--window", type=int, default=64,
                    help="on-vehicle samples per sketch")
    ap.add_argument("--bins", type=int, default=16,
                    help="fixed-bin histogram resolution")
    ap.add_argument("--quantile-k", type=int, default=32,
                    help="ranked values per vehicle quantile summary")
    ap.add_argument("--sketch", action="store_true",
                    help="fold windows on the device in one fleet-wide "
                         "sketch kernel instead of per-vehicle sandbox "
                         "loops — same result, bit for bit")
    ap.add_argument("--warmup-ticks", type=int, default=16,
                    help="world ticks before the first analytics window")
    # durable fleet state: not ported yet
    ap.add_argument("--checkpoint-to", metavar="DIR", default=None,
                    help="not ported yet (raises)")
    ap.add_argument("--checkpoint-every", type=int, metavar="N", default=None,
                    help="not ported yet (raises)")
    ap.add_argument("--restore-from", metavar="DIR", default=None,
                    help="not ported yet (raises)")
    ap.add_argument("--memory-report", action="store_true",
                    help="print the per-category bytes/client breakdown "
                         "before the workload runs")
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if (args.checkpoint_to, args.checkpoint_every, args.restore_from) != (None,) * 3:
        raise NotImplementedError(CHECKPOINT_PENDING)
    scenario = args.scenario or (
        "mixed" if args.workload == "analytics" else "road-grade"
    )
    sim = FleetSimulator(
        SimConfig(
            n_clients=args.clients,
            seed=args.seed,
            scenario=scenario,
            p_drop=args.drop,
            p_duplicate=args.duplicate,
            max_delay=args.delay,
            p_leave=args.leave,
            p_return=args.p_return,
            straggler_fraction=args.stragglers,
            backends=Backends(
                plane=args.plane,
                service=args.service,
                churn=args.churn,
                engine=args.engine,
            ),
            device=args.device,
        )
    )
    if args.memory_report:
        print(FleetSimulator.format_memory_report(sim.memory_report()))
    if args.workload == "analytics":
        driver = sim.run_analytics(
            AnalyticsConfig(
                signal=args.signal,
                window=args.window,
                bins=args.bins,
                quantile_k=args.quantile_k,
                sketch=args.sketch,
                deadline_fraction=args.deadline,
                deadline_pumps=args.deadline_pumps,
            ),
            windows=args.rounds,
            warmup_ticks=args.warmup_ticks,
        )
        print(sim.metrics.format_table())
        print(driver.format_table())
        if driver.history:
            last = driver.history[-1]
            print(
                f"fleet {args.signal}: mean={last.mean:.4f} std={last.std:.4f} "
                f"p50={last.quantile(0.5):.4f} p90={last.quantile(0.9):.4f} "
                f"over {last.count} on-vehicle samples "
                f"(checksum {last.mean + last.var:.6f})"
            )
        return
    driver = sim.run_federated(
        FedConfig(
            local_steps=3,
            local_lr=0.2,
            deadline_fraction=args.deadline,
            deadline_pumps=args.deadline_pumps,
        ),
        dim=args.dim,
        rounds=args.rounds,
        n_samples=16,
    )
    print(sim.metrics.format_table())
    print(f"aggregate checksum: {float(np.sum(driver.w)):.6f}")


if __name__ == "__main__":
    main(sys.argv[1:])
