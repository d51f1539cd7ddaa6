"""Run the PyTorch port on one NVIDIA GPU: build its kernels, hold each one
against its plain PyTorch version, then drive the analyst-serving path at
full size through the entry points a user calls.

    python3 chip_smoke.py

Phases, one JSON line each: `env`, `build`, `kernels` (one line per
kernel case), `serve`. Then the kernel summary line, the card's name and
power limit as `nvidia-smi` prints them, and last
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero; without CUDA it exits non-zero before printing anything.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
DEVICE = "cuda"
N_VEHICLES = 100_000
SESSIONS = 32
WINDOWS = 3
SIGNAL = "Vehicle.FuelRate"
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def median_ms(fn, *, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of `fn`, each after an L2 flush
    (the main path meets its inputs cold), after `warmup` untimed calls."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=DEVICE)  # 256 MB
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    check(torch.equal(nan_a, nan_b), "kernel and plain fold put NaN in the same places")
    return float((a - b)[~nan_a].abs().max()) if (~nan_a).any() else 0.0


def random_ring(hist_cap, n_signals, n, *, scale, offset, p_nan, gen):
    """A signal-major ring (hist_cap, n_signals, n) made on the card from a
    seeded generator, with a share of NaN (offline ticks) and the first
    client column all NaN."""
    ring = torch.randn((hist_cap, n_signals, n), generator=gen, device=DEVICE)
    ring = ring * scale + offset
    mask = torch.rand((hist_cap, n_signals, n), generator=gen, device=DEVICE) < p_nan
    ring[mask] = torch.nan
    ring[:, :, 0] = torch.nan
    return ring


def phase_kernels(sk) -> dict:
    """Hold the sketch-fold kernel against the plain fold on the card,
    bitwise, and a sample of columns against the numpy oracle. Returns the
    main-path case's timings."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    main_ring = random_ring(256, 4, N_VEHICLES, scale=3.0, offset=5.0, p_nan=0.1, gen=gen)
    ragged = random_ring(256, 4, 4097, scale=1e3, offset=0.0, p_nan=0.1, gen=gen)
    tiny = random_ring(64, 4, 4097, scale=1e-3, offset=0.0, p_nan=0.3, gen=gen)
    cases = [
        # name, ring, t, hist_len, col, spec
        (f"main W=64 n={N_VEHICLES} bins=16 K=32", main_ring, 300, 256, 1,
         sk.SketchSpec(window=64, bins=16, lo=0.0, hi=12.0, quantile_k=32)),
        ("ragged W=256 n=4097 hist_len=100", ragged, 99, 100, 2,
         sk.SketchSpec(window=256, bins=16, lo=-1e3, hi=1e3, quantile_k=32)),
        ("bins=1 K=1", tiny, 70, 64, 3,
         sk.SketchSpec(window=64, bins=1, lo=-1e-3, hi=1e-3, quantile_k=1)),
    ]
    main = None
    for name, ring, t, hist_len, col, spec in cases:
        x = sk.window_block(ring, t, hist_len, col, spec.window)
        xs = torch.sort(x, dim=0).values.contiguous()
        edges = torch.from_numpy(spec.edges()).to(DEVICE)
        nan_rows = torch.isnan(xs).to(torch.int8)
        check(bool((nan_rows[1:] >= nan_rows[:-1]).all()), f"{name}: torch.sort puts NaN last")
        before = sk.launches
        got = sk.sketch_fold(x, xs, edges, spec.quantile_k)
        torch.cuda.synchronize()
        check(sk.launches == before + 1, f"{name}: the kernel launched once")
        plain = sk.fold_plain(x, xs, edges, spec.quantile_k)
        equal = bitwise_equal(got, plain)
        err = max_abs_err(got, plain)
        check(equal, f"{name}: kernel == plain fold bit for bit")
        host_x = x.cpu().numpy()
        fleet = sk.sketches_from_device(spec, got.cpu().numpy())
        cols = [0] + sorted(rng.choice(x.shape[1], 255, replace=False).tolist())
        oracle = all(
            fleet.row(i) == sk.sketch_reference(
                [v for v in host_x[:, i] if not np.isnan(v)], spec
            )
            for i in cols
        )
        check(oracle, f"{name}: 256 columns == sketch_reference")
        line = {"phase": "kernels", "kernel": "sketch_fold", "case": name,
                "shape": list(x.shape), "bins": spec.bins, "K": spec.quantile_k,
                "equal": equal, "max_abs_err": err, "oracle_columns": len(cols)}
        if main is None:
            valid = int((~torch.isnan(x)).sum())
            n_edges = spec.bins - 1
            nbytes = 4 * (2 * x.numel() + n_edges + spec.dim * x.shape[1])
            ops = valid * (6 + n_edges)  # Welford adds/mul/div + edge compares
            bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
            ops_ms = 1e3 * ops / PEAK_F32_OPS_PER_S
            main = {
                "max_abs_err": err,
                "kernel_ms": median_ms(lambda: sk.sketch_fold(x, xs, edges, spec.quantile_k)),
                "plain_ms": median_ms(lambda: sk.fold_plain(x, xs, edges, spec.quantile_k)),
                "fold_ms": median_ms(lambda: sk.sketch_ring(ring, t, hist_len, col, spec)),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": None,  # no single PyTorch call computes the sketch
                "bytes": nbytes, "ops": ops,
            }
            line.update(main)
        line["launches"] = sk.launches
        emit(line)
    del main_ring, ragged, tiny
    torch.cuda.empty_cache()
    return main


def drive_sessions(gw, n_windows: int, *, submit: bool) -> dict:
    """`n_windows` rounds of requests from every session: fleet_stats,
    quantile and a window read each, plus (if `submit`) one sketch-payload
    analytics window per round; then `run_until_idle()`."""
    tickets, ticks, wall = [], 0, 0.0
    for w in range(n_windows):
        for s in range(SESSIONS):
            sess = gw.session(f"analyst-{s}")
            tickets.append(sess.fleet_stats(SIGNAL))
            tickets.append(sess.quantile(SIGNAL, 0.9))
            tickets.append(sess.window((7919 * (s + SESSIONS * w)) % gw.sim.cfg.n_clients, SIGNAL, 16))
        if submit:
            tickets.append(gw.session(f"analyst-{w % SESSIONS}").submit_window(SIGNAL, sketch=True))
        t0 = time.perf_counter()
        ticks += gw.run_until_idle()
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
    check(all(t.done for t in tickets), "every ticket has a response")
    bad = [t.response.body for t in tickets if not t.response.ok]
    check(not bad, f"every response is ok: {bad[:3]}")
    for t in tickets:
        body = t.response.body
        if t.request.kind in ("fleet_stats", "submit_window"):
            check(body["count"] > 0 and np.isfinite(body["mean"]) and np.isfinite(body["var"]),
                  f"{t.request.kind}: finite moments over a non-empty fleet")
            check(sum(body["hist"]) == body["count"], f"{t.request.kind}: histogram sums to count")
    lat = np.asarray([t.response.ticks for t in tickets], np.float64)
    return {
        "responses": len(tickets),
        "ticks": ticks,
        "seconds": wall,
        "ticks_per_s": ticks / wall,
        "queries_per_s": len(tickets) / wall,
        "p50_response_ticks": float(np.percentile(lat, 50)),
        "p99_response_ticks": float(np.percentile(lat, 99)),
    }


def device_time(prof, wall_ms: float) -> dict:
    """Device busy time under the profiler (sum of the kernel and copy
    events that ran on the card; host-side ops, which also carry their
    kernels' time, are left out so nothing counts twice), its share of
    the wall time, and the top kernels."""
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = ev.self_device_time_total / 1e3  # us -> ms
        by_name[ev.key] = by_name.get(ev.key, 0.0) + t
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy if by_name else None,
        "device_idle_share": 1.0 - busy / wall_ms if by_name else None,
        "device_top_ms": {k[:60]: v for k, v in top},
    }


def phase_serve(sk) -> dict:
    """The main path at full size: 100 000 vehicles on the road-grade
    scenario with churn, ring (history 256, 4 signals) on the card, 32
    analyst sessions through the gateway: two rounds of reads only, then
    rounds of reads plus one sketch-payload analytics window each, under
    the profiler."""
    from repro_torch.fleet.simulator import FleetSimulator, SimConfig
    from repro_torch.serve import FleetGateway

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = FleetSimulator(SimConfig(
        n_clients=N_VEHICLES, seed=SEED, p_leave=0.02, p_return=0.3, device=DEVICE
    ))
    build_s = time.perf_counter() - t0
    warm = 8
    t0 = time.perf_counter()
    for _ in range(warm):
        sim.tick()
    torch.cuda.synchronize()
    idle_ticks_per_s = warm / (time.perf_counter() - t0)
    gw = FleetGateway(sim)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if DEVICE == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        reads = drive_sessions(gw, 2, submit=False)
        out = drive_sessions(gw, WINDOWS, submit=True)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    out["reads_only"] = reads
    out.update(device_time(prof, wall_ms))

    spec = sk.SketchSpec()
    rng = np.random.default_rng(SEED)
    for row in rng.choice(sim.plane.n_clients, 16, replace=False).tolist():
        got = sim.plane.sketch_row(row, SIGNAL, spec)
        want = sk.sketch_reference(sim.plane.window(row, SIGNAL, spec.window), spec)
        check(got == want, f"vehicle {row}: sketch_row == sketch_reference(window())")
    ring = sim.plane._hist
    out.update(
        n_vehicles=sim.plane.n_clients,
        submit_window_vehicles=sim.plane.n_clients,
        sessions=SESSIONS,
        windows=WINDOWS,
        build_s=build_s,
        idle_ticks_per_s=idle_ticks_per_s,
        ring_shape=list(ring.shape),
        ring_gb=ring.numel() * ring.element_size() / 1e9,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        served=dict(sorted(gw.served.items())),
        checked_vehicles=16,
    )
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import sketch as sk

    smi = nvidia_smi()
    emit({"phase": "env", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    built = _build.build("sketch_fold")
    ptxas = [ln.strip() for ln in _build.build_log("sketch_fold").splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_s": built,
          "ptxas": ptxas})

    main_case = phase_kernels(sk)

    sk.launches = 0  # count only the main path's launches
    serve = phase_serve(sk)
    launches = sk.launches
    check(launches > 0, "the serve path launched the sketch-fold kernel")
    serve["sketch_fold_launches"] = launches
    emit({"phase": "serve", **serve})

    emit({"kernels": [{
        "name": "sketch_fold",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sketch_fold.cu",
        "replaces": "src/repro/kernels/sketch.py:274",
        "launches": launches,
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
