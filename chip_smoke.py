"""Run the PyTorch port on one NVIDIA GPU: build its kernels, hold each one
against its plain PyTorch version, then drive the system's paths at full
size through the entry points a user calls: the analyst-serving path
(reads and analytics windows through the gateway), the federated round
(rounds submitted through the gateway, then the int8 upload codec on a
full-size model delta), and LLM serving twice: `serve_loop` over qwen3-4b
at its full published width and depth, with the flash-attention kernel as
the prefill's attention core, and over jamba-1.5-large's hybrid block at
its full published width (one block of eight layers, its MoE FFNs made
dense), whose seven mamba layers run the selective-scan kernel in every
prefill and decode step. bf16, random weights from a seed.

    python3 chip_smoke.py

Phases, one JSON line each: `env`, `build`, `kernels` (one line per
kernel case, all four kernels), `serve`, `federated`, `llm_serve`,
`llm_hybrid`. Then
the kernel summary line, the card's name and power limit as `nvidia-smi`
prints them, and last ``{"ok": true, "device": {...}}``. Any failed check
raises and the script exits non-zero; without CUDA it exits non-zero
before printing anything.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
DEVICE = "cuda"
N_VEHICLES = 100_000
SESSIONS = 32
WINDOWS = 3
SIGNAL = "Vehicle.FuelRate"
FED_ROUNDS = 2
FED_DIM = 32
#: the full-size int8 case: a 268M-parameter delta in the codec's rows
QUANT_ROWS, QUANT_COLS = 65_536, 4096
#: the full-size model of the client_delta check: LAYERS (width, width)
#: least-squares layers, LAYERS * width**2 = QUANT_ROWS * QUANT_COLS
LAYERS, WIDTH = 16, 4096
#: the LLM path: the launcher's defaults, then one wave of long prompts
LLM_ARCH = "qwen3-4b"
LLM_REQUESTS, LLM_MAX_NEW, LLM_CACHE_LEN, LLM_BATCH = 8, 16, 128, 4
LLM_LONG_PROMPT = 2048
#: the flash kernel's cases: name, (B, S, H, KV, D), window, dtype, causal.
#: The first is the LLM path's prefill shape, whose timings go in the
#: summary; the second is the LLM phase's long wave; the next two are the
#: hybrid phase's prefill shapes (jamba: 64 query heads on 8 KV heads).
FLASH_CASES = [
    ("serve prefill (qwen3-4b, wave of 4 prompts <= 48)", (4, 48, 32, 8, 128), None,
     torch.bfloat16, True),
    ("long wave (qwen3-4b, 4 prompts of 2048)", (4, LLM_LONG_PROMPT, 32, 8, 128), None,
     torch.bfloat16, True),
    ("hybrid serve prefill (jamba, wave of 4 prompts <= 47)", (4, 47, 64, 8, 128), None,
     torch.bfloat16, True),
    ("hybrid long wave (jamba, 4 prompts of 2048)", (4, LLM_LONG_PROMPT, 64, 8, 128), None,
     torch.bfloat16, True),
    ("long prompt (qwen3-4b)", (4, 4096, 32, 8, 128), None, torch.bfloat16, True),
    ("gemma3-1b local layer", (1, 4096, 4, 1, 256), 512, torch.bfloat16, True),
    ("h2o-danube-3-4b layer", (1, 8192, 32, 8, 120), 4096, torch.bfloat16, True),
    ("ragged f32", (2, 47, 32, 8, 128), None, torch.float32, True),
    ("non-causal, windowed (the wrapper's other mask)", (2, 300, 8, 2, 128), 100,
     torch.bfloat16, False),
]
#: the flash kernels' key tile (csrc/flash_attention.cu: kBlockKeys of the
#: bf16 tensor-core kernel, kTile of the f32 one)
FLASH_TILE = 64
#: the flash kernel of each path (`flash_attention.PATHS`), as ptxas names it
FLASH_KERNELS = {"tensor_cores": "flash_fwd_tc", "cuda_cores": "flash_fwd_f32"}
#: the hybrid LLM path: jamba-1.5-large at full width, cut to one block
HYBRID_ARCH = "jamba-1.5-large-398b"
#: the selective-scan kernel's cases: name, (B, S, inner, state), x dtype,
#: with h0. The first is the hybrid path's long wave, whose timings go in
#: the summary; then its serve wave and decode step, then a ragged one.
SSM_CASES = [
    ("long wave (jamba, 4 prompts of 2048)", (4, LLM_LONG_PROMPT, 16384, 16), torch.bfloat16,
     False),
    ("serve wave (jamba, 4 prompts <= 48)", (4, 48, 16384, 16), torch.bfloat16, False),
    ("decode step (jamba)", (4, 1, 16384, 16), torch.bfloat16, True),
    ("ragged f32", (2, 1000, 1000, 16), torch.float32, True),
]
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense


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


def quant_special(cols: int) -> torch.Tensor:
    """A zero row, a row of exact .5 ties after scaling (absmax 254, so
    s = 2), a row that clips at +-127, and a row with a NaN (last)."""
    ties = (torch.arange(cols, dtype=torch.float32) % 255) - 127
    ties[0] = 254.0
    clip = torch.linspace(-1.0, 1.0, cols)
    clip[0], clip[-1] = 1e30, -1e30
    nan_row = torch.linspace(-3.0, 3.0, cols)
    nan_row[cols // 2] = torch.nan
    return torch.stack([torch.zeros(cols), ties, clip, nan_row]).to(DEVICE)


def phase_quantize(qz) -> dict:
    """Hold the int8 kernel against `quantize_int8_plain` on the card,
    bitwise on q and s (s only where a row holds a NaN), at the codec's
    full size and at the edge shapes. Returns the full-size timings."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    cases = [  # name, shape, special rows
        ("full", (QUANT_ROWS, QUANT_COLS), False),
        ("one row", (1, 4096), False),
        ("round payload rows", (4096, 256), False),
        ("ragged cols", (4096, 1000), False),
        ("scalar path", (4096, 1001), False),
        ("zero, ties, clip, NaN rows", (4, 4096), True),
        ("zero, ties, clip, NaN rows", (4, 1001), True),
    ]
    worst = 0.0
    full = None
    for name, shape, special in cases:
        name = f"{name} {shape}"
        if special:
            x = quant_special(shape[1])
        else:
            scale = torch.rand((shape[0], 1), generator=gen, device=DEVICE) * 10 + 1e-3
            x = torch.randn(shape, generator=gen, device=DEVICE) * scale
        before = qz.launches
        q, s = qz.quantize_int8(x)
        torch.cuda.synchronize()
        check(qz.launches == before + 1, f"{name}: the kernel launched once")
        qp, sp = qz.quantize_int8_plain(x)
        finite = ~torch.isnan(x).any(dim=1)
        check(torch.equal(torch.isnan(s), ~finite) and torch.equal(torch.isnan(sp), ~finite),
              f"{name}: a NaN row, and only it, gets a NaN scale")
        equal = (torch.equal(q[finite], qp[finite])
                 and torch.equal(s[finite].view(torch.int32), sp[finite].view(torch.int32)))
        err = max(float((q[finite].int() - qp[finite].int()).abs().max()) if finite.any() else 0.0,
                  float((s[finite] - sp[finite]).abs().max()) if finite.any() else 0.0)
        worst = max(worst, err)
        check(equal, f"{name}: kernel == plain version bit for bit")
        line = {"phase": "kernels", "kernel": "quantize_int8", "case": name,
                "shape": list(x.shape), "equal": equal, "max_abs_err": err,
                "nan_rows": int((~finite).sum())}
        if full is None:
            rows, cols = x.shape
            nbytes = rows * cols * (4 + 1) + rows * 4
            ops = 5 * rows * cols  # abs, max, divide, round, clamp a value
            bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
            ops_ms = 1e3 * ops / PEAK_F32_OPS_PER_S
            full = {
                "kernel_ms": median_ms(lambda: qz.quantize_int8(x)),
                "plain_ms": median_ms(lambda: qz.quantize_int8_plain(x)),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                # torch.quantize_per_channel needs the scales given and
                # clamps to -128: no single PyTorch call computes this
                "library_ms": None,
                "bytes": nbytes, "ops": ops,
            }
            line.update(full)
        line["launches"] = qz.launches
        emit(line)
        del x, q, s, qp, sp
    torch.cuda.empty_cache()
    full["max_abs_err"] = worst
    return full


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
    return out, gw


def fed_model(seed: int) -> dict:
    """A full-size model, made on the card from a seed: LAYERS
    least-squares layers of (WIDTH, WIDTH), QUANT_ROWS * QUANT_COLS
    parameters."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return {f"layer{i:02d}": torch.randn((WIDTH, WIDTH), generator=gen, device=DEVICE) * 0.01
            for i in range(LAYERS)}


def fed_batch(seed: int) -> tuple:
    """One vehicle's batch for `fed_loss`: inputs (64, WIDTH) and one
    target block a layer."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return (torch.randn((64, WIDTH), generator=gen, device=DEVICE),
            torch.randn((LAYERS, 64, WIDTH), generator=gen, device=DEVICE))


def fed_loss(p: dict, batch: tuple) -> torch.Tensor:
    x, y = batch
    return sum(torch.mean((x @ p[k] - y[i]) ** 2) for i, k in enumerate(sorted(p)))


def phase_federated(gw, qz) -> dict:
    """The federated round at full size, on the serve world's 100 000
    vehicles: one analyst session submits FED_ROUNDS rounds through the
    gateway (each on every online vehicle, its uploads aggregated on the
    card by `aggregate_packed`) while the other sessions read, under the
    profiler; then `client_delta` + `aggregate_deltas` with the int8
    codec on a full-size model delta, which runs the int8 kernel."""
    from repro_torch.fleet import compression, federated, rounds

    sess = gw.session("fed-analyst")
    round_s, bodies = [], []
    activities = [torch.profiler.ProfilerActivity.CPU]
    if DEVICE == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(FED_ROUNDS):
            t1 = time.perf_counter()
            ticket = sess.submit_round(dim=FED_DIM)
            reads = [gw.session(f"analyst-{s}").fleet_stats(SIGNAL) for s in range(4)]
            gw.run_until_idle()
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t1)
            check(ticket.done and ticket.response.ok, f"round answered ok: {ticket.response}")
            check(all(r.done and r.response.ok for r in reads), "reads beside the round ok")
            body = ticket.response.body
            check(body["participants"] > 0 and np.isfinite(body["dist_to_optimum"])
                  and np.isfinite(body["mean_client_loss"]), f"round {body['round']}: finite")
            bodies.append(body)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    check([b["round"] for b in bodies] == list(range(FED_ROUNDS)), "rounds numbered in order")
    check(bodies[-1]["dist_to_optimum"] < bodies[0]["dist_to_optimum"],
          "the model moved toward the optimum")
    out = {"rounds": bodies, "round_s": round_s, **device_time(prof, wall_ms)}

    # the server step of the last round, against an f64 sum of the same
    # uploads and the per-client loop. Any order of summing N f32 terms,
    # each a product of two roundings, is within (N + 2) * 2^-24 *
    # sum|terms| of the exact sum (the a-priori bound): both are held to
    # it, and both errors against the f64 sum are kept.
    driver = gw._fed["fed-analyst"]
    msgs = driver.last_msgs
    weights = np.asarray([float(m.get("n_samples", 1)) for m in msgs], np.float32)
    t1 = time.perf_counter()
    got = rounds.aggregate_packed(msgs, weights, device=DEVICE)
    out["aggregate_packed_wall_ms"] = 1e3 * (time.perf_counter() - t1)
    q, s, n, _ = rounds.stack_deltas(msgs)
    out["dequant_mean_device_ms"] = median_ms(
        lambda: compression.batched_dequant_mean(q, s, weights, device=DEVICE))
    want = rounds.aggregate_reference(msgs, weights)
    w64 = weights.astype(np.float64) / weights.astype(np.float64).sum()
    terms = (w64[:, None] * s.astype(np.float64))[:, :, None] * q.astype(np.float64)
    truth = terms.sum(axis=0).reshape(-1)[:n]
    bound = (len(msgs) + 2) * 2.0**-24 * np.abs(terms).sum(axis=0).reshape(-1)[:n]
    check(got.shape == want.shape == (n,) and np.isfinite(got).all(), "aggregate finite, shape")
    check(bool((np.abs(got - truth) <= bound).all()), "aggregate_packed vs the f64 sum")
    check(bool((np.abs(got - want) <= 2 * bound).all()), "aggregate_packed vs aggregate_reference")
    err_truth = float(np.abs(got - truth).max())
    err_loop = float(np.abs(got - want).max())
    out.update(aggregate_clients=len(msgs), aggregate_err_vs_f64=err_truth,
               aggregate_err_vs_reference=err_loop,
               reference_err_vs_f64=float(np.abs(want - truth).max()),
               aggregate_max_abs=float(np.abs(truth).max()),
               aggregate_bound_max=float(bound.max()))
    del q, s, terms

    # the codec on a full-size delta: two vehicles' local SGD, one through
    # error feedback; the kernel runs once for each upload. FedAvg's step
    # lowers the weighted objective of the two vehicles.
    params = fed_model(SEED + 2)
    batches = [fed_batch(SEED + 3), fed_batch(SEED + 4)]
    weights = [1.0, 3.0]
    cfg = federated.FedConfig(local_steps=2, local_lr=0.05, server_lr=1.0, codec="int8")
    before = qz.launches
    t1 = time.perf_counter()
    ef = compression.ErrorFeedback(compression.Int8Codec())
    deltas = [federated.client_delta(fed_loss, params, batches[0], cfg, ef),
              federated.client_delta(fed_loss, params, batches[1], cfg, None)]
    new = federated.aggregate_deltas(params, deltas, cfg, weights=weights)
    torch.cuda.synchronize()
    out["client_delta_and_aggregate_s"] = time.perf_counter() - t1
    check(qz.launches == before + 2, "client_delta launched the int8 kernel once per upload")
    msg = deltas[0]["msg"]
    check(tuple(msg["q"].shape) == (QUANT_ROWS, QUANT_COLS), "full-size upload")
    # |delta - q*s| <= s/2, plus 1e-4 of a step for the f32 rounding of q*s
    half_step = (msg["s"] * 0.5001)[:, None]
    check(bool((ef._residual.reshape(QUANT_ROWS, QUANT_COLS).abs() <= half_step).all()),
          "int8 upload within half a step of the delta")
    check(all(bool(torch.isfinite(v).all()) for v in new.values()), "aggregated model finite")

    def objective(p):
        return sum(w * float(fed_loss(p, b)) for w, b in zip(weights, batches)) / sum(weights)

    loss0, loss1 = objective(params), objective(new)
    check(loss1 < loss0, f"the aggregated model lowers the loss: {loss0} -> {loss1}")
    out.update(full_size_params=sum(v.numel() for v in params.values()),
               upload_bytes=compression.Int8Codec().nbytes(msg),
               compression_ratio=ef.compression_ratio, loss_before=loss0, loss_after=loss1)

    # the top-k codec (FedConfig(codec="topk")) on the same full-size
    # delta: its selection against the full stable sort of |delta|, which
    # gives lax.top_k's order too, and against torch.topk alone
    flat = torch.cat([(new[name] - params[name]).reshape(-1) for name in sorted(params)])
    topk = compression.TopKCodec()
    k = max(1, int(flat.shape[0] * topk.fraction))
    sort_idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    check(torch.equal(topk.encode(flat)["idx"].long(), sort_idx),
          "top-k encode picks the stable sort's first k, in its order")
    del sort_idx
    out.update(
        topk_k=k,
        topk_encode_ms=median_ms(lambda: topk.encode(flat), reps=5),
        topk_full_stable_sort_ms=median_ms(
            lambda: torch.sort(flat.abs(), descending=True, stable=True), reps=5),
        torch_topk_ms=median_ms(lambda: torch.topk(flat.abs(), k, sorted=False), reps=5),
    )
    del flat
    del params, batches, deltas, new, ef, msg
    torch.cuda.empty_cache()
    return out


def attended_pairs(S: int, window: int | None, causal: bool) -> int:
    """Unmasked (query, key) pairs over S positions: query i sees keys up
    to i (causal) or all of them, and with `window` none before
    i - window + 1."""
    total = 0
    for i in range(S):
        lo = 0 if window is None else max(0, i - window + 1)
        total += (i if causal else S - 1) - lo + 1
    return total


def live_mask(rows: torch.Tensor, S: int, window: int | None, causal: bool) -> torch.Tensor:
    """(len(rows), S) booleans: which keys each query row sees."""
    i, j = rows[:, None], torch.arange(S, device=rows.device)[None, :]
    live = (i >= j) if causal else torch.ones_like(i >= j)
    return live & ((i - j) < window) if window is not None else live


def sdpa(q, k, v, window, causal):
    """The library column: one `scaled_dot_product_attention` call on the
    same inputs ((B, H, S, D) views; a boolean mask unless plain causal).
    Timed here only; the port never calls it."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if causal and window is None:
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    S = q.shape[1]
    mask = live_mask(torch.arange(S, device=q.device), S, window, causal)
    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def flash_err_over_tol(got: torch.Tensor, plain: torch.Tensor) -> float:
    """The largest |got - plain| / tol over the elements; at most 1 passes.
    f32: tol = 2e-5, the JAX package's. bf16: both sides round the same
    f32 value (up to the order of f32 sums, far below 2e-5) to bf16, so
    they part by at most one bf16 step, 2^-7 of the value: tol =
    2^-7 |plain| + 2e-5. A fixed 3e-2 would be as large as the outputs
    themselves at long S (~0.03 at 4096 keys)."""
    diff = (got.float() - plain.float()).abs()
    tol = 2e-5 + (2**-7 * plain.float().abs() if plain.dtype == torch.bfloat16 else 0.0)
    return float((diff / tol).max())


def dropped_tile(q, k, v, plain, window, causal):
    """What a kernel that skipped one key tile would return: `plain` with
    the last query tile's rows recomputed without the first key tile they
    see. None where those rows see a single tile."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    r0 = (S - 1) // FLASH_TILE * FLASH_TILE
    k0 = (0 if window is None else max(0, r0 - window + 1)) // FLASH_TILE * FLASH_TILE
    if k0 + FLASH_TILE >= S:
        return None
    rows = torch.arange(r0, S, device=q.device)
    j = torch.arange(S, device=q.device)[None, :]
    live = live_mask(rows, S, window, causal) & ((j < k0) | (j >= k0 + FLASH_TILE))
    qg = (q[:, r0:].float() / math.sqrt(D)).reshape(B, S - r0, KV, H // KV, D)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()).masked_fill(~live, -1e30)
    late = torch.einsum("bkgts,bskd->btkgd", torch.softmax(s, dim=-1), v.float())
    out = plain.clone()
    out[:, r0:] = late.reshape(B, S - r0, H, D).to(plain.dtype)
    return out


def ptxas_usage(log: str, kernel: str) -> list[dict]:
    """Registers and spill bytes of each instantiation of `kernel` in an
    `nvcc -Xptxas -v` log, as `[{"function", "registers", "spill_stores",
    "spill_loads"}]`."""
    out, current = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry.group(1)
            if kernel not in name:
                current = None
                continue
            arg = re.search(kernel + r"ILi(\d+)E", name)
            current = {"function": f"{kernel}<{arg.group(1)}>" if arg else kernel}
            out.append(current)
        elif current is not None and (spill := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            current["spill_stores"], current["spill_loads"] = map(int, spill.groups())
        elif current is not None and (regs := re.search(r"Used (\d+) registers", line)):
            current["registers"] = int(regs.group(1))
    return out


def phase_flash(fa, build_log: str) -> dict:
    """Hold the flash-attention kernel against `flash_attention_plain` on
    the card at the LLM path's shapes, at the configs' long and windowed
    ones and at the non-causal mask, elementwise (`flash_err_over_tol`).
    Where the last query tile sees more than one key tile, the same check
    must refuse the plain output with one of those tiles dropped. Each
    case's line names the path its dtype runs (`fa.PATHS`) and that
    kernel's registers and spills from `build_log`. Returns the
    serve-prefill case's timings, and the worst error over all cases."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    first, worst = None, 0.0
    for name, (B, S, H, KV, D), window, dtype, causal in FLASH_CASES:
        q = torch.randn((B, S, H, D), generator=gen, device=DEVICE).to(dtype)
        k = torch.randn((B, S, KV, D), generator=gen, device=DEVICE).to(dtype)
        v = torch.randn((B, S, KV, D), generator=gen, device=DEVICE).to(dtype)
        before = fa.launches
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(fa.launches == before + 1, f"{name}: the kernel launched once")
        plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        err = float((got.float() - plain.float()).abs().max())
        over = flash_err_over_tol(got, plain)
        check(bool(torch.isfinite(got).all()) and over <= 1.0,
              f"{name}: kernel vs plain version, max |err| / tol {over} <= 1")
        worst = max(worst, err)
        mutant = dropped_tile(q, k, v, plain, window, causal)
        mutant_over = mutant_err = None
        if mutant is not None:
            mutant_over = flash_err_over_tol(mutant, plain)
            mutant_err = float((mutant.float() - plain.float()).abs().max())
            check(mutant_over > 1.0, f"{name}: the check refuses a dropped key tile")
        del plain, mutant
        lib = sdpa(q, k, v, window, causal)
        library_err = float((lib.transpose(1, 2).float() - got.float()).abs().max())
        del lib
        flops = 4 * B * H * D * attended_pairs(S, window, causal)
        nbytes = 2 * (q.numel() + k.numel()) * q.element_size()  # q, k, v, out once
        peak = PEAK_BF16_OPS_PER_S if dtype == torch.bfloat16 else PEAK_F32_OPS_PER_S
        ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES_PER_S
        timing = {
            "kernel_ms": median_ms(
                lambda: fa.flash_attention(q, k, v, causal=causal, window=window)),
            "plain_ms": median_ms(
                lambda: fa.flash_attention_plain(q, k, v, causal=causal, window=window)),
            "library_ms": median_ms(lambda: sdpa(q, k, v, window, causal)),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "bytes": nbytes,
        }
        timing["flop_rate_tflops"] = flops / timing["kernel_ms"] / 1e9
        path = fa.PATHS[dtype]
        emit({"phase": "kernels", "kernel": "flash_attention", "case": name,
              "shape": [B, S, H, KV, D], "window": window, "causal": causal,
              "dtype": str(dtype), "path": path,
              "ptxas": ptxas_usage(build_log, FLASH_KERNELS[path]),
              "max_abs_err": err, "err_over_tol": over,
              "out_abs_max": float(got.float().abs().max()),
              "dropped_tile_err_over_tol": mutant_over, "dropped_tile_max_abs_diff": mutant_err,
              "library_max_abs_err": library_err, **timing, "launches": fa.launches})
        if first is None:
            first = timing
        del q, k, v, got
        torch.cuda.empty_cache()
    return {**first, "max_abs_err": worst}


def scan_inputs(B, S, inner, state, x_dtype, with_h0, gen):
    """Scan inputs on the card from a seeded generator, in the mixer's
    ranges: dt = softplus(normal)·0.1 (mostly 1e-3..0.3), Bm, Cm, x and
    h0 normal, A = -exp(0.5·normal)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    dt = F.softplus(randn(B, S, inner)) * 0.1
    out = [dt, randn(B, S, state), randn(B, S, state), randn(B, S, inner).to(x_dtype),
           -torch.exp(0.5 * randn(inner, state))]
    return out + [randn(B, inner, state) if with_h0 else None]


def scan_err_over_tol(got, plain, tol) -> float:
    """The largest |got - plain| / tol over y and h (`ssm_scan_tolerance`:
    what f32 rounding allows two evaluations of the recurrence); at most 1
    passes."""
    return max(float(((g - p).abs() / t).max()) for g, p, t in zip(got, plain, tol))


def scan_faults(sc, dt, Bm, Cm, x, A, h0) -> dict:
    """What a faulty kernel would return, from the plain version: one that
    skipped step S // 2's update, and one that lost the carried state (h0
    ignored, or, without h0, the state reset at S // 2)."""
    S, t = dt.shape[1], dt.shape[1] // 2

    def part(lo, hi, h):
        return sc.ssm_scan_plain(dt[:, lo:hi], Bm[:, lo:hi], Cm[:, lo:hi], x[:, lo:hi], A, h)

    y1, h1 = part(0, t, h0)
    y2, h2 = part(t + 1, S, h1)
    skipped = (torch.cat([y1, (h1 * Cm[:, t][:, None, :]).sum(-1)[:, None], y2], dim=1), h2)
    if h0 is not None:
        lost = sc.ssm_scan_plain(dt, Bm, Cm, x, A, None)
    else:
        y3, h3 = part(t, S, None)
        lost = (torch.cat([y1, y3], dim=1), h3)
    return {"skipped_step": skipped, "lost_carry": lost}


def phase_ssm(sc) -> dict:
    """Hold the selective-scan kernel against `ssm_scan_plain` on the card
    at the hybrid path's shapes (long wave, serve wave, a decode step from
    a carried state) and a ragged f32 one, y and the final h elementwise
    within `ssm_scan_tolerance`; the same check must refuse the plain
    output with one time step's update skipped or the carried state lost.
    Returns the long wave's timings, and the worst error over all cases."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    first, worst = None, 0.0
    for name, (B, S, inner, state), x_dtype, with_h0 in SSM_CASES:
        dt, Bm, Cm, x, A, h0 = scan_inputs(B, S, inner, state, x_dtype, with_h0, gen)
        before = sc.launches
        got = sc.ssm_scan(dt, Bm, Cm, x, A, h0)
        torch.cuda.synchronize()
        check(sc.launches == before + 1, f"{name}: the kernel launched once")
        plain = sc.ssm_scan_plain(dt, Bm, Cm, x, A, h0)
        tol = sc.ssm_scan_tolerance(dt, Bm, Cm, x, A, h0)
        err = max(float((g - p).abs().max()) for g, p in zip(got, plain))
        over = scan_err_over_tol(got, plain, tol)
        check(all(bool(torch.isfinite(g).all()) for g in got) and over <= 1.0,
              f"{name}: kernel vs plain version, max |err| / tol {over} <= 1")
        faults = {k: scan_err_over_tol(v, plain, tol)
                  for k, v in scan_faults(sc, dt, Bm, Cm, x, A, h0).items()}
        check(all(v > 1.0 for v in faults.values()), f"{name}: the check refuses {faults}")
        worst = max(worst, err)
        updates = B * S * inner * state
        # dt, x and y once, Bm and Cm, A, h0 and the final h
        nbytes = (B * S * inner * (8 + x.element_size()) + 2 * B * S * state * 4
                  + inner * state * 4 + B * inner * state * 4 * (2 if with_h0 else 1))
        # per update: dt·A, exp, abar·h, dx·B, +, h·C, +; per (b, t, c): dt·x
        ops = 7 * updates + B * S * inner
        ops_ms, bytes_ms = 1e3 * ops / PEAK_F32_OPS_PER_S, 1e3 * nbytes / PEAK_BYTES_PER_S
        reps = 5 if S > 100 else 20
        timing = {
            "kernel_ms": median_ms(lambda: sc.ssm_scan(dt, Bm, Cm, x, A, h0)),
            "plain_ms": median_ms(lambda: sc.ssm_scan_plain(dt, Bm, Cm, x, A, h0),
                                  reps=reps, warmup=1),
            "library_ms": None,  # no single PyTorch call computes a selective scan
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bytes": nbytes, "ops": ops, "exps": updates,
        }
        emit({"phase": "kernels", "kernel": "ssm_scan", "case": name,
              "shape": [B, S, inner, state], "x_dtype": str(x_dtype), "h0": with_h0,
              "max_abs_err": err, "err_over_tol": over,
              "y_abs_max": float(got[0].abs().max()), "h_abs_max": float(got[1].abs().max()),
              "fault_err_over_tol": faults, **timing, "launches": sc.launches})
        if first is None:
            first = timing
        del dt, Bm, Cm, x, A, h0, got, plain, tol
        torch.cuda.empty_cache()
    return {**first, "max_abs_err": worst}


def llm_requests(cfg, n: int, seed: int) -> list:
    """The launcher's request mix (`launch.serve --llm`): prompt lengths
    drawn in [8, 48), tokens uniform over the vocabulary."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    return [Request(f"req-{i}", rng.integers(0, cfg.vocab_size, (int(rng.integers(8, 48)),)),
                    max_new_tokens=LLM_MAX_NEW) for i in range(n)]


class StepTimer:
    """Wall time of each `prefill` / `decode_step` the engine calls, each
    ending in a synchronize, by wrapping the engine module's two names."""

    def __init__(self):
        from repro_torch.serve import engine

        self.engine, self.ms = engine, {"prefill": [], "decode": []}
        self.saved = engine.prefill, engine.decode_step

    def _wrap(self, fn, key):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms[key].append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    def __enter__(self):
        self.engine.prefill = self._wrap(self.saved[0], "prefill")
        self.engine.decode_step = self._wrap(self.saved[1], "decode")
        return self

    def __exit__(self, *exc):
        self.engine.prefill, self.engine.decode_step = self.saved


def hybrid_config():
    """jamba-1.5-large at its full published width, cut to one block of
    eight layers (of nine), with each MoE FFN made a dense SwiGLU of one
    expert's width: 7 mamba layers and attention at in-block index 4."""
    from repro_torch.configs import get_config

    cfg = get_config(HYBRID_ARCH)
    (pattern, _), = cfg.groups
    dense = tuple(dataclasses.replace(spec, ffn="dense") for spec in pattern)
    return dataclasses.replace(cfg, name=f"{cfg.name} (1 block, dense FFNs)",
                               groups=((dense, 1),))


def phase_llm(cfg, fa, sc, plain_core: dict) -> dict:
    """LLM serving of `cfg` in bf16 on the card: `serve_loop` with the
    launcher's defaults (8 requests of 8-47 tokens, 16 new tokens each,
    batches of 4, cache 128), then one wave of 4 prompts of 2048 tokens
    (cache 2048 + 16), timed, then once more under the profiler. The flash
    kernel must launch once per attention layer and prefill, the scan
    kernel once per mamba layer and prefill or decode step. Then the same
    model with the plain cores named in `plain_core` (`attn_impl` and/or
    `scan_impl`): the last-position logits of the first wave's prefill,
    held to the bf16 model's own error (see below), and the greedy tokens
    of the whole serve_loop."""
    from repro_torch.fleet.compression import tree_map
    from repro_torch.models import init_params, param_count, prefill
    from repro_torch.serve import ServeEngine, serve_loop

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 yardstick stays f32
    torch.cuda.reset_peak_memory_stats()
    phase_t0 = time.perf_counter()
    mixers = [spec.mixer for spec in cfg.layer_specs()]
    n_attn, n_mamba = mixers.count("attn"), mixers.count("mamba")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    torch.cuda.synchronize()
    out = {"arch": cfg.name, "dtype": str(cfg.dtype), "n_layers": cfg.n_layers,
           "attn_layers": n_attn, "mamba_layers": n_mamba,
           "param_count": param_count(params), "init_s": time.perf_counter() - t0}
    engine = ServeEngine(cfg, params, cache_len=LLM_CACHE_LEN)
    serve_loop(engine, llm_requests(cfg, LLM_BATCH, SEED + 1), batch_size=LLM_BATCH)  # warm-up

    rng = np.random.default_rng(SEED + 2)
    long_prompts = rng.integers(0, cfg.vocab_size, (LLM_BATCH, LLM_LONG_PROMPT))
    long_engine = ServeEngine(cfg, params, cache_len=LLM_LONG_PROMPT + LLM_MAX_NEW)
    reqs = llm_requests(cfg, LLM_REQUESTS, SEED)

    def main_path():
        t0 = time.perf_counter()
        results = serve_loop(engine, reqs, batch_size=LLM_BATCH)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        long_tokens = long_engine.generate(long_prompts, max_new_tokens=LLM_MAX_NEW)
        torch.cuda.synchronize()
        return results, long_tokens, t1 - t0, time.perf_counter() - t1

    # the timed run: host clock around each prefill and decode step (each
    # ending in a synchronize); the kernels' launches are counted over it
    fa.launches = sc.launches = 0  # count only the main path's launches
    with StepTimer() as timer:
        results, long_tokens, serve_s, long_s = main_path()
    flash_launches, ssm_launches = fa.launches, sc.launches
    prefills, steps = len(timer.ms["prefill"]), len(timer.ms["decode"])
    check(prefills == 3 and steps == 3 * LLM_MAX_NEW,
          f"two serve waves and the long wave: {prefills} prefills, {steps} decode steps")
    check(flash_launches == n_attn * prefills,
          f"flash launches {flash_launches} == {n_attn} attention layers x {prefills} prefills")
    check(ssm_launches == n_mamba * (prefills + steps),
          f"scan launches {ssm_launches} == {n_mamba} mamba layers x "
          f"({prefills} prefills + {steps} decode steps)")
    tokens = sum(len(v) for v in results.values())
    check(tokens == LLM_REQUESTS * LLM_MAX_NEW and long_tokens.shape == (LLM_BATCH, LLM_MAX_NEW),
          "every request got its tokens")
    check(all(0 <= t < cfg.vocab_size for v in results.values() for t in v)
          and bool(((long_tokens >= 0) & (long_tokens < cfg.vocab_size)).all()),
          "tokens inside the vocabulary")
    out.update(
        requests=LLM_REQUESTS, max_new=LLM_MAX_NEW, batch_size=LLM_BATCH,
        cache_len=LLM_CACHE_LEN, prompt_lengths=[len(r.prompt) for r in reqs],
        flash_launches=flash_launches, ssm_launches=ssm_launches,
        prefills=prefills, decode_steps=steps,
        prefill_ms=timer.ms["prefill"],
        decode_ms_per_step_serve=statistics.median(timer.ms["decode"][:-LLM_MAX_NEW]),
        decode_ms_per_step_long=statistics.median(timer.ms["decode"][-LLM_MAX_NEW:]),
        serve_loop_s=serve_s, serve_tokens=tokens, serve_tokens_per_s=tokens / serve_s,
        long_wave_s=long_s, long_prompt=LLM_LONG_PROMPT,
        long_prefill_tokens_per_s=LLM_BATCH * LLM_LONG_PROMPT / (timer.ms["prefill"][-1] / 1e3),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )

    # the same run again under the profiler, for the device's busy time.
    # The profiler's own host cost per op stretches the wall time, so the
    # idle share is given against both walls: the profiled one and the
    # timed run's (the same work, unprofiled).
    activities = [torch.profiler.ProfilerActivity.CPU]
    if DEVICE == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        again, again_long, _, _ = main_path()
    out.update(device_time(prof, 1e3 * (time.perf_counter() - t0)))
    out["rerun_same_tokens"] = again == results and bool(np.array_equal(again_long, long_tokens))
    if out["device_busy_ms"] is not None:
        out["device_idle_share_unprofiled_wall"] = (
            1.0 - out["device_busy_ms"] / (1e3 * (serve_s + long_s)))

    # The kernels against the plain core in the same bf16 model. Tolerance:
    # both round every layer's output to bf16 and differ only in the
    # kernel's f32 summation order, so they may part by the rounding flips
    # of a bf16 model, never by more than bf16 itself moves the logits.
    # That yardstick is measured here: the same model in f32 (the weights
    # upcast, plain cores, no TF32). The check is
    # |kernel - plain| <= 2 x |plain - f32 model|, both as max abs over the
    # logits of the first serve wave's prefill.
    first = reqs[:LLM_BATCH]
    S = max(len(r.prompt) for r in first)
    wave = torch.as_tensor(np.stack([np.pad(r.prompt, (S - len(r.prompt), 0)) for r in first]),
                           device=DEVICE)
    plain_cores = {"attn_impl": fa.flash_attention_plain, "scan_impl": sc.ssm_scan_plain}
    with torch.no_grad():
        got, _ = prefill(params, cfg, {"tokens": wave}, LLM_CACHE_LEN)
        plain, _ = prefill(params, cfg, {"tokens": wave}, LLM_CACHE_LEN, **plain_core)
        f32 = tree_map(lambda t: t.to(torch.float32), params)
        ref32, _ = prefill(f32, dataclasses.replace(cfg, param_dtype="float32"),
                           {"tokens": wave}, LLM_CACHE_LEN, **plain_cores)
        del f32
    err = float((got - plain).abs().max())
    bf16_err = float((plain - ref32).abs().max())
    check(bool(torch.isfinite(got).all()) and got.shape == (LLM_BATCH, 1, cfg.padded_vocab),
          "prefill logits finite, (B, 1, V)")
    check(err <= 2 * bf16_err, f"kernel vs plain logits {err} <= 2 x bf16 model error {bf16_err}")
    plain_results = serve_loop(ServeEngine(cfg, params, cache_len=LLM_CACHE_LEN, **plain_core),
                               llm_requests(cfg, LLM_REQUESTS, SEED), batch_size=LLM_BATCH)
    same = sum(a == b for rid in results for a, b in zip(results[rid], plain_results[rid]))
    first_tokens_same = sum(results[rid][0] == plain_results[rid][0] for rid in results)
    out.update(
        plain_core=sorted(plain_core),
        logits_max_abs_diff_kernel_vs_plain=err, logits_max_abs_diff_plain_vs_f32=bf16_err,
        logits_abs_max=float(plain.abs().max()),
        argmax_same_prefill=int((got.argmax(-1) == plain.argmax(-1)).sum()),
        greedy_tokens_same=same, greedy_tokens=tokens,
        greedy_first_tokens_same=first_tokens_same,
    )
    del params, engine, long_engine, got, plain, ref32
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - phase_t0
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import sketch as sk
    from repro_torch.kernels import ssm_scan as sc

    smi = nvidia_smi()
    emit({"phase": "env", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    # one nvcc each, all started together
    built = _build.build("sketch_fold", "quantize_int8", "flash_attention", "ssm_scan")
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln] for name in built}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_s": built,
          "ptxas": ptxas})

    sketch_case = phase_kernels(sk)
    quant_case = phase_quantize(qz)
    flash_case = phase_flash(fa, _build.build_log("flash_attention"))
    ssm_case = phase_ssm(sc)

    sk.launches = 0  # count only the serve path's launches
    serve, gw = phase_serve(sk)
    sketch_launches = sk.launches
    check(sketch_launches > 0, "the serve path launched the sketch-fold kernel")
    serve["sketch_fold_launches"] = sketch_launches
    emit({"phase": "serve", **serve})

    qz.launches = 0  # count only the federated path's launches
    fed = phase_federated(gw, qz)
    quant_launches = qz.launches
    check(quant_launches > 0, "the federated path launched the int8 kernel")
    fed["quantize_int8_launches"] = quant_launches
    emit({"phase": "federated", **fed})

    # each resets the kernels' counts just before its main path
    llm = phase_llm(get_config(LLM_ARCH), fa, sc, {"attn_impl": fa.flash_attention_plain})
    check(llm["flash_launches"] > 0, "the LLM path launched the flash-attention kernel")
    emit({"phase": "llm_serve", **llm})
    # the hybrid path against plain cores for both of its kernels
    hybrid = phase_llm(hybrid_config(), fa, sc, {"scan_impl": sc.ssm_scan_plain,
                                                 "attn_impl": fa.flash_attention_plain})
    check(hybrid["ssm_launches"] > 0 and hybrid["flash_launches"] > 0,
          "the hybrid LLM path launched the selective-scan and flash-attention kernels")
    emit({"phase": "llm_hybrid", **hybrid})
    flash_launches = llm["flash_launches"] + hybrid["flash_launches"]

    emit({"kernels": [
        {
            "name": "sketch_fold",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sketch_fold.cu",
            "replaces": "src/repro/kernels/sketch.py:274",
            "launches": sketch_launches,
            "max_abs_err": sketch_case["max_abs_err"],
            "ms": sketch_case["kernel_ms"],
            "plain_ms": sketch_case["plain_ms"],
            "bound_ms": sketch_case["bound_ms"],
            "bound_by": sketch_case["bound_by"],
            "library_ms": sketch_case["library_ms"],
        },
        {
            "name": "quantize_int8",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quantize_int8.cu",
            "replaces": "src/repro/kernels/quantize.py:21",
            "launches": quant_launches,
            "max_abs_err": quant_case["max_abs_err"],
            "ms": quant_case["kernel_ms"],
            "plain_ms": quant_case["plain_ms"],
            "bound_ms": quant_case["bound_ms"],
            "bound_by": quant_case["bound_by"],
            "library_ms": quant_case["library_ms"],
        },
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:30",
            "launches": flash_launches,
            "max_abs_err": flash_case["max_abs_err"],
            "ms": flash_case["kernel_ms"],
            "plain_ms": flash_case["plain_ms"],
            "bound_ms": flash_case["bound_ms"],
            "bound_by": flash_case["bound_by"],
            "library_ms": flash_case["library_ms"],
        },
        {
            "name": "ssm_scan",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:23",
            "launches": hybrid["ssm_launches"],
            "max_abs_err": ssm_case["max_abs_err"],
            "ms": ssm_case["kernel_ms"],
            "plain_ms": ssm_case["plain_ms"],
            "bound_ms": ssm_case["bound_ms"],
            "bound_by": ssm_case["bound_by"],
            "library_ms": ssm_case["library_ms"],
        },
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
