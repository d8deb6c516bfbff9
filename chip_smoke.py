#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from the sources in the checkout, holds each
against its plain PyTorch version on the card, drives ``run_scenario`` at
the paper's size (card against CPU) and at full size (100 M requests over a
1 M-key metadata store on the card), and times each kernel. Every phase
raises on a mismatch; the script exits non-zero without a CUDA device or
outside a checkout. The last line of its output is the JSON device record.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BW_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FULL_REQUESTS = 100_000_000
FULL_KEYS = 1_000_000
FULL_INTERVAL = 10_000


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _device_ms(fn, torch, reps: int = 5, iters: int = 50) -> float:
    """Median over ``reps`` of the mean device time of ``iters`` back-to-back
    calls, by CUDA events. A sleep kernel holds the card while the host
    enqueues the calls, so host launch gaps stay out of the measurement."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def _check_replay(got, want, ctx: str) -> float:
    """Hold one ``chunk_replay`` result against its plain version: hits,
    reads, count and the histogram exact; busy and lat_sum to rtol 1e-5
    (re-associated f32 sums; exact when the latencies are whole ms and the
    sums stay below 2**24). Returns the largest absolute error."""
    import torch

    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0, msg=ctx)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0, msg=ctx)
    for i in (2, 3, 4):
        assert int(got[i]) == int(want[i]), (ctx, i)
    if got[5] is not None or want[5] is not None:
        assert torch.equal(got[5], want[5]), ctx
    return max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs()))


def _check_result(a, b, ctx: str) -> float:
    """Hold two ``SimResult``s of one trace to the engine tolerances: move
    counts and hit rate exact, the f32 aggregates to rtol 1e-5. Returns the
    largest relative difference of the latter."""
    for f in ("replication_moves", "deletion_moves", "evictions", "hit_rate"):
        assert getattr(a, f) == getattr(b, f), (ctx, f, getattr(a, f), getattr(b, f))
    rel = 0.0
    for f in ("throughput_ops_s", "mean_latency_ms", "node_busy_ms", "peak_occupancy_bytes"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        np.testing.assert_allclose(x, y, rtol=1e-5, err_msg=f"{ctx} {f}")
        rel = max(rel, float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-30))))
    return rel


@contextlib.contextmanager
def _plain_versions():
    """Route the engine through the kernels' plain PyTorch versions (on the
    card), the yardstick for a whole run."""
    import repro_torch.core.policy as policy_mod
    import repro_torch.kvsim.simulate as sim_mod
    from repro_torch.kernels.chunk_replay.ref import chunk_replay_ref
    from repro_torch.kernels.ownership_sweep.ref import sweep_ref

    saved = sim_mod.chunk_replay, policy_mod.ownership_sweep
    sim_mod.chunk_replay, policy_mod.ownership_sweep = chunk_replay_ref, sweep_ref
    try:
        yield
    finally:
        sim_mod.chunk_replay, policy_mod.ownership_sweep = saved


def _profile_window(torch, trace, wl, cl, policy, run_scenario, out_dir,
                    unprofiled_chunk_ms: float, chunks: int = 200) -> dict:
    """Where a full-size Redynis chunk's time goes: ``torch.profiler`` over
    the first ``chunks`` chunks of the full-size trace against the full
    1 M-key store. Prints the device time per chunk, its share of the
    unprofiled wall time per chunk, the host launches per chunk, and the
    top kernels by device time and operations by host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sub_r = chunks * FULL_INTERVAL
    sub = trace._replace(keys=trace.keys[:sub_r], nodes=trace.nodes[:sub_r],
                         is_read=trace.is_read[:sub_r])
    sub_wl = wl._replace(num_requests=sub_r)
    run_scenario(sub_wl, cl, policy, daemon_interval=FULL_INTERVAL, trace=sub)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_scenario(sub_wl, cl, policy, daemon_interval=FULL_INTERVAL, trace=sub)
        torch.cuda.synchronize()
    events = prof.key_averages()
    (out_dir / "profile.txt").write_text(
        events.table(sort_by="self_cpu_time_total", row_limit=40) + "\n"
        + events.table(sort_by="self_device_time_total", row_limit=25)
    )
    # Kernel, memset and copy events only: an operator's own row repeats
    # the device time of the kernels it launched.
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    device_chunk_ms = sum(e.self_device_time_total for e in dev) / 1e3 / chunks
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel") / chunks
    top_dev = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    busy = device_chunk_ms / unprofiled_chunk_ms
    print(f"phase 4 profile ({chunks} chunks): device {device_chunk_ms:.4f} ms per chunk, "
          f"{busy:.4f} of the unprofiled {unprofiled_chunk_ms:.4f} ms per chunk, "
          f"{launches:.1f} kernel launches per chunk")
    print("phase 4 profile top device: " + "; ".join(
        f"{e.key[:50]} {e.self_device_time_total / 1e3 / chunks:.4f} ms/chunk" for e in top_dev))
    print("phase 4 profile top host: " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3 / chunks:.4f} ms/chunk" for e in top_cpu))
    return dict(
        chunks=chunks, device_ms_per_chunk=device_chunk_ms,
        unprofiled_ms_per_chunk=unprofiled_chunk_ms, device_busy_share=busy,
        launches_per_chunk=launches,
        top_device=[(e.key, e.self_device_time_total / 1e3 / chunks) for e in top_dev],
        top_host=[(e.key, e.self_cpu_time_total / 1e3 / chunks) for e in top_cpu],
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout (src/repro_torch missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.chunk_replay.ops import chunk_replay
    from repro_torch.kernels.chunk_replay.ref import chunk_replay_ref
    from repro_torch.kernels.ownership_sweep.ops import ownership_sweep
    from repro_torch.kernels.ownership_sweep.ref import sweep_ref
    from repro_torch.kvsim import (
        ClusterConfig,
        RedynisPolicy,
        StaticPolicy,
        WorkloadConfig,
        generate_trace,
        run_scenario,
        wan5_cluster,
        wan5_workload,
    )
    from repro_torch.kvsim.simulate import _initial_hosts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    record: dict = {}

    # ---- phase 1: device and build -------------------------------------
    smi = _smi()
    t0 = time.perf_counter()
    reports = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, text in reports.items():
        (out_dir / f"ptxas_{name}.log").write_text(text)
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        print(f"ptxas {name}: {' | '.join(regs)}")
    print(smi)
    print(f"phase 1 ok: {torch.cuda.get_device_name(0)}, kernels built in {build_s:.2f} s")
    record["build_s"] = build_s

    # ---- phase 2: kernels against plain versions on the card -----------
    rng = np.random.default_rng(0)

    def cuda_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    err_replay = 0.0
    cases = 0
    for topo, rtt in (("flat", ClusterConfig().rtt_matrix(dev)), ("wan5", wan5_cluster().rtt_matrix(dev))):
        n = rtt.shape[0]
        b, k = 10_007, 100_003  # neither a multiple of the 256-thread block
        hosts = rng.random((k, n)) < 0.4
        hosts[rng.random(k) < 0.1] = False  # orphan rows: worst-RTT path
        args = [cuda_t(hosts), cuda_t(rng.integers(0, k, b).astype(np.int32)),
                cuda_t(rng.integers(0, n, b).astype(np.int32)),
                cuda_t(rng.random(b) < 0.75), cuda_t(rng.random(b) < 0.9), rtt]
        extra = cuda_t(rng.uniform(0.0, 30.0, b).astype(np.float32))
        for mode in ("map", "no_local", "ideal"):
            for bins in (0, 128):
                for with_extra in (False, True):
                    kw = dict(service_ms=10.0, master=1, xfer_read_ms=2.0,
                              xfer_write_ms=3.0, read_mode=mode, num_bins=bins,
                              extra_ms=extra if with_extra else None)
                    got = chunk_replay(*args, **kw)
                    want = chunk_replay_ref(*args, **kw)
                    ctx = f"chunk_replay {topo} {mode} bins={bins} extra={with_extra}"
                    err_replay = max(err_replay, _check_replay(got, want, ctx))
                    if not with_extra:  # whole-ms latencies, sums < 2**24: exact
                        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), ctx
                    cases += 1
    # Decade-edge latencies: 1, 10, 100, 1000 ms must land in bins 1, 32, 64, 95.
    edge = [cuda_t(np.zeros((1, 5), bool)), cuda_t(np.zeros(4, np.int32)),
            cuda_t(np.arange(4, dtype=np.int32)), cuda_t(np.ones(4, bool)),
            cuda_t(np.ones(4, bool)), wan5_cluster().rtt_matrix(dev)]
    kw = dict(service_ms=0.0, master=0, xfer_read_ms=0.0, xfer_write_ms=0.0,
              read_mode="ideal", num_bins=128, lo=1.0, hi=10_000.0,
              extra_ms=cuda_t(np.asarray([1.0, 10.0, 100.0, 1000.0], np.float32)))
    hist = chunk_replay(*edge, **kw)[5].cpu()
    bins_hit = [int(hist[2 * x + 1].nonzero()[0]) for x in range(4)]
    assert bins_hit == [1, 32, 64, 95], bins_hit
    assert torch.equal(hist, chunk_replay_ref(*edge, **kw)[5].cpu())
    print(f"phase 2 chunk_replay ok: {cases} cases, max_abs_err {err_replay}, "
          f"decade-edge bins {bins_hit}")

    err_sweep = 0.0
    for k, n, h, expiry in ((1_000_003, 5, 0.2, 0), (1_000_003, 5, 0.2, 3), (65_537, 3, 1 / 3, 2)):
        counts = rng.integers(0, 4, size=(k, n)).astype(np.int32)  # f == H ties
        counts[rng.random(k) < 0.25] = 0  # zero-traffic rows keep hosts
        args = [cuda_t(counts), cuda_t(rng.random((k, n)) < 0.4),
                cuda_t(rng.random(k) < 0.9), cuda_t(rng.integers(0, 10, k).astype(np.int32))]
        got = ownership_sweep(*args, 9, h=h, expiry=expiry)
        want = sweep_ref(*args, 9, h=h, expiry=expiry)
        torch.cuda.synchronize()
        for name, g, w in zip(("owners", "add", "drop", "expired", "f"), got, want):
            assert torch.equal(g, w), (name, k, n, expiry)
        err_sweep = max(err_sweep, float((got[4] - want[4]).abs().max()))
    print(f"phase 2 ownership_sweep ok: 3 cases, max_abs_err {err_sweep}")

    # ---- phase 3: paper size, card against CPU on the same trace --------
    baselines = {
        "local": StaticPolicy("local"), "optimized": RedynisPolicy(),
        "remote": StaticPolicy("remote"), "replicated": StaticPolicy("replicated"),
    }
    record["paper"] = {}
    for skewed in (False, True):
        wl = WorkloadConfig(num_requests=100_000, num_keys=1_000, skewed=skewed)
        trace = generate_trace(wl, seed=0, device=dev)
        rows = {}
        for name, pol in baselines.items():
            a = run_scenario(wl, ClusterConfig(), pol, trace=trace)
            c = run_scenario(wl, ClusterConfig(), pol, trace=trace.cpu(), device="cpu")
            _check_result(a, c, f"phase 3 {name}")
            rows[name] = a
            print(f"phase 3 {'skewed' if skewed else 'uniform'} {name}: "
                  f"throughput {a.throughput_ops_s:.3f} ops/s, hit_rate {a.hit_rate:.4f}, "
                  f"mean {a.mean_latency_ms:.3f} ms, moves {a.replication_moves:.0f}")
        assert rows["local"].throughput_ops_s > rows["optimized"].throughput_ops_s
        assert rows["optimized"].throughput_ops_s > rows["remote"].throughput_ops_s
        assert rows["optimized"].replication_moves > 0
        record["paper"]["skewed" if skewed else "uniform"] = {
            name: r.throughput_ops_s for name, r in rows.items()
        }
    print("phase 3 ok: card matches CPU; local > optimized > remote")

    # ---- phase 4: full size on the card --------------------------------
    wl = wan5_workload(num_requests=FULL_REQUESTS, num_keys=FULL_KEYS, read_fraction=0.9)
    cl = wan5_cluster()
    trace = generate_trace(wl, seed=0, device=dev)
    policies = {"redynis": RedynisPolicy(), "remote": StaticPolicy("remote")}
    for pol in policies.values():  # warm-up run
        run_scenario(wl, cl, pol, daemon_interval=FULL_INTERVAL, trace=trace)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chunk_replay.launches = 0
    ownership_sweep.launches = 0
    full = {}
    for name, pol in policies.items():
        t0 = time.perf_counter()
        res = run_scenario(wl, cl, pol, daemon_interval=FULL_INTERVAL, trace=trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        full[name] = dict(wall_s=wall, sim_requests_per_s=FULL_REQUESTS / wall,
                          throughput_ops_s=res.throughput_ops_s, hit_rate=res.hit_rate,
                          replication_moves=res.replication_moves, result=res)
        assert np.isfinite(res.throughput_ops_s) and res.throughput_ops_s > 0
        print(f"phase 4 {name}: wall {wall:.3f} s, {FULL_REQUESTS / wall:.0f} simulated req/s, "
              f"throughput {res.throughput_ops_s:.3f} ops/s, hit_rate {res.hit_rate:.4f}, "
              f"moves {res.replication_moves:.0f}")
    launches = {"chunk_replay": chunk_replay.launches, "ownership_sweep": ownership_sweep.launches}
    chunks = -(-FULL_REQUESTS // FULL_INTERVAL)
    peak_mem = torch.cuda.max_memory_allocated()
    # The same runs through the plain versions on the card: the full-size
    # results must agree to the engine tolerances.
    with _plain_versions():
        for name, pol in policies.items():
            plain = run_scenario(wl, cl, pol, daemon_interval=FULL_INTERVAL, trace=trace)
            rel = _check_result(full[name]["result"], plain, f"phase 4 {name}")
            full[name]["plain_max_rel_diff"] = rel
            print(f"phase 4 {name}: matches the plain-version engine, max rel diff {rel}")
    for row in full.values():
        del row["result"]
    # Redynis replays chunk by chunk and sweeps every chunk (period 1); the
    # static policy replays its whole trace in one launch.
    assert launches["chunk_replay"] == chunks + 1, launches
    assert launches["ownership_sweep"] == chunks, launches
    assert full["redynis"]["hit_rate"] > full["remote"]["hit_rate"]
    print(f"phase 4 launches {launches}, max_memory_allocated {peak_mem} bytes")
    record["full"] = full
    record["full_launches"] = launches
    record["max_memory_allocated"] = peak_mem
    record["profile"] = _profile_window(
        torch, trace, wl, cl, RedynisPolicy(), run_scenario, out_dir,
        unprofiled_chunk_ms=full["redynis"]["wall_s"] * 1e3 / chunks,
    )

    # Kernel times at the full-size shapes: one chunk against the 1 M-key map,
    # the whole-trace static replay, and the 1 M-key sweep.
    n = cl.num_nodes
    rtt = cl.rtt_matrix(dev)
    hosts = _initial_hosts(trace.natural_node, FULL_KEYS, n, "offsite").contiguous()
    ck, cn, cr = (t[:FULL_INTERVAL].contiguous() for t in (trace.keys, trace.nodes, trace.is_read))
    cv = torch.ones(FULL_INTERVAL, dtype=torch.bool, device=dev)
    rkw = dict(service_ms=cl.service_ms, master=cl.master, xfer_read_ms=0.0,
               xfer_write_ms=0.0, read_mode="map")
    # One full-size chunk against the initial map and against a map of
    # several replicas per key, before it is timed.
    gen = torch.Generator(device=dev).manual_seed(0)
    multi = torch.rand((FULL_KEYS, n), device=dev, generator=gen) < 0.4
    for label, m in (("initial map", hosts), ("random map", multi)):
        err_replay = max(err_replay, _check_replay(
            chunk_replay(m, ck, cn, cr, cv, rtt, **rkw),
            chunk_replay_ref(m, ck, cn, cr, cv, rtt, **rkw), f"full-size chunk, {label}"))
    distinct = int(torch.unique(ck).numel())
    replay_bytes = FULL_INTERVAL * 10 + distinct * n + n * n * 4 + (n + 1) * 4 + 3 * 8
    chunk_ms = _device_ms(lambda: chunk_replay(hosts, ck, cn, cr, cv, rtt, **rkw), torch)
    chunk_plain = _device_ms(lambda: chunk_replay_ref(hosts, ck, cn, cr, cv, rtt, **rkw), torch, iters=20)
    allv = torch.ones(FULL_REQUESTS, dtype=torch.bool, device=dev)
    skw = dict(rkw, read_mode="no_local")
    whole_distinct = int(torch.unique(trace.keys).numel())
    whole_bytes = FULL_REQUESTS * 10 + whole_distinct * n + n * n * 4
    # The whole-trace launch is the only one whose threads loop over many
    # requests (grid-stride): check it before timing it.
    got = chunk_replay(hosts, trace.keys, trace.nodes, trace.is_read, allv, rtt, **skw)
    want = chunk_replay_ref(hosts, trace.keys, trace.nodes, trace.is_read, allv, rtt, **skw)
    err_replay = max(err_replay, _check_replay(got, want, "whole trace"))
    whole_rel = float(((got[0] - want[0]).abs() / want[0]).max())
    print(f"phase 4 chunk_replay whole trace matches plain: busy max rel err {whole_rel}, "
          f"max_abs_err {float((got[0] - want[0]).abs().max())}")
    del got, want
    whole_ms = _device_ms(lambda: chunk_replay(hosts, trace.keys, trace.nodes, trace.is_read, allv, rtt, **skw),
                          torch, reps=3, iters=5)
    whole_plain = _device_ms(lambda: chunk_replay_ref(hosts, trace.keys, trace.nodes, trace.is_read, allv, rtt, **skw),
                             torch, reps=3, iters=2)
    print(f"phase 4 chunk_replay whole trace ({FULL_REQUESTS} requests): kernel {whole_ms:.4f} ms, "
          f"plain {whole_plain:.4f} ms, bound {whole_bytes / BW_BYTES_PER_S * 1e3:.4f} ms")
    counts = torch.randint(0, 4, (FULL_KEYS, n), dtype=torch.int32, device=dev, generator=gen)
    live = torch.ones(FULL_KEYS, dtype=torch.bool, device=dev)
    last = torch.zeros(FULL_KEYS, dtype=torch.int32, device=dev)
    for g, w in zip(ownership_sweep(counts, hosts, live, last, 5, h=1 / n),
                    sweep_ref(counts, hosts, live, last, 5, h=1 / n)):
        assert torch.equal(g, w), "full-size ownership_sweep"
    sweep_ms = _device_ms(lambda: ownership_sweep(counts, hosts, live, last, 5, h=1 / n), torch)
    sweep_plain = _device_ms(lambda: sweep_ref(counts, hosts, live, last, 5, h=1 / n), torch, iters=20)
    sweep_bytes = FULL_KEYS * (n * 4 + n + 1 + 4) + FULL_KEYS * (3 * n + 1 + 4 * n)
    print(f"phase 4 chunk_replay one chunk ({FULL_INTERVAL} requests, {FULL_KEYS} keys): "
          f"kernel {chunk_ms:.4f} ms, plain {chunk_plain:.4f} ms")
    print(f"phase 4 ownership_sweep ({FULL_KEYS} keys x {n} nodes): kernel {sweep_ms:.4f} ms, "
          f"plain {sweep_plain:.4f} ms")
    record["whole_trace_replay"] = dict(ms=whole_ms, plain_ms=whole_plain,
                                        bound_ms=whole_bytes / BW_BYTES_PER_S * 1e3)

    # ---- phase 5: the kernel record ------------------------------------
    kernels = [
        dict(name="chunk_replay", route="cuda",
             source="src/repro_torch/kernels/chunk_replay/csrc/chunk_replay.cu",
             replaces="src/repro/kernels/chunk_replay/kernel.py:71",
             launches=launches["chunk_replay"], max_abs_err=err_replay,
             ms=chunk_ms, plain_ms=chunk_plain,
             bound_ms=replay_bytes / BW_BYTES_PER_S * 1e3, bound_by="bytes",
             library_ms=None),
        dict(name="ownership_sweep", route="cuda",
             source="src/repro_torch/kernels/ownership_sweep/csrc/ownership_sweep.cu",
             replaces="src/repro/kernels/ownership_sweep/kernel.py:38",
             launches=launches["ownership_sweep"], max_abs_err=err_sweep,
             ms=sweep_ms, plain_ms=sweep_plain,
             bound_ms=sweep_bytes / BW_BYTES_PER_S * 1e3, bound_by="bytes",
             library_ms=None),
    ]
    record["kernels"] = kernels
    record["card"] = smi
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
