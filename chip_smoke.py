#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from the sources in the checkout, holds each
against its plain PyTorch version on the card, drives ``run_scenario`` at
the paper's size (card against CPU, telemetry on) and at full size (100 M
requests over a 1 M-key metadata store on the card): first without
telemetry (phase 4), then with ``TelemetryConfig()`` for Redynis and static
remote and with the M/M/1 contention model for Redynis (phase 5), each
full-size run held against the same run through the plain versions on the
card. Phase 6 drives Redynis on ML state at deepseek-moe-16b widths: 150
steps of 32,768 Zipf tokens through the hot-row embedding cache and 4
full-width MoE layers, both placement daemons folded every step and swept
every 50, held every step against the same steps through the plain
versions. Phase 7 serves qwen3-1.7b at full width and all 28 layers through
``launch/serve.py``'s loop (a 16-lane ``ServeEngine`` with an 8,192-slot
cache behind a 4-pod ``SessionRouter`` whose leader fails half-way), first
on the kernel path alone with its launches counted, then with every
prefill's and every 8th decode step's attention held against the plain
versions beside a teacher-forced plain-version engine. Phase 2 also holds
``flash_attention``'s TMA/wgmma kernel through every mask at D 128 and 64,
and phase 7 checks that every prefill layer went through it. It times each
kernel (phase 8 prints the record): attention beside SDPA at every
prefill length, the sweep on int32 and f32 counts. Every phase raises on a
mismatch and prints
its duration; the script exits non-zero without a CUDA device or outside a
checkout. The last line of its output is the JSON device record.
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
F32_OPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores (NVIDIA data sheet)
FULL_REQUESTS = 100_000_000
FULL_KEYS = 1_000_000
FULL_INTERVAL = 10_000
ML_LAYERS = 4  # deepseek-moe-16b has 28; cut for the time limit shared with the other phases
ML_BATCH, ML_SEQ = 16, 2048  # 32,768 tokens per step
ML_STEPS = 150  # three sweeps at sweep_period 50
ML_NODES = 4
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
SERVE_ARCH = "qwen3-1.7b"  # full width and all 28 layers
SERVE_LANES, SERVE_CACHE = 16, 8192
SERVE_REQUESTS, SERVE_SESSIONS, SERVE_PODS = 96, 32, 4
SERVE_PROMPT = (512, 4096)  # prompt lengths, uniform, inclusive
SERVE_MAX_NEW = 64
SERVE_FAIL_POD = 3  # the first leader (the highest id), killed half-way
SERVE_CHECK_EVERY = 8  # decode steps between kernel-against-plain checks
# Kernel engine against the teacher-forced plain engine: every logit within
# LOGIT_TOL (two runs of the sound kernels read 0.0949 over 28 bf16 layers),
# and a greedy token may differ only where the plain top-2 margin is at most
# LOGIT_TOL.
LOGIT_TOL = 0.125
SERVE_PREFILL_LENS = (512, 1024, 2048, 3001, 4096)
# tests/test_kernels.py's attention shapes: (b, s, t, h, kh, dh, causal, window).
ATTN_CASES = [(2, 256, 256, 4, 2, 64, True, 0), (1, 128, 128, 8, 1, 128, True, 0),
              (2, 256, 256, 4, 4, 32, True, 64), (1, 128, 384, 4, 2, 64, False, 0),
              (1, 192, 192, 6, 2, 64, True, 0)]
DECODE_CASES = [(2, 1024, 8, 2, 64), (4, 512, 4, 1, 128), (2, 768, 16, 16, 32)]  # (b, t, h, kh, dh)
# The TMA/wgmma kernel's masks at D 128 and 64: causal S 4096 and 3001, causal
# ragged S 1000 and 130, a 256-key window at S 2048, non-causal S 128 over T
# 384; GQA groups 2, 1, 8.
TMA_CASES = [(b, s, t, h, kh, dh, causal, window) for dh in (128, 64) for b, s, t, h, kh, causal, window in (
    (1, 4096, 4096, 16, 8, True, 0), (1, 3001, 3001, 16, 8, True, 0), (1, 1000, 1000, 8, 8, True, 0),
    (2, 130, 130, 16, 2, True, 0), (1, 2048, 2048, 16, 8, True, 256), (2, 128, 384, 8, 1, False, 0))]
# Rows with no allowed key (window > 0, T + window <= S: rows from T + window - 1
# on are the mean of v), causal and not, in q tiles with and without kv tiles
# to visit; (b, s, t, h, kh, causal, window), run through every variant.
EMPTY_ROW_CASES = [(1, 256, 64, 4, 2, True, 16), (2, 192, 128, 4, 2, False, 24),
                   (1, 1000, 100, 8, 2, True, 30)]
EMPTY_ROW_VARIANTS = [("f32_simt", "float32", 64), ("mma_sync", "bfloat16", 32),
                      ("mma_sync", "bfloat16", 256), ("tma_wgmma", "bfloat16", 64),
                      ("tma_wgmma", "bfloat16", 128)]


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


def _check_trace(a, b, ctx: str, load_rtol: float = 0.0) -> float:
    """Hold two ``SimTrace``s of one trace: histograms, per-chunk P99 and
    the per-chunk counters exact; per-chunk mean latency and occupancy to
    rtol 1e-5 (f32 sums in another order); the load factor to
    ``load_rtol``. Returns the largest relative difference of the f32
    series."""
    for f in ("hist_group", "chunk_hist", "p99_latency_ms", "hit_rate", "requests",
              "moves", "drops", "evictions"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{ctx} {f}")
    rel = 0.0
    for f, rtol in (("mean_latency_ms", 1e-5), ("occupancy_bytes", 1e-5), ("load_factor", load_rtol)):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        np.testing.assert_allclose(x, y, rtol=rtol, atol=0, err_msg=f"{ctx} {f}")
        rel = max(rel, float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-30))))
    return rel


def _plain_histogram(lat, group, weight, *, rows_per_chunk=None, **kw):
    """``latency_histogram``'s plain version with the wrapper's signature."""
    from repro_torch.kernels.latency_histogram.ref import (
        latency_histogram_chunks_ref,
        latency_histogram_ref,
    )

    if rows_per_chunk is None:
        return latency_histogram_ref(lat, group, weight, **kw)
    return latency_histogram_chunks_ref(lat, group, weight, rows_per_chunk=rows_per_chunk, **kw)


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
    import repro_torch.kernels.ownership_sweep.ops as sweep_ops  # core/placement.py::sweep imports it per call
    import repro_torch.kvsim.simulate as sim_mod
    import repro_torch.kvsim.telemetry as telemetry_mod
    from repro_torch.kernels.chunk_replay.ref import chunk_replay_ref
    from repro_torch.kernels.ownership_sweep.ref import sweep_ref

    saved = sim_mod.chunk_replay, sweep_ops.ownership_sweep, telemetry_mod.latency_histogram
    sim_mod.chunk_replay, sweep_ops.ownership_sweep = chunk_replay_ref, sweep_ref
    telemetry_mod.latency_histogram = _plain_histogram
    try:
        yield
    finally:
        sim_mod.chunk_replay, sweep_ops.ownership_sweep, telemetry_mod.latency_histogram = saved


def _profile_window(torch, trace, wl, cl, policy, run_scenario, out_dir,
                    unprofiled_chunk_ms: float, label: str = "phase 4", telemetry=None,
                    chunks: int = 200) -> dict:
    """Where a full-size Redynis chunk's time goes: ``torch.profiler`` over
    the first ``chunks`` chunks of the full-size trace against the full
    1 M-key store. Prints the device time per chunk, its share of the
    unprofiled wall time per chunk, the host launches per chunk, and the
    top kernels by device time and operations by host time."""
    kw = {} if telemetry is None else dict(telemetry=telemetry)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sub_r = chunks * FULL_INTERVAL
    sub = trace._replace(keys=trace.keys[:sub_r], nodes=trace.nodes[:sub_r],
                         is_read=trace.is_read[:sub_r])
    sub_wl = wl._replace(num_requests=sub_r)
    run_scenario(sub_wl, cl, policy, daemon_interval=FULL_INTERVAL, trace=sub, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_scenario(sub_wl, cl, policy, daemon_interval=FULL_INTERVAL, trace=sub, **kw)
        torch.cuda.synchronize()
    events = prof.key_averages()
    (out_dir / f"profile_{label.replace(' ', '_')}.txt").write_text(
        events.table(sort_by="self_cpu_time_total", row_limit=40) + "\n"
        + events.table(sort_by="self_device_time_total", row_limit=25)
    )
    # Kernel, memset and copy events only: an operator's own row repeats
    # the device time of the kernels it launched.
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    device_chunk_ms = sum(e.self_device_time_total for e in dev) / 1e3 / chunks
    launches = sum(e.count for e in events if e.key.startswith("cudaLaunchKernel")) / chunks
    top_dev = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    busy = device_chunk_ms / unprofiled_chunk_ms
    print(f"{label} profile ({chunks} chunks): device {device_chunk_ms:.4f} ms per chunk, "
          f"{busy:.4f} of the unprofiled {unprofiled_chunk_ms:.4f} ms per chunk, "
          f"{launches:.1f} kernel launches per chunk")
    print(f"{label} profile top device: " + "; ".join(
        f"{e.key[:50]} {e.self_device_time_total / 1e3 / chunks:.4f} ms/chunk" for e in top_dev))
    print(f"{label} profile top host: " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3 / chunks:.4f} ms/chunk" for e in top_cpu))
    return dict(
        chunks=chunks, device_ms_per_chunk=device_chunk_ms,
        unprofiled_ms_per_chunk=unprofiled_chunk_ms, device_busy_share=busy,
        launches_per_chunk=launches,
        top_device=[(e.key, e.self_device_time_total / 1e3 / chunks) for e in top_dev],
        top_host=[(e.key, e.self_cpu_time_total / 1e3 / chunks) for e in top_cpu],
    )


def _kernels_per_call(torch, call, wrapper, calls: int = 20) -> dict:
    """Host kernel launches (``cudaLaunchKernel*``, every kernel the calls
    start), the wrapper's counted launches and the device events the
    profiler caught, per call, over ``calls`` calls after a warm one, with
    the device events' names. The host count is the check: the device
    count can miss a kernel at the edge of the window, and a window can
    receive a late record of an earlier profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    before = wrapper.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    counted = (wrapper.launches - before) / calls
    wrapper.launches = before  # measurement launches are not the path's
    events = prof.key_averages()
    device = sum(e.count for e in events if e.device_type == DeviceType.CUDA)
    host = sum(e.count for e in events if e.key.startswith("cudaLaunchKernel"))
    return dict(device_kernels=device / calls, host_launches=host / calls, counted=counted,
                device_events=sorted({e.key for e in events if e.device_type == DeviceType.CUDA}))


def _router_near_ties(got, want, probs, ctx: str):
    """Hold ``moe_router``'s ``(gates, ids, counts)`` against its plain
    version's on the same logits. A row whose ids differ must be a near tie:
    at every differing position the two picked experts' plain probabilities
    agree to 1e-6 relative (a few f32 ulps; the kernel's softmax sums in
    another order). Raises on any other difference. Returns the bool ``[T]``
    mask of near-tie rows and the largest gate difference on the other
    rows; ids there are exact and the counts of groups without a near-tie
    row are exact."""
    import torch

    gates, ids, counts = got
    wgates, wids, wcounts = want
    differ = ids != wids
    near = differ.any(dim=-1)
    if bool(near.any()):
        pa = probs.gather(-1, ids.long())
        pb = probs.gather(-1, wids.long())
        close = (pa - pb).abs() <= 1e-6 * torch.maximum(pa, pb)
        bad = (differ & ~close).any(dim=-1)
        assert not bool(bad.any()), (ctx, "router ids differ beyond a near tie", int(bad.sum()))
    keep = ~near
    assert torch.equal(ids[keep], wids[keep]), ctx
    torch.testing.assert_close(gates[keep], wgates[keep], rtol=1e-6, atol=0, msg=ctx)
    group = -(-ids.shape[0] // counts.shape[0])
    clean = torch.ones(counts.shape[0], dtype=torch.bool, device=ids.device)
    clean[torch.arange(ids.shape[0], device=ids.device)[near] // group] = False
    assert torch.equal(counts[clean], wcounts[clean]), ctx
    err = float((gates[keep] - wgates[keep]).abs().max()) if bool(keep.any()) else 0.0
    return near, err


def _plain_probs(logits):
    import torch

    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


@contextlib.contextmanager
def _ml_plain_versions():
    """Route the ML-state path (``moe_apply``, ``embed_with_cache``, the
    expert sweep) through the kernels' plain PyTorch versions on the card."""
    import repro_torch.core.expert_placement as ep_mod
    import repro_torch.core.hot_embedding as he_mod
    import repro_torch.models.moe as moe_mod
    from repro_torch.kernels.hot_gather.ref import hot_gather_ref
    from repro_torch.kernels.moe_router.ref import router_ref
    from repro_torch.kernels.ownership_sweep.ref import sweep_ref

    def plain_router(logits, *, k, group):
        return router_ref(logits, k, group)

    saved = moe_mod.moe_router, he_mod.hot_gather, ep_mod.ownership_sweep
    moe_mod.moe_router, he_mod.hot_gather, ep_mod.ownership_sweep = plain_router, hot_gather_ref, sweep_ref
    try:
        yield
    finally:
        moe_mod.moe_router, he_mod.hot_gather, ep_mod.ownership_sweep = saved


def _ml_drive(torch, dev, cfg, *, layers: int, batch: int, seq: int, steps: int,
              nodes: int = ML_NODES, seed: int = 0, log=print) -> dict:
    """The Trainer's daemon step, forward only, at ``cfg``'s widths: each
    step draws ``batch`` x ``seq`` tokens from a Zipf law (exponent 1.1) over
    the padded vocabulary, embeds them through the hot-row cache, applies
    ``layers`` MoE layers (each to the embedded batch, with its own weights
    and its layer's hot set), folds the traffic into both daemons and sweeps
    when due. The kernel run and the same steps through the plain versions
    run in lockstep on the card and are held to each other every step:
    rows, hits, daemon counts, ``hot_ids``, ``slot_map`` and ``moved``
    exact; router ids and counts exact but for near-tie rows (counted); ``y``
    to bf16 tolerance outside the groups holding a near-tie row."""
    from repro_torch.core.expert_placement import ExpertPlacement
    from repro_torch.core.hot_embedding import HotEmbedding, embed_with_cache
    from repro_torch.kernels.hot_gather.ops import hot_gather
    from repro_torch.kernels.moe_router.ops import moe_router
    from repro_torch.kernels.moe_router.ref import router_ref
    from repro_torch.kernels.ownership_sweep.ops import ownership_sweep
    from repro_torch.models.moe import moe_apply, moe_specs
    from repro_torch.models.params import ParamSpec, embed_init, init_params

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = [init_params(moe_specs(cfg), gen, dev) for _ in range(layers)]
    # Unit-scale rows stand in for the RMS-normed hidden state a real layer
    # routes (there is no attention or norm in this slice).
    table = init_params(ParamSpec((cfg.padded_vocab, cfg.d_model), embed_init(1.0)), gen, dev)
    ranks = torch.arange(1, cfg.padded_vocab + 1, device=dev, dtype=torch.float64) ** -1.1
    zipf = (ranks / ranks.sum()).to(torch.float32)
    dkw = dict(h=cfg.ownership_h or None, decay=cfg.traffic_decay, period=cfg.sweep_period)
    he = HotEmbedding(cfg.padded_vocab, nodes, cfg.hot_embed_rows, **dkw)
    ep = ExpertPlacement(layers, cfg.num_experts, nodes, cfg.hot_expert_slots, **dkw)
    tokens_n = batch * seq
    group = min(cfg.moe_group_size, tokens_n)
    while tokens_n % group:
        group -= 1
    g = tokens_n // group
    # The Trainer's data-major maps (src/repro/train/trainer.py _group_nodes/_token_nodes).
    group_nodes = (torch.arange(g, device=dev) // max(g // nodes, 1)) % nodes
    token_nodes = (torch.arange(batch, device=dev) // max(batch // nodes, 1)) % nodes

    def step_fn(hs, es, tokens):
        x, hit = embed_with_cache(table, tokens, hs)
        outs = [moe_apply(params[i], x, cfg, None, es.hot_ids[i]) for i in range(layers)]
        es = ep.fold(es, torch.stack([st["counts"] for _, st in outs]), group_nodes)
        hs = he.fold(hs, tokens, token_nodes)
        return x, hit, outs, hs, es

    hk, ek = he.init_state(dev), ep.init_state(dev)
    hp, epl = he.init_state(dev), ep.init_state(dev)
    for fn in (moe_router, hot_gather, ownership_sweep):
        fn.launches = 0
    rows_log, near_total, resyncs, y_err, gate_err, peak = [], 0, 0, 0.0, 0.0, 0
    for step in range(1, steps + 1):
        tokens = torch.multinomial(zipf, tokens_n, replacement=True, generator=gen)
        tokens = tokens.view(batch, seq).to(torch.int32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        xk, hitk, outk, hk, ek = step_fn(hk, ek, tokens)
        due = ep.due(step)
        if due:
            ek, hk = ep.sweep(ek), he.sweep(hk)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        peak = max(peak, torch.cuda.max_memory_allocated())
        with _ml_plain_versions():
            xp, hitp, outp, hp, epl = step_fn(hp, epl, tokens)
            if due:
                epl, hp = ep.sweep(epl), he.sweep(hp)
        # Rows: exact, and equal to the table's rows.
        assert torch.equal(hitk, hitp), step
        assert torch.equal(xk, xp) and torch.equal(xk, table[tokens.long()]), step
        near_step = 0
        for i in range(layers):
            (yk, sk), (yp, sp) = outk[i], outp[i]
            xg = xk.reshape(g, group, -1)
            logits = torch.einsum("gsd,de->gse", xg.float(), params[i]["router"].float())
            logits = logits.reshape(tokens_n, -1)
            saved = moe_router.launches  # a comparison launch: not the path's
            got = moe_router(logits, k=cfg.top_k, group=group)
            moe_router.launches = saved
            near, err = _router_near_ties(got, router_ref(logits, cfg.top_k, group),
                                          _plain_probs(logits), f"step {step} layer {i}")
            gate_err = max(gate_err, err)
            assert torch.equal(sk["counts"], got[2]), (step, i)
            n_near = int(near.sum())
            near_step += n_near
            clean = ~near.view(g, group).any(dim=-1)
            if n_near == 0:
                assert torch.equal(sp["counts"], sk["counts"]), (step, i)
                for key in ("dropped", "hot_frac"):
                    assert float(sk[key]) == float(sp[key]), (step, i, key)
            a = yk.reshape(g, group, -1)[clean].float()
            b = yp.reshape(g, group, -1)[clean].float()
            torch.testing.assert_close(a, b, rtol=1.6e-2, atol=2e-2, msg=f"y step {step} layer {i}")
            y_err = max(y_err, float((a - b).abs().max()))
            assert bool(torch.isfinite(yk).all()), (step, i)
        near_total += near_step
        if near_step:  # the folded counts now differ by the near-tie picks
            epl = type(ek)(*(t.clone() for t in ek))
            resyncs += 1
        assert torch.equal(ek.counts, epl.counts) and torch.equal(ek.hot_ids, epl.hot_ids), step
        assert torch.equal(ek.moved, epl.moved) and int(ek.step) == int(epl.step) == step, step
        assert torch.equal(hk.counts, hp.counts) and torch.equal(hk.slot_map, hp.slot_map), step
        assert torch.equal(hk.hot_ids, hp.hot_ids), step
        row = dict(step=step, wall_ms=wall_ms, hit_frac=float(hitk.float().mean()),
                   hot_frac=float(sum(float(st["hot_frac"]) for _, st in outk) / layers),
                   dropped=float(sum(float(st["dropped"]) for _, st in outk) / layers),
                   near_tie_rows=near_step)
        if due:
            row["moved"] = float(ek.moved)
            row["expert_hit_rate"] = float(ep.hit_rate(ek))
            row["embed_hit_rate"] = float(he.hit_rate(hk))
        rows_log.append(row)
        log(f"ml step {step}: wall {wall_ms:.2f} ms, hit {row['hit_frac']:.4f}, hot_frac "
            f"{row['hot_frac']:.4f}, dropped {row['dropped']:.4f}"
            + (f", sweep moved {row['moved']:.0f}" if due else "")
            + (f", near-tie rows {near_step}" if near_step else ""))
    launches = {"moe_router": moe_router.launches, "hot_gather": hot_gather.launches,
                "ownership_sweep": ownership_sweep.launches}

    def kernel_step():  # one more kernel-path step on fresh tokens, for the profile
        tokens = torch.multinomial(zipf, tokens_n, replacement=True, generator=gen)
        step_fn(hk, ek, tokens.view(batch, seq).to(torch.int32))

    return dict(rows=rows_log, launches=launches, kernel_step=kernel_step,
                near_tie_rows=near_total, resyncs=resyncs,
                y_max_abs_err=y_err, gate_max_abs_err=gate_err, peak_bytes=peak,
                expert_hit_rate=float(ep.hit_rate(ek)), embed_hit_rate=float(he.hit_rate(hk)),
                hot_ids=ek.hot_ids, table=table, params=params, tokens=tokens, embed_state=hk,
                group=group)


def _profile_steps(torch, step, steps: int, out_dir, label: str, unprofiled_ms: float) -> dict:
    """Where a step's device time goes: ``torch.profiler`` over ``steps``
    calls of ``step`` after one warm call. Prints device ms per step, its
    share of the unprofiled step wall time, launches per step, the share of
    matrix-product kernels and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    (out_dir / f"profile_{label.replace(' ', '_')}.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=30))
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in dev) / 1e3 / steps
    gemm = sum(e.self_device_time_total for e in dev
               if any(w in e.key.lower() for w in ("gemm", "xmma", "cutlass", "wgmma", "nvjet"))
               ) / 1e3 / steps
    launches = sum(e.count for e in events if e.key.startswith("cudaLaunchKernel")) / steps
    top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    if total == 0:
        print(f"{label} profile: the profiler recorded no device time")
        return dict(steps=steps, device_ms_per_step=None)
    print(f"{label} profile ({steps} steps): device {total:.4f} ms per step, "
          f"{total / unprofiled_ms:.4f} of the unprofiled {unprofiled_ms:.4f} ms step, "
          f"matrix products {gemm:.4f} ms ({gemm / total:.4f}), {launches:.1f} launches per step")
    print(f"{label} profile top device: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3 / steps:.4f} ms" for e in top))
    return dict(steps=steps, device_ms_per_step=total, unprofiled_ms_per_step=unprofiled_ms,
                device_busy_share=total / unprofiled_ms, matmul_ms_per_step=gemm,
                launches_per_step=launches,
                top_device=[(e.key, e.self_device_time_total / 1e3 / steps) for e in top])


def _leaves(tree):
    for val in tree.values():
        yield from (_leaves(val) if isinstance(val, dict) else (val,))


def _bf16_tol(dtype, torch) -> float:
    """tests/test_kernels.py's bars: 2e-5 for f32, 2e-2 for bf16."""
    return 2e-5 if dtype == torch.float32 else 2e-2


def _scaled_bar(want):
    """The bf16 bar scaled to the output: 2**-6 (two to four bf16 ulps) of
    each element's magnitude plus the rms of its row over head_dim. At the
    serving shapes an attention row's values are about sqrt(e / n) in size
    (0.026 at n 4096), so the flat 2e-2 bar is about one value and cannot
    see a kv tile or cache chunk that was skipped; this bar can."""
    w = want.float()
    return 2**-6 * (w.abs() + w.pow(2).mean(dim=-1, keepdim=True).sqrt())


def _check_close(torch, got, want, dtype, ctx: str) -> tuple[float, float]:
    """``got`` against ``want`` at tests/test_kernels.py's bar and, in bf16,
    at ``_scaled_bar`` too. Returns the largest absolute difference and the
    largest share of the scaled bar that a difference used (0 in f32)."""
    tol = _bf16_tol(dtype, torch)
    diff = (got.float() - want.float()).abs()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol, msg=ctx)
    use = 0.0
    if dtype != torch.float32:
        use = float((diff / _scaled_bar(want)).nan_to_num(nan=0.0, posinf=float("inf")).max())
        assert use <= 1.0, f"{ctx}: a difference uses {use:.3f} of the output-scaled bf16 bar"
    return float(diff.max()), use


@contextlib.contextmanager
def _attention_versions(attention, decode):
    """Route the model's attention (``models/transformer.py``) through the
    given functions for the duration."""
    import repro_torch.models.transformer as tfm

    saved = tfm.flash_attention, tfm.flash_decode
    tfm.flash_attention, tfm.flash_decode = attention, decode
    try:
        yield
    finally:
        tfm.flash_attention, tfm.flash_decode = saved


def _serve_engines(torch, dev, model, params):
    """A ``ServeEngine`` with its ``SessionRouter`` at the serving drive's
    sizes (the router's store on the card)."""
    from repro_torch.serving import ServeEngine, SessionRouter
    from repro_torch.serving.kvcache import state_bytes

    engine = ServeEngine(model, params, num_lanes=SERVE_LANES, cache_len=SERVE_CACHE)
    router = SessionRouter(num_pods=SERVE_PODS, max_sessions=2 * SERVE_SESSIONS, sweep_period=16,
                           session_bytes=state_bytes(engine.state) / SERVE_LANES, device=dev)
    return engine, router


def _serve_drive(torch, dev, model, params, seed: int = 0, log=print) -> dict:
    """``launch/serve.py``'s loop on the kernel path, at the serving
    drive's sizes, a pod failing half-way. Each prefill and each decode
    step is timed on the host clock; both end in a readback of the sampled
    tokens, so the card is done when the clock stops."""
    from repro_torch.launch.serve import serve_loop

    engine, router = _serve_engines(torch, dev, model, params)
    prefills, steps = [], []
    admit, step = engine.admit, engine.step

    def timed_admit(req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lane = admit(req)
        prefills.append((len(req.tokens), (time.perf_counter() - t0) * 1e3))
        return lane

    def timed_step():
        lengths = engine.state.length.clone()
        t0 = time.perf_counter()
        out = step()
        if out:
            steps.append(((time.perf_counter() - t0) * 1e3, len(out), lengths))
        return out

    engine.admit, engine.step = timed_admit, timed_step
    wall = serve_loop(engine, router, np.random.default_rng(seed), requests=SERVE_REQUESTS,
                      sessions=SERVE_SESSIONS, pods=SERVE_PODS, prompt_len=SERVE_PROMPT,
                      max_new=SERVE_MAX_NEW, vocab_size=model.cfg.vocab_size,
                      fail_pod=SERVE_FAIL_POD, log=log)
    return dict(engine=engine, router=router, wall_s=wall, prefills=prefills, steps=steps)


class _LanePair:
    """The lane tables of the two engines in lockstep: every lookup goes
    to both (their LRU clocks must see the same calls) and must agree."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def lookup(self, session):
        lane = self.a.lookup(session)
        assert self.b.lookup(session) == lane, session
        return lane


class _Lockstep:
    """The serving drive's kernel engine and a plain-version engine on the
    same params, driven in turns by ``serve_loop``. The plain engine is
    teacher-forced: each of its sampling calls hands on the kernel engine's
    tokens, so both see the same inputs. Every sampling call compares the
    two engines' logits, which must agree within ``LOGIT_TOL``; a greedy
    token may differ only at a near tie, where the plain logits' top-2
    margin is at most ``LOGIT_TOL``. The kernel engine's attention is held
    against the plain version on the same inputs in every layer of every
    prefill and of every ``SERVE_CHECK_EVERY``-th decode step."""

    def __init__(self, torch, eng, plain):
        from repro_torch.kernels.flash_attention.ops import flash_attention
        from repro_torch.kernels.flash_attention.ref import flash_attention_ref
        from repro_torch.kernels.flash_decode.ops import flash_decode
        from repro_torch.kernels.flash_decode.ref import flash_decode_ref

        self.torch, self.eng, self.plain = torch, eng, plain
        self.lanes = _LanePair(eng.lanes, plain.lanes)
        self.device = eng.device
        self.stats = dict(attn_checks=0, attn_err=0.0, attn_bar_use=0.0, decode_checks=0,
                          decode_err=0.0, decode_bar_use=0.0, samples=0, tokens=0, near_ties=0,
                          widest_tie=0.0, logit_err=0.0, check_decode=False)
        self._refs = flash_attention_ref, flash_decode_ref
        stats = self.stats

        def checked_attention(q, k, v, *, causal=True, window=0):
            out = flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention_ref(q, k, v, causal=causal, window=window)
            err, use = _check_close(torch, out, want, q.dtype, f"prefill attention S={q.shape[1]}")
            stats["attn_checks"] += 1
            stats["attn_err"] = max(stats["attn_err"], err)
            stats["attn_bar_use"] = max(stats["attn_bar_use"], use)
            return out

        def checked_decode(q, k_cache, v_cache, lengths):
            out = flash_decode(q, k_cache, v_cache, lengths)
            if stats["check_decode"]:
                want = flash_decode_ref(q, k_cache, v_cache, lengths)
                err, use = _check_close(torch, out, want, q.dtype, "decode attention")
                stats["decode_checks"] += 1
                stats["decode_err"] = max(stats["decode_err"], err)
                stats["decode_bar_use"] = max(stats["decode_bar_use"], use)
            return out

        self._checked = checked_attention, checked_decode
        kernel_sample, plain_sample = eng._sample, plain._sample
        pending = []

        def record(logits):
            tokens = kernel_sample(logits)
            pending.append((logits, tokens))
            return tokens

        def forced(logits):
            klogits, ktokens = pending.pop()
            ptokens = plain_sample(logits)
            diff = float((klogits - logits).abs().max())
            top2 = torch.topk(logits, 2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            differ = ptokens != ktokens
            assert bool(torch.isfinite(klogits).all())
            assert diff <= LOGIT_TOL, f"logits differ by {diff}, beyond {LOGIT_TOL}"
            widest = float(margin[differ].max()) if bool(differ.any()) else 0.0
            assert widest <= LOGIT_TOL, f"a greedy token differs at a top-2 margin of {widest}"
            stats["samples"] += 1
            stats["tokens"] += int(ktokens.numel())
            stats["near_ties"] += int(differ.sum())
            stats["widest_tie"] = max(stats["widest_tie"], widest)
            stats["logit_err"] = max(stats["logit_err"], diff)
            return ktokens

        eng._sample, plain._sample = record, forced

    def admit(self, req):
        with _attention_versions(*self._checked):
            lane = self.eng.admit(req)
        with _attention_versions(*self._refs):
            assert self.plain.admit(req) == lane
        return lane

    def step(self):
        self.stats["check_decode"] = self.eng.steps % SERVE_CHECK_EVERY == 0
        with _attention_versions(*self._checked):
            out = self.eng.step()
        with _attention_versions(*self._refs):
            assert self.plain.step() == out
        return out

    def run_to_completion(self):
        while self.step():
            pass
        return dict(self.eng.outputs)

    @property
    def tokens_out(self) -> int:
        return self.eng.tokens_out


def _attention_flops_bytes(b, s, t, h, kh, dh, causal, window, elem=2):
    """Operations and bytes of one attention call at its mask: 4 flops per
    (q, k) pair and head element (QK^T and PV), each input read once and
    the output written once."""
    q = np.arange(s)[:, None]
    k = np.arange(t)[None, :]
    ok = np.ones((s, t), bool)
    if causal:
        ok &= q >= k
    if window:
        ok &= (q - k) < window
    pairs = int(ok.sum())
    return 4 * b * h * dh * pairs, elem * (2 * b * s * h * dh + 2 * b * t * kh * dh)


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
    from repro_torch.configs import get_config
    from repro_torch.kernels.chunk_replay.ref import chunk_replay_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.hot_gather.ops import hot_gather
    from repro_torch.kernels.hot_gather.ref import hot_gather_ref
    from repro_torch.kernels.latency_histogram.ops import latency_histogram
    from repro_torch.kernels.moe_router.ops import moe_router
    from repro_torch.kernels.moe_router.ref import router_ref
    from repro_torch.kernels.latency_histogram.ref import bin_index
    from repro_torch.kernels.ownership_sweep.ops import ownership_sweep
    from repro_torch.kernels.ownership_sweep.ref import sweep_ref
    from repro_torch.kvsim import (
        ClusterConfig,
        RedynisPolicy,
        ServiceConfig,
        StaticPolicy,
        TelemetryConfig,
        WorkloadConfig,
        generate_trace,
        run_scenario,
        wan5_cluster,
        wan5_workload,
    )
    from repro_torch.kvsim.simulate import _initial_hosts
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    record: dict = {"phase_s": {}}
    mark = [time.perf_counter(), time.perf_counter()]  # script start, last phase start

    def lap(phase: str) -> None:
        now = time.perf_counter()
        record["phase_s"][phase] = now - mark[1]
        print(f"{phase} took {now - mark[1]:.1f} s ({now - mark[0]:.1f} s since the start)")
        mark[1] = now

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

    lap("phase 1")

    # ---- phase 2: kernels against plain versions on the card -----------
    rng = np.random.default_rng(0)

    def cuda_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    err_replay = 0.0
    cases = 0
    for topo, rtt in (("flat", ClusterConfig().rtt_matrix(dev)), ("wan5", wan5_cluster().rtt_matrix(dev))):
        n = rtt.shape[0]
        b, k = 10_007, 100_003  # neither a multiple of four requests nor of a block's
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
                    # The per-request outputs, where passed, must be equal.
                    outs = [(torch.empty(b, device=dev), torch.empty(b, dtype=torch.bool, device=dev))
                            for _ in range(2)] if with_extra else [(None, None)] * 2
                    got = chunk_replay(*args, **kw, lat_out=outs[0][0], hit_out=outs[0][1])
                    want = chunk_replay_ref(*args, **kw, lat_out=outs[1][0], hit_out=outs[1][1])
                    ctx = f"chunk_replay {topo} {mode} bins={bins} extra={with_extra}"
                    err_replay = max(err_replay, _check_replay(got, want, ctx))
                    again = chunk_replay(*args, **kw)  # the same inputs: the same bits
                    assert all(x is None and y is None or torch.equal(x, y)
                               for x, y in zip(got, again)), ctx
                    if not with_extra:  # whole-ms latencies, sums < 2**24: exact
                        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), ctx
                    else:
                        assert torch.equal(outs[0][0], outs[1][0]), ctx
                        assert torch.equal(outs[0][1], outs[1][1]), ctx
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

    # latency_histogram: log-uniform latencies over [0.1, 1e5] ms with the
    # decade edges first, G up to 128, flat and per-chunk forms (a short
    # last chunk), 0/1 weights exact and real weights to rtol 1e-5.
    err_hist = 0.0
    hcases = 0
    for g in (6, 10, 128):
        r = 1_000_003
        lat = np.exp(rng.uniform(np.log(0.1), np.log(1e5), r)).astype(np.float32)
        lat[:4] = [1.0, 10.0, 100.0, 1000.0]
        hargs = [cuda_t(lat), cuda_t(rng.integers(0, g, r).astype(np.int32)),
                 cuda_t((rng.random(r) < 0.8).astype(np.float32))]
        hkw = dict(num_groups=g, num_bins=128, lo=1.0, hi=10_000.0)
        for rpc in (None, 10_000, 997):
            got = latency_histogram(*hargs, rows_per_chunk=rpc, **hkw)
            want = _plain_histogram(*hargs, rows_per_chunk=rpc, **hkw)
            assert torch.equal(got, want), (g, rpc)
            hcases += 1
        real = torch.rand(r, device=dev, generator=torch.Generator(device=dev).manual_seed(g))
        got = latency_histogram(hargs[0], hargs[1], real, **hkw)
        want = _plain_histogram(hargs[0], hargs[1], real, **hkw)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
        err_hist = max(err_hist, float((got - want).abs().max()))
        hcases += 1
    one = torch.ones(4, dtype=torch.int32, device=dev)
    edge_hist = latency_histogram(cuda_t(np.asarray([1.0, 10.0, 100.0, 1000.0], np.float32)), one,
                                  torch.ones(4, device=dev), num_groups=2, num_bins=128)
    edge_bins = edge_hist[1].nonzero().flatten().tolist()
    assert edge_bins == [1, 32, 64, 95], edge_bins
    print(f"phase 2 latency_histogram ok: {hcases} cases, max_abs_err {err_hist} "
          f"(real weights; 0/1 weights exact), decade-edge bins {edge_bins}")

    # hot_gather: the reference kernel test's shapes (tests/test_kernels.py),
    # a row of 6 bytes (2-byte copy units), both table dtypes, and the
    # deepseek-moe-16b shape (102,400-row vocabulary, 2048 hot rows of
    # 2048 bf16, 32,768 tokens). Copies: exact.
    gcases = 0
    for v, r, d, t in ((5_000, 64, 256, 333), (1_024, 8, 64, 128), (300, 5, 3, 77),
                       (102_400, 2_048, 2_048, 32_768)):
        for dtype in ((torch.float32, torch.bfloat16) if t != 32_768 else (torch.bfloat16,)):
            slot_map = np.full(v, -1, np.int32)
            slot_map[rng.choice(v, r, replace=False)] = np.arange(r, dtype=np.int32)
            gargs = (cuda_t(rng.integers(0, v, t).astype(np.int32)), cuda_t(slot_map),
                     cuda_t(rng.standard_normal((r, d)).astype(np.float32)).to(dtype))
            got, want = hot_gather(*gargs), hot_gather_ref(*gargs)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (v, r, d, t, dtype)
            gcases += 1
    err_gather = 0.0  # copies, asserted exact above and in phase 6
    print(f"phase 2 hot_gather ok: {gcases} cases, rows and hit flags exact")

    # moe_router: the reference kernel test's shapes (E 64 / k 6, E 32 / k 8,
    # E 8 / k 2; a short last group), the deepseek-moe-16b shape, the 8-lane
    # rows (E 128 and 256) and groups shorter than a block's rows.
    err_router, rcases, near_p2 = 0.0, 0, 0
    for t, e, k, grp in ((512, 64, 6, 128), (300, 32, 8, 128), (1_024, 8, 2, 256), (32_768, 64, 6, 512),
                         (1_000, 128, 8, 300), (4_099, 256, 6, 512), (777, 64, 6, 7)):
        logits = cuda_t(rng.standard_normal((t, e)).astype(np.float32))
        near, err = _router_near_ties(moe_router(logits, k=k, group=grp), router_ref(logits, k, grp),
                                      _plain_probs(logits), f"moe_router {t}x{e} k={k}")
        err_router = max(err_router, err)
        near_p2 += int(near.sum())
        rcases += 1
    print(f"phase 2 moe_router ok: {rcases} cases, ids and counts exact but {near_p2} near-tie rows, "
          f"gates max_abs_err {err_router}")

    # ownership_sweep on f32 EMA traffic, the expert daemon's shape
    # (4 layers x 64 experts, 4 ranks) and a larger one: owners exact.
    for k, n in ((ML_LAYERS * 64, ML_NODES), (100_003, 4)):
        traffic = (rng.integers(0, 50, (k, n)) * 0.98 ** 3).astype(np.float32)
        traffic[rng.random(k) < 0.2] = 0
        sargs = [cuda_t(traffic), cuda_t(np.zeros((k, n), bool)), cuda_t(np.ones(k, bool)),
                 cuda_t(np.zeros(k, np.int32))]
        got, want = ownership_sweep(*sargs, 0, h=1 / n), sweep_ref(*sargs, 0, h=1 / n)
        for name, g_, w_ in zip(("owners", "add", "drop", "expired"), got, want):
            assert torch.equal(g_, w_), (name, k, n)
        torch.testing.assert_close(got[4], want[4], rtol=1e-6, atol=0)
        err_sweep = max(err_sweep, float((got[4] - want[4]).abs().max()))
    print(f"phase 2 ownership_sweep f32 traffic ok: owners exact, f max_abs_err {err_sweep}")

    # flash_attention: the reference kernel test's shapes in both dtypes,
    # then qwen3-1.7b prefills (16 q and 8 kv heads of 128) at S 4096 and
    # a ragged S, in bf16.
    err_attn = {torch.float32: 0.0, torch.bfloat16: 0.0}
    use_attn = 0.0
    acases = 0
    for case in ATTN_CASES + [(1, 4096, 4096, 16, 8, 128, True, 0), (1, 3001, 3001, 16, 8, 128, True, 0)]:
        b, s_, t, h, kh, dh, causal, window = case
        for dtype in ((torch.float32, torch.bfloat16) if s_ < 1000 else (torch.bfloat16,)):
            q, k, v = (cuda_t(rng.standard_normal(sh).astype(np.float32)).to(dtype)
                       for sh in ((b, s_, h, dh), (b, t, kh, dh), (b, t, kh, dh)))
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err, use = _check_close(torch, got, want, dtype, f"flash_attention {case} {dtype}")
            err_attn[dtype], use_attn = max(err_attn[dtype], err), max(use_attn, use)
            acases += 1
    print(f"phase 2 flash_attention ok: {acases} cases, max_abs_err f32 {err_attn[torch.float32]}, "
          f"bf16 {err_attn[torch.bfloat16]} (scaled bar used {use_attn:.4f})")
    # The TMA/wgmma kernel through every mask at D 128 and 64, each case
    # through both of its q tiles (the one the shape picks, then the other),
    # held to the flat bar and to half of the scaled bar.
    use_tma, tcases = 0.0, 0
    for case in TMA_CASES:
        b, s_, t, h, kh, dh, causal, window = case
        q, k, v = (cuda_t(rng.standard_normal(sh).astype(np.float32)).to(torch.bfloat16)
                   for sh in ((b, s_, h, dh), (b, t, kh, dh), (b, t, kh, dh)))
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        rows = fa_ops.q_rows(s_, h, b)
        for got, tile in ((flash_attention(q, k, v, causal=causal, window=window), rows),
                          (fa_ops._launch(q, k, v, causal, window, "tma_wgmma", 192 - rows), 192 - rows)):
            torch.cuda.synchronize()
            ctx = f"flash_attention tma {case} q rows {tile}"
            err, use = _check_close(torch, got, want, torch.bfloat16, ctx)
            assert use <= 0.5, f"{ctx}: {use:.3f} of the scaled bar"
            err_attn[torch.bfloat16], use_tma = max(err_attn[torch.bfloat16], err), max(use_tma, use)
            tcases += 1
    print(f"phase 2 flash_attention tma_wgmma ok: {tcases} cases (D 128 and 64, both q tiles), "
          f"max_abs_err {err_attn[torch.bfloat16]}, scaled bar used {use_tma:.4f} (bar 0.5)")
    # Rows that see no key, through every variant (the TMA one through both q
    # tiles): the plain version's bars, and the rows equal to the mean of v.
    ecases = 0
    for b, s_, t, h, kh, causal, window in EMPTY_ROW_CASES:
        for kind, dname, dh in EMPTY_ROW_VARIANTS:
            dtype = getattr(torch, dname)
            assert fa_ops.variant(dtype, dh) == kind and fa_ops.has_empty_rows(s_, t, window)
            q, k, v = (cuda_t(rng.standard_normal(sh).astype(np.float32)).to(dtype)
                       for sh in ((b, s_, h, dh), (b, t, kh, dh), (b, t, kh, dh)))
            want = flash_attention_ref(q, k, v, causal=causal, window=window)
            first = t + window - 1
            mean_v = v.float().mean(dim=1).repeat_interleave(h // kh, dim=1)[:, None]
            for rows in ((64, 128) if kind == "tma_wgmma" else (None,)):
                got = fa_ops._launch(q, k, v, causal, window, kind, rows)
                torch.cuda.synchronize()
                ctx = f"flash_attention empty rows {kind} {(b, s_, t, h, kh, dh, causal, window)} q rows {rows}"
                err, use = _check_close(torch, got, want, dtype, ctx)
                _check_close(torch, got[:, first:], mean_v.expand(b, s_ - first, h, dh), dtype, ctx + " mean")
                assert kind != "tma_wgmma" or use <= 0.5, f"{ctx}: {use:.3f} of the scaled bar"
                err_attn[dtype] = max(err_attn[dtype], err)
                ecases += 1
    print(f"phase 2 flash_attention rows without keys ok: {ecases} cases (all three variants), "
          f"each such row the mean of v; max_abs_err f32 {err_attn[torch.float32]}, "
          f"bf16 {err_attn[torch.bfloat16]}")

    # flash_decode: the reference kernel test's shapes in both dtypes, then
    # the serving shape (16 lanes, an 8,192-slot cache), lengths random
    # with 1 and one past T in every case, and 0 (every position masked:
    # the mean of v) where there are three sequences or more.
    err_dec = {torch.float32: 0.0, torch.bfloat16: 0.0}
    use_dec = 0.0
    dcases = 0
    for case in DECODE_CASES + [(16, SERVE_CACHE, 16, 8, 128)]:
        b, t, h, kh, dh = case
        for dtype in ((torch.float32, torch.bfloat16) if t < SERVE_CACHE else (torch.bfloat16,)):
            q, k, v = (cuda_t(rng.standard_normal(sh).astype(np.float32)).to(dtype)
                       for sh in ((b, h, dh), (b, t, kh, dh), (b, t, kh, dh)))
            lengths = rng.integers(1, t, b).astype(np.int32)
            lengths[0], lengths[-1] = 1, t + 7
            if b > 2:
                lengths[1] = 0
            lengths = cuda_t(lengths)
            got, want = flash_decode(q, k, v, lengths), flash_decode_ref(q, k, v, lengths)
            torch.cuda.synchronize()
            err, use = _check_close(torch, got, want, dtype, f"flash_decode {case} {dtype}")
            err_dec[dtype], use_dec = max(err_dec[dtype], err), max(use_dec, use)
            dcases += 1
    print(f"phase 2 flash_decode ok: {dcases} cases, max_abs_err f32 {err_dec[torch.float32]}, "
          f"bf16 {err_dec[torch.bfloat16]} (scaled bar used {use_dec:.4f})")
    record["phase2_scaled_bar_used"] = dict(flash_attention=use_attn, flash_attention_tma=use_tma,
                                            flash_decode=use_dec)

    lap("phase 2")

    # ---- phase 3: paper size, card against CPU on the same trace --------
    baselines = {
        "local": StaticPolicy("local"), "optimized": RedynisPolicy(),
        "remote": StaticPolicy("remote"), "replicated": StaticPolicy("replicated"),
    }
    tcfg = TelemetryConfig()
    record["paper"] = {}
    for skewed in (False, True):
        wl = WorkloadConfig(num_requests=100_000, num_keys=1_000, skewed=skewed)
        trace = generate_trace(wl, seed=0, device=dev)
        rows = {}
        for name, pol in baselines.items():
            a, ta = run_scenario(wl, ClusterConfig(), pol, trace=trace, telemetry=tcfg)
            c, tc = run_scenario(wl, ClusterConfig(), pol, trace=trace.cpu(), device="cpu",
                                 telemetry=tcfg)
            _check_result(a, c, f"phase 3 {name}")
            _check_trace(ta, tc, f"phase 3 {name}")
            rows[name] = a
            p = ta.tail_summary()
            print(f"phase 3 {'skewed' if skewed else 'uniform'} {name}: "
                  f"throughput {a.throughput_ops_s:.3f} ops/s, hit_rate {a.hit_rate:.4f}, "
                  f"mean {a.mean_latency_ms:.3f} ms, p50 {p['p50']:.3f} ms, "
                  f"p99 {p['p99']:.3f} ms, moves {a.replication_moves:.0f}")
        assert rows["local"].throughput_ops_s > rows["optimized"].throughput_ops_s
        assert rows["optimized"].throughput_ops_s > rows["remote"].throughput_ops_s
        assert rows["optimized"].replication_moves > 0
        record["paper"]["skewed" if skewed else "uniform"] = {
            name: r.throughput_ops_s for name, r in rows.items()
        }
    print("phase 3 ok: card matches CPU (histograms exact); local > optimized > remote")

    lap("phase 3")

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
    latency_histogram.launches = 0
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
    launches = {"chunk_replay": chunk_replay.launches, "ownership_sweep": ownership_sweep.launches,
                "latency_histogram": latency_histogram.launches}
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
    assert launches["latency_histogram"] == 0, launches  # telemetry is off here
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
    whole_bound = whole_bytes / BW_BYTES_PER_S * 1e3
    print(f"phase 4 chunk_replay whole trace ({FULL_REQUESTS} requests): kernel {whole_ms:.4f} ms, "
          f"plain {whole_plain:.4f} ms, bound {whole_bound:.4f} ms, "
          f"{whole_bound / whole_ms:.4f} of the bytes bound")
    # The 1 M-key sweep on int32 access counts (the key-value engine's) and on
    # f32 EMA traffic (the ML-state daemons'), every output exact.
    live = torch.ones(FULL_KEYS, dtype=torch.bool, device=dev)
    last = torch.zeros(FULL_KEYS, dtype=torch.int32, device=dev)
    traffic = torch.randint(0, 50, (FULL_KEYS, n), device=dev, generator=gen).float() * 0.98**3
    traffic[torch.rand(FULL_KEYS, device=dev, generator=gen) < 0.2] = 0
    sweep_inputs = {"int32": torch.randint(0, 4, (FULL_KEYS, n), dtype=torch.int32, device=dev, generator=gen),
                    "f32": traffic}
    sweep_bytes = FULL_KEYS * (n * 4 + n + 1 + 4) + FULL_KEYS * (3 * n + 1 + 4 * n)
    sweep_runs = {}
    for label, counts in sweep_inputs.items():
        for name, g, w in zip(("owners", "add", "drop", "expired", "f"),
                              ownership_sweep(counts, hosts, live, last, 5, h=1 / n),
                              sweep_ref(counts, hosts, live, last, 5, h=1 / n)):
            assert torch.equal(g, w), f"full-size ownership_sweep ({label} counts): {name}"
        ms = _device_ms(lambda: ownership_sweep(counts, hosts, live, last, 5, h=1 / n), torch)
        plain = _device_ms(lambda: sweep_ref(counts, hosts, live, last, 5, h=1 / n), torch, iters=20)
        bound = sweep_bytes / BW_BYTES_PER_S * 1e3
        sweep_runs[label] = dict(ms=ms, plain_ms=plain, bound_ms=bound, gbs=sweep_bytes / ms / 1e6,
                                 share_of_bound=bound / ms)
        print(f"phase 4 ownership_sweep ({FULL_KEYS} keys x {n} nodes, {label} counts): kernel {ms:.4f} ms "
              f"({sweep_bytes / ms / 1e6:.1f} GB/s, {bound / ms:.3f} of the bytes bound {bound:.4f} ms), "
              f"plain {plain:.4f} ms; all five outputs exact")
    sweep_ms, sweep_plain = sweep_runs["int32"]["ms"], sweep_runs["int32"]["plain_ms"]
    record["sweep"] = sweep_runs
    # Device kernels and host launches a chunk_replay call makes, by the
    # profiler over calls at the chunk shape (histogram on, as on the
    # telemetry path, and off); and the launch counter over the same calls.
    replay_calls = {}
    for bins in (0, tcfg.num_bins):
        replay_calls[bins] = _kernels_per_call(
            torch, lambda: chunk_replay(hosts, ck, cn, cr, cv, rtt, num_bins=bins, **rkw), chunk_replay)
    chunk_bound = replay_bytes / BW_BYTES_PER_S * 1e3
    print(f"phase 4 chunk_replay one chunk ({FULL_INTERVAL} requests, {FULL_KEYS} keys): "
          f"kernel {chunk_ms:.4f} ms, plain {chunk_plain:.4f} ms, bound {chunk_bound:.7f} ms, "
          f"{chunk_bound / chunk_ms:.4f} of the bytes bound; per call (histogram off / on): "
          + " / ".join(f"{c['host_launches']:.1f} kernel launches ({c['counted']:.1f} counted), "
                       f"{c['device_kernels']:.2f} device events caught, {c['device_events']}"
                       for c in replay_calls.values()))
    for c in replay_calls.values():  # one kernel launch a call, and no other
        assert c["host_launches"] == c["counted"] == 1, replay_calls
    record["whole_trace_replay"] = dict(ms=whole_ms, plain_ms=whole_plain, bound_ms=whole_bound,
                                        share_of_bound=whole_bound / whole_ms)
    record["chunk_replay_chunk"] = dict(ms=chunk_ms, plain_ms=chunk_plain, bound_ms=chunk_bound,
                                        share_of_bound=chunk_bound / chunk_ms,
                                        per_call={str(k): v for k, v in replay_calls.items()})

    lap("phase 4")

    # ---- phase 5: full size with telemetry and contention ---------------
    # Redynis and static remote with TelemetryConfig() on phase 4's trace,
    # and Redynis on the tail-latency contention shape (balanced regions,
    # affinity 0.8, reads only, lognormal sizes sigma 1, 128 bytes/ms,
    # capacity factor 1.0) on a trace of its own.
    wl_c = wan5_workload(num_requests=FULL_REQUESTS, num_keys=FULL_KEYS, read_fraction=1.0,
                         region_weights=(0.2,) * 5, affinity=0.8, object_bytes_sigma=1.0)
    cl_c = wan5_cluster(service=ServiceConfig(serve_bytes_per_ms=128.0, capacity_factor=1.0))
    trace_c = generate_trace(wl_c, seed=0, device=dev)
    runs = {
        "redynis": (wl, cl, trace, RedynisPolicy()),
        "remote": (wl, cl, trace, StaticPolicy("remote")),
        "redynis_contention": (wl_c, cl_c, trace_c, RedynisPolicy()),
    }

    def head(t, w, chunks_):  # the first chunks of a trace, for the warm-up
        sub_r = chunks_ * FULL_INTERVAL
        return (t._replace(keys=t.keys[:sub_r], nodes=t.nodes[:sub_r], is_read=t.is_read[:sub_r]),
                w._replace(num_requests=sub_r))

    for w, c, t, pol in runs.values():
        sub, sub_wl = head(t, w, 50)
        run_scenario(sub_wl, c, pol, daemon_interval=FULL_INTERVAL, trace=sub, telemetry=tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chunk_replay.launches = 0
    ownership_sweep.launches = 0
    latency_histogram.launches = 0
    tele = {}
    for name, (w, c, t, pol) in runs.items():
        t0 = time.perf_counter()
        res, tr = run_scenario(w, c, pol, daemon_interval=FULL_INTERVAL, trace=t, telemetry=tcfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tail = tr.tail_summary()
        assert np.isfinite(res.throughput_ops_s) and tr.hist.sum() == FULL_REQUESTS, name
        assert tr.chunk_hist.shape == (chunks, 128) and np.isfinite(tr.p99_latency_ms).all(), name
        tele[name] = dict(wall_s=wall, sim_requests_per_s=FULL_REQUESTS / wall,
                          throughput_ops_s=res.throughput_ops_s, hit_rate=res.hit_rate,
                          mean_latency_ms=res.mean_latency_ms, quantiles=tail,
                          convergence_chunk=tr.convergence_chunk(),
                          post_convergence_moves=tr.post_convergence_moves(),
                          max_load_factor=float(tr.load_factor.max()), result=res, trace=tr)
        print(f"phase 5 {name}: wall {wall:.3f} s, {FULL_REQUESTS / wall:.0f} simulated req/s, "
              f"throughput {res.throughput_ops_s:.3f} ops/s, mean {res.mean_latency_ms:.3f} ms, "
              f"p50 {tail['p50']:.3f} ms, p99 {tail['p99']:.3f} ms, p99.9 {tail['p999']:.3f} ms, "
              f"max rho {float(tr.load_factor.max()):.4f}")
    tele_launches = {"chunk_replay": chunk_replay.launches,
                     "ownership_sweep": ownership_sweep.launches,
                     "latency_histogram": latency_histogram.launches}
    tele_mem = torch.cuda.max_memory_allocated()
    # Two Redynis runs replay chunk by chunk with the fused histogram and
    # sweep every chunk; the static run is one whole-trace replay and one
    # per-chunk histogram launch.
    assert tele_launches == {"chunk_replay": 2 * chunks + 1, "ownership_sweep": 2 * chunks,
                             "latency_histogram": 1}, tele_launches
    assert tele["redynis_contention"]["max_load_factor"] > 0
    # Telemetry's cost on the Redynis run, in turns within this call: phase
    # 4's run (off) and the run above (on), then off, on, off, on. The loop
    # is host-bound and the host is shared, so single runs spread widely.
    turns = {"off": [full["redynis"]["wall_s"]], "on": [tele["redynis"]["wall_s"]]}
    for key in ("off", "on", "off", "on"):
        t0 = time.perf_counter()
        run_scenario(wl, cl, RedynisPolicy(), daemon_interval=FULL_INTERVAL, trace=trace,
                     telemetry=tcfg if key == "on" else None)
        torch.cuda.synchronize()
        turns[key].append(time.perf_counter() - t0)
    print(f"phase 5 Redynis wall s in turns: telemetry off {turns['off']}, on {turns['on']}")
    record["telemetry_turns_s"] = turns
    for label, name in (("phase 5 telemetry", "redynis"), ("phase 5 contention", "redynis_contention")):
        w, c, t, pol = runs[name]
        record[label.replace(" ", "_")] = _profile_window(
            torch, t, w, c, pol, run_scenario, out_dir,
            unprofiled_chunk_ms=tele[name]["wall_s"] * 1e3 / chunks, label=label, telemetry=tcfg,
        )
    with _plain_versions():
        for name, (w, c, t, pol) in runs.items():
            plain, ptr = run_scenario(w, c, pol, daemon_interval=FULL_INTERVAL, trace=t, telemetry=tcfg)
            rel = max(_check_result(tele[name]["result"], plain, f"phase 5 {name}"),
                      _check_trace(tele[name]["trace"], ptr, f"phase 5 {name}"))
            tele[name]["plain_max_rel_diff"] = rel
            print(f"phase 5 {name}: matches the plain-version engine (histograms exact), "
                  f"max rel diff {rel}")
    for row in tele.values():
        del row["result"], row["trace"]
    slowdown = float(np.median(turns["on"]) / np.median(turns["off"]))
    print(f"phase 5 launches {tele_launches}, max_memory_allocated {tele_mem} bytes; Redynis with "
          f"telemetry takes {slowdown:.4f}x the wall time without (medians of three turns)")
    record["telemetry"] = tele
    record["telemetry_launches"] = tele_launches
    record["telemetry_max_memory_allocated"] = tele_mem
    del trace_c

    # latency_histogram at the static path's full-size shape: the whole
    # trace's 100 M latencies into [C, 2N, B] per-chunk histograms.
    g, nb = 2 * n, tcfg.num_bins
    lat = torch.empty(FULL_REQUESTS, device=dev)
    chunk_replay(hosts, trace.keys, trace.nodes, trace.is_read, allv, rtt, lat_out=lat, **skw)
    group = (trace.nodes * 2 + trace.is_read.to(torch.int32)).to(torch.int32)
    weight = torch.ones(FULL_REQUESTS, device=dev)
    hkw = dict(num_groups=g, num_bins=nb, lo=tcfg.lo_ms, hi=tcfg.hi_ms, rows_per_chunk=FULL_INTERVAL)
    got = latency_histogram(lat, group, weight, **hkw)
    want = _plain_histogram(lat, group, weight, **hkw)
    assert torch.equal(got, want), "full-size latency_histogram"
    del got, want
    hist_ms = _device_ms(lambda: latency_histogram(lat, group, weight, **hkw), torch, reps=3, iters=5)
    hist_plain = _device_ms(lambda: _plain_histogram(lat, group, weight, **hkw), torch, reps=3, iters=2)
    # The fold alone, as one PyTorch call over a precomputed flat index: a
    # floor for the grouped fold, not the same function (no bucketize).
    flat = ((torch.arange(FULL_REQUESTS, device=dev) // FULL_INTERVAL) * g + group) * nb \
        + bin_index(lat, tcfg.lo_ms, tcfg.hi_ms, nb).long()
    fold_ms = _device_ms(lambda: torch.bincount(flat, weights=weight, minlength=chunks * g * nb),
                         torch, reps=3, iters=5)
    del flat
    hist_bytes = FULL_REQUESTS * 12 + chunks * g * nb * 4
    print(f"phase 5 latency_histogram ({FULL_REQUESTS} requests -> [{chunks}, {g}, {nb}]): "
          f"kernel {hist_ms:.4f} ms, plain {hist_plain:.4f} ms, "
          f"bound {hist_bytes / BW_BYTES_PER_S * 1e3:.4f} ms, bincount fold floor {fold_ms:.4f} ms")
    record["latency_histogram_full"] = dict(ms=hist_ms, plain_ms=hist_plain, bincount_fold_ms=fold_ms,
                                            bound_ms=hist_bytes / BW_BYTES_PER_S * 1e3)

    del trace, lat, group, weight, allv, hosts, multi, counts, live, last
    torch.cuda.empty_cache()

    lap("phase 5")

    # ---- phase 6: Redynis on ML state at deepseek-moe-16b widths ---------
    # The Trainer's daemon step, forward only: hot-row embedding cache
    # (hot_gather), ML_LAYERS MoE layers at full width (moe_router), both
    # daemons folded every step and swept every 50 (ownership_sweep on f32
    # traffic), held every step against the same steps through the plain
    # versions on the card.
    cfg = get_config("deepseek-moe-16b")
    for fn in (chunk_replay, ownership_sweep, latency_histogram):
        fn.launches = 0
    t0 = time.perf_counter()
    ml = _ml_drive(torch, dev, cfg, layers=ML_LAYERS, batch=ML_BATCH, seq=ML_SEQ, steps=ML_STEPS)
    ml_s = time.perf_counter() - t0
    ml_launches = ml["launches"]
    sweeps = ML_STEPS // cfg.sweep_period
    assert ml_launches == {"moe_router": ML_STEPS * ML_LAYERS, "hot_gather": ML_STEPS,
                           "ownership_sweep": sweeps}, ml_launches
    assert chunk_replay.launches == 0 and latency_histogram.launches == 0
    rows = ml["rows"]
    walls = [r["wall_ms"] for r in rows[1:]]  # the first step builds cuBLAS plans
    assert rows[-1]["hit_frac"] > 0 and rows[0]["hit_frac"] == 0.0
    assert all(np.isfinite([r["hot_frac"] for r in rows])) and rows[-1]["hot_frac"] > 0
    assert ml["near_tie_rows"] <= ML_STEPS * ML_LAYERS * ML_BATCH * ML_SEQ * 1e-4, ml["near_tie_rows"]
    print(f"phase 6 ok: {ML_STEPS} steps x {ML_LAYERS} layers in {ml_s:.1f} s (kernel and plain "
          f"runs in lockstep); kernel step wall median {np.median(walls):.3f} ms, min "
          f"{min(walls):.3f}, max {max(walls):.3f}; embed hit_rate {ml['embed_hit_rate']:.4f}, "
          f"expert hit_rate {ml['expert_hit_rate']:.4f}; peak device memory {ml['peak_bytes']} "
          f"bytes; near-tie router rows {ml['near_tie_rows']} (resyncs {ml['resyncs']}); "
          f"y max_abs_err {ml['y_max_abs_err']}, gates max_abs_err {ml['gate_max_abs_err']}; "
          f"launches {ml_launches}")
    record["ml_profile"] = _profile_steps(torch, ml["kernel_step"], 3, out_dir, "phase 6",
                                          unprofiled_ms=float(np.median(walls)))
    record["ml"] = {k: v for k, v in ml.items()
                    if k not in ("hot_ids", "table", "params", "tokens", "embed_state", "kernel_step")}
    record["ml"]["wall_s"] = ml_s
    record["ml"]["hot_ids"] = ml["hot_ids"].tolist()
    err_router = max(err_router, ml["gate_max_abs_err"])

    # Kernel times at the drive's shapes, on its last step's data: layer 0's
    # router logits (32,768 x 64, k = 6, groups of 512) and the token batch
    # through the final cache (2048 hot rows of 2048 bf16).
    tokens = ml["tokens"].reshape(-1).contiguous()
    hstate, table = ml["embed_state"], ml["table"]
    hot_table = table[hstate.hot_ids.clamp(0, table.shape[0] - 1).long()]
    xg = table[tokens.long()].float()
    logits = (xg @ ml["params"][0]["router"].float()).contiguous()
    t_n, e_n, k_n, grp = logits.shape[0], logits.shape[1], cfg.top_k, ml["group"]
    router_ms = _device_ms(lambda: moe_router(logits, k=k_n, group=grp), torch)
    router_plain = _device_ms(lambda: router_ref(logits, k_n, grp), torch, iters=20)
    router_floor = _device_ms(lambda: torch.topk(torch.softmax(logits, dim=-1), k_n, dim=-1), torch)
    router_bytes = t_n * e_n * 4 + t_n * k_n * 8 + (t_n // grp) * e_n * 4
    router_ops = t_n * e_n * (4 + 2 * k_n)  # max, sub, exp, div, k rounds of compare + mask
    router_bound = max(router_bytes / BW_BYTES_PER_S, router_ops / F32_OPS_PER_S) * 1e3
    gslots = hstate.slot_map[tokens.long()]
    ghit = gslots >= 0
    gather_ms = _device_ms(lambda: hot_gather(tokens, hstate.slot_map, hot_table), torch)
    gather_plain = _device_ms(lambda: hot_gather_ref(tokens, hstate.slot_map, hot_table), torch, iters=20)
    safe = gslots.clamp_min(0).long()
    gather_floor = _device_ms(lambda: torch.nn.functional.embedding(safe, hot_table), torch)
    d_n = hot_table.shape[1]
    gather_bytes = (t_n * 4 + int(torch.unique(tokens).numel()) * 4
                    + int(torch.unique(gslots[ghit]).numel()) * d_n * 2 + t_n * d_n * 2 + t_n)
    gather_bound = gather_bytes / BW_BYTES_PER_S * 1e3
    router_calls = _kernels_per_call(torch, lambda: moe_router(logits, k=k_n, group=grp), moe_router)
    assert router_calls["host_launches"] == router_calls["counted"] == 1, router_calls
    print(f"phase 6 moe_router ({t_n} x {e_n}, k {k_n}, groups of {grp}): kernel {router_ms:.4f} ms, "
          f"plain {router_plain:.4f} ms, bound {router_bound:.4f} ms, "
          f"{router_bound / router_ms:.4f} of the bound, softmax+topk floor {router_floor:.4f} ms; "
          f"{router_calls['host_launches']:.1f} kernel launches a call, device events "
          f"{router_calls['device_events']}")
    print(f"phase 6 hot_gather ({t_n} tokens, {hot_table.shape[0]} x {d_n} bf16 hot table, hit "
          f"{float(ghit.float().mean()):.4f}): kernel {gather_ms:.4f} ms, plain {gather_plain:.4f} ms, "
          f"bound {gather_bound:.4f} ms, F.embedding floor {gather_floor:.4f} ms")
    record["ml_kernels"] = dict(router_floor_ms=router_floor, gather_floor_ms=gather_floor,
                                gather_hit_frac=float(ghit.float().mean()),
                                router_share_of_bound=router_bound / router_ms,
                                router_per_call=router_calls)
    del ml, tokens, hstate, table, hot_table, xg, logits, gslots, ghit, safe

    lap("phase 6")

    # ---- phase 7: serving at qwen3-1.7b full width and depth -------------
    # launch/serve.py's loop: a 16-lane ServeEngine (8,192-slot cache)
    # behind a 4-pod SessionRouter, 96 requests over 32 Zipf-1.2 sessions,
    # prompts of 512-4096 tokens, 64 new tokens each, greedy, pod 3 (the
    # leader) failing half-way. First on the kernel path alone (the main
    # path: launches counted, times taken), then the same stream with the
    # kernels held against their plain versions and a teacher-forced
    # plain-version engine beside it.
    torch.cuda.empty_cache()
    scfg = get_config(SERVE_ARCH)
    smodel = Model(scfg, dev)
    t0 = time.perf_counter()
    sparams = smodel.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(sparams))
    print(f"phase 7 {SERVE_ARCH}: {n_params} parameters "
          f"({sum(t.numel() * t.element_size() for t in _leaves(sparams))} bytes), "
          f"initialised in {time.perf_counter() - t0:.2f} s")
    # Warm-up outside the counts: one prefill and one decode step (cuBLAS plans).
    warm = smodel.init_state(SERVE_LANES, 1024)
    wtok = torch.randint(0, scfg.vocab_size, (1, 600), device=dev, dtype=torch.int32)
    smodel.prefill(sparams, {"tokens": wtok}, cache_len=1024)
    smodel.decode_step(sparams, warm, torch.zeros(SERVE_LANES, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    del warm
    all_kernels = {"chunk_replay": chunk_replay, "ownership_sweep": ownership_sweep,
                   "latency_histogram": latency_histogram, "moe_router": moe_router,
                   "hot_gather": hot_gather, "flash_attention": flash_attention,
                   "flash_decode": flash_decode}
    for fn in all_kernels.values():
        fn.launches = 0
    flash_attention.launches_by_variant = dict.fromkeys(fa_ops.VARIANTS, 0)
    torch.cuda.reset_peak_memory_stats()
    drive = _serve_drive(torch, dev, smodel, sparams, log=lambda m: print(f"phase 7 {m}"))
    serve_launches = {name: fn.launches for name, fn in all_kernels.items()}
    attn_variants = dict(flash_attention.launches_by_variant)
    serve_peak = torch.cuda.max_memory_allocated()
    seng, srouter = drive["engine"], drive["router"]
    n_prefill, n_steps = len(drive["prefills"]), seng.steps
    sweeps = srouter.tick_count // srouter.daemon.period
    layers = scfg.num_layers
    assert serve_launches == {"chunk_replay": 0, "ownership_sweep": sweeps, "latency_histogram": 0,
                              "moe_router": 0, "hot_gather": 0, "flash_attention": layers * n_prefill,
                              "flash_decode": layers * n_steps}, serve_launches
    # Every prefill layer went through the TMA/wgmma kernel (bf16, D 128).
    assert attn_variants == {"tma_wgmma": layers * n_prefill, "mma_sync": 0, "f32_simt": 0}, attn_variants
    assert srouter.stats["elections"] == 1 and srouter.leader != SERVE_FAIL_POD, srouter.stats
    outs = [o for o in seng.outputs.values() if o]
    assert outs and all(0 <= t < scfg.vocab_size for o in outs for t in o)
    step_ms = np.asarray([m for m, _, _ in drive["steps"]])
    decode_tokens = sum(n for _, n, _ in drive["steps"])
    prefill_ms = np.asarray([m for _, m in drive["prefills"]])
    prompt_tokens = sum(n for n, _ in drive["prefills"])
    serve = dict(
        wall_s=drive["wall_s"], tokens_out=seng.tokens_out,
        tokens_per_s=seng.tokens_out / drive["wall_s"], prefills=drive["prefills"],
        prompt_tokens=prompt_tokens, prefill_ms_total=float(prefill_ms.sum()),
        decode_steps=n_steps, decode_tokens=decode_tokens,
        decode_step_ms_median=float(np.median(step_ms)), decode_step_ms_min=float(step_ms.min()),
        decode_step_ms_max=float(step_ms.max()), decode_ms_total=float(step_ms.sum()),
        decode_tokens_per_s=decode_tokens / (step_ms.sum() / 1e3),
        peak_bytes=serve_peak, cache_bytes=seng.cache_bytes(), router=dict(srouter.stats),
        hit_rate=srouter.hit_rate(), leader=srouter.leader, sweeps=sweeps, launches=serve_launches,
        attention_launches_by_variant=attn_variants,
    )
    print(f"phase 7 serve: {seng.tokens_out} tokens in {drive['wall_s']:.3f} s "
          f"({serve['tokens_per_s']:.1f} tok/s end to end); {n_prefill} prefills of "
          f"{prompt_tokens} prompt tokens in {serve['prefill_ms_total']:.1f} ms; {n_steps} decode "
          f"steps, median {serve['decode_step_ms_median']:.3f} ms (min {serve['decode_step_ms_min']:.3f}, "
          f"max {serve['decode_step_ms_max']:.3f}), {serve['decode_tokens_per_s']:.1f} decode tok/s; "
          f"peak device memory {serve_peak} bytes (cache {serve['cache_bytes']})")
    print(f"phase 7 router: hit_rate {srouter.hit_rate():.4f}, migrations {srouter.stats['migrations']}, "
          f"migrated {srouter.stats['migrated_bytes']:.0f} bytes, expired {srouter.stats['expired']}, "
          f"elections {srouter.stats['elections']}, leader {srouter.leader}, sweeps {sweeps}")
    print("phase 7 prefill ms by prompt length: " + ", ".join(
        f"{n}:{m:.2f}" for n, m in sorted(drive["prefills"])))
    print(f"phase 7 launches {serve_launches}; flash_attention by variant {attn_variants}")
    # The decode lengths of the median step, for the kernel record.
    mid_lengths = drive["steps"][len(drive["steps"]) // 2][2]

    # Prefill latency at fixed prompt lengths (median of three), and where
    # a decode step's and a 4096-token prefill's device time goes.
    prefill_at = {}
    for n in SERVE_PREFILL_LENS:
        toks = torch.randint(0, scfg.vocab_size, (1, n), device=dev, dtype=torch.int32)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            smodel.prefill(sparams, {"tokens": toks}, cache_len=SERVE_CACHE)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        prefill_at[n] = float(np.median(times))
    print("phase 7 prefill ms at fixed lengths (median of 3): " + ", ".join(
        f"{n}: {m:.3f}" for n, m in prefill_at.items()))
    serve["prefill_ms_at"] = prefill_at
    record["serve_decode_profile"] = _profile_steps(
        torch, lambda: smodel.decode_step(sparams, seng.state, seng.last_token), 3, out_dir,
        "phase 7 decode", unprofiled_ms=serve["decode_step_ms_median"])
    longest = SERVE_PREFILL_LENS[-1]
    ptoks = torch.randint(0, scfg.vocab_size, (1, longest), device=dev, dtype=torch.int32)
    record["serve_prefill_profile"] = _profile_steps(
        torch, lambda: smodel.prefill(sparams, {"tokens": ptoks}, cache_len=SERVE_CACHE), 2, out_dir,
        f"phase 7 prefill {longest}", unprofiled_ms=prefill_at[longest])
    del seng, srouter, drive
    torch.cuda.empty_cache()

    # The same stream, kernels held against their plain versions, beside a
    # teacher-forced plain-version engine.
    t0 = time.perf_counter()
    keng, krouter = _serve_engines(torch, dev, smodel, sparams)
    peng, _ = _serve_engines(torch, dev, smodel, sparams)
    lock = _Lockstep(torch, keng, peng)
    from repro_torch.launch.serve import serve_loop

    serve_loop(lock, krouter, np.random.default_rng(0), requests=SERVE_REQUESTS,
               sessions=SERVE_SESSIONS, pods=SERVE_PODS, prompt_len=SERVE_PROMPT,
               max_new=SERVE_MAX_NEW, vocab_size=scfg.vocab_size, fail_pod=SERVE_FAIL_POD,
               log=lambda m: None)
    st = lock.stats
    assert st["attn_checks"] == layers * n_prefill and keng.steps == n_steps, (st, keng.steps)
    assert st["decode_checks"] == layers * len(range(0, n_steps, SERVE_CHECK_EVERY)), st
    assert keng.outputs == peng.outputs and dict(krouter.stats) == serve["router"]
    lock_s = time.perf_counter() - t0
    print(f"phase 7 ok: kernels against plain versions in every layer of {n_prefill} prefills "
          f"(max_abs_err {st['attn_err']}, scaled bar used {st['attn_bar_use']:.4f}) and of "
          f"{st['decode_checks'] // layers} decode steps (max_abs_err {st['decode_err']}, scaled bar "
          f"used {st['decode_bar_use']:.4f}); teacher-forced plain engine over {st['samples']} "
          f"sampling calls, {st['tokens']} tokens: max logit difference {st['logit_err']} "
          f"(bar {LOGIT_TOL}), near-tie tokens {st['near_ties']} (widest top-2 margin "
          f"{st['widest_tie']}, bar {LOGIT_TOL}), no other difference ({lock_s:.1f} s)")
    serve["check"] = {k: v for k, v in st.items() if k != "check_decode"}
    serve["check"]["wall_s"] = lock_s
    record["serve"] = serve
    del lock, keng, krouter, peng
    torch.cuda.empty_cache()

    # Kernel times at the serving shapes: a prefill layer at every length of
    # SERVE_PREFILL_LENS (q [1, S, 16, 128], k/v [1, S, 8, 128] bf16, causal),
    # SDPA beside it, the mma.sync kernel (bf16 D 32/256) beside it at the longest, and a decode
    # layer over the 16 x 8,192 cache at the drive's median-step lengths.
    h_, kh_, dh_ = scfg.num_heads, scfg.num_kv_heads, scfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    attn_at = {}
    for n in SERVE_PREFILL_LENS:
        q, k, v = (torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)
                   for sh in ((1, n, h_, dh_), (1, n, kh_, dh_), (1, n, kh_, dh_)))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        flops, nbytes = _attention_flops_bytes(1, n, n, h_, kh_, dh_, True, 0)
        bound = max(flops / BF16_OPS_PER_S, nbytes / BW_BYTES_PER_S) * 1e3
        ms = _device_ms(lambda: flash_attention(q, k, v), torch, reps=5, iters=20)
        lib_ms = _device_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), torch,
                            reps=5, iters=20)
        rows = fa_ops.q_rows(n, h_, 1)  # and the q tile that the rule did not pick, for comparison
        other_ms = _device_ms(lambda: fa_ops._launch(q, k, v, True, 0, "tma_wgmma", 192 - rows), torch,
                              reps=5, iters=20)
        attn_at[n] = dict(ms=ms, sdpa_ms=lib_ms, bound_ms=bound, tflops=flops / ms / 1e9,
                          share_of_bound=bound / ms, q_rows=rows, other_q_rows_ms=other_ms)
        print(f"phase 7 flash_attention S {n}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
              f"{bound / ms:.3f} of the bound {bound:.4f} ms, q tile {rows}; q tile {192 - rows}: "
              f"{other_ms:.4f} ms), SDPA {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s)")
    fa_ms, fa_lib, fa_bound = (attn_at[longest][key] for key in ("ms", "sdpa_ms", "bound_ms"))
    fa_flops, fa_bytes = _attention_flops_bytes(1, longest, longest, h_, kh_, dh_, True, 0)
    fa_plain = _device_ms(lambda: flash_attention_ref(q, k, v), torch, reps=3, iters=3)
    fa_mma = _device_ms(lambda: fa_ops._launch(q, k, v, True, 0, "mma_sync"), torch, reps=5, iters=20)
    encode_us = fa_ops.encode_seconds(q, k, v) * 1e6
    print(f"phase 7 flash_attention S {longest}: plain {fa_plain:.4f} ms; the mma.sync kernel "
          f"{fa_mma:.4f} ms ({fa_flops / fa_mma / 1e9:.1f} TFLOP/s); tensor-map encoding adds "
          f"{encode_us:.3f} us of host time a call")
    del q, k, v, qt, kt, vt
    dq = torch.randn((SERVE_LANES, h_, dh_), generator=gen, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn((SERVE_LANES, SERVE_CACHE, kh_, dh_), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    lens = (mid_lengths + 1).to(torch.int32)  # the step's valid length
    fd_ms = _device_ms(lambda: flash_decode(dq, kc, vc, lens), torch)
    fd_plain = _device_ms(lambda: flash_decode_ref(dq, kc, vc, lens), torch, reps=3, iters=10)
    kct, vct = (x.transpose(1, 2).contiguous() for x in (kc, vc))
    mask = (torch.arange(SERVE_CACHE, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    fd_lib = _device_ms(lambda: sdpa(dq[:, :, None], kct, vct, attn_mask=mask, enable_gqa=True), torch)
    valid = int(torch.clamp_max(lens, SERVE_CACHE).sum())
    fd_bytes = valid * kh_ * dh_ * 2 * 2 + 2 * SERVE_LANES * h_ * dh_ * 2 + SERVE_LANES * 4
    fd_flops = 4 * valid * h_ * dh_
    fd_bound = max(fd_bytes / BW_BYTES_PER_S, fd_flops / BF16_OPS_PER_S) * 1e3
    print(f"phase 7 flash_decode (16 lanes, cache 8192, {valid} valid positions): kernel {fd_ms:.4f} ms "
          f"({fd_bytes / fd_ms / 1e6:.1f} GB/s), plain {fd_plain:.4f} ms, masked SDPA {fd_lib:.4f} ms, "
          f"bound {fd_bound:.4f} ms")
    record["serve_kernels"] = dict(decode_lengths=lens.tolist(), attention_tflops=fa_flops / fa_ms / 1e9,
                                   attention_at=attn_at, attention_mma_sync_ms=fa_mma,
                                   attention_encode_us=encode_us, decode_gbs=fd_bytes / fd_ms / 1e6)
    del dq, kc, vc, kct, vct, mask, sparams, smodel
    torch.cuda.empty_cache()
    err_fa = max(err_attn[torch.bfloat16], err_attn[torch.float32], st["attn_err"])
    err_fd = max(err_dec[torch.bfloat16], err_dec[torch.float32], st["decode_err"])

    lap("phase 7")

    # ---- phase 8: the kernel record ------------------------------------
    # Launches: the telemetry path's run (phase 5) drives the first three,
    # the ML-state run (phase 6) the next two, the serving drive (phase 7)
    # the last two.
    kernels = [
        dict(name="chunk_replay", route="cuda",
             source="src/repro_torch/kernels/chunk_replay/csrc/chunk_replay.cu",
             replaces="src/repro/kernels/chunk_replay/kernel.py:71",
             launches=tele_launches["chunk_replay"], max_abs_err=err_replay,
             ms=chunk_ms, plain_ms=chunk_plain,
             bound_ms=replay_bytes / BW_BYTES_PER_S * 1e3, bound_by="bytes",
             library_ms=None, whole_trace_ms=whole_ms, whole_trace_bound_ms=whole_bound,
             kernels_per_call=replay_calls[tcfg.num_bins]["host_launches"]),
        dict(name="ownership_sweep", route="cuda",
             source="src/repro_torch/kernels/ownership_sweep/csrc/ownership_sweep.cu",
             replaces="src/repro/kernels/ownership_sweep/kernel.py:38",
             launches=tele_launches["ownership_sweep"], max_abs_err=err_sweep,
             ms=sweep_ms, plain_ms=sweep_plain,
             bound_ms=sweep_bytes / BW_BYTES_PER_S * 1e3, bound_by="bytes",
             library_ms=None),
        dict(name="latency_histogram", route="cuda",
             source="src/repro_torch/kernels/latency_histogram/csrc/latency_histogram.cu",
             replaces="src/repro/kernels/latency_histogram/kernel.py:38",
             launches=tele_launches["latency_histogram"], max_abs_err=err_hist,
             ms=hist_ms, plain_ms=hist_plain,
             bound_ms=hist_bytes / BW_BYTES_PER_S * 1e3, bound_by="bytes",
             library_ms=None),
        dict(name="moe_router", route="cuda",
             source="src/repro_torch/kernels/moe_router/csrc/moe_router.cu",
             replaces="src/repro/kernels/moe_router/kernel.py:28",
             launches=ml_launches["moe_router"], max_abs_err=err_router,
             ms=router_ms, plain_ms=router_plain, bound_ms=router_bound,
             bound_by="bytes" if router_bytes / BW_BYTES_PER_S >= router_ops / F32_OPS_PER_S
             else "operations",
             library_ms=None, kernels_per_call=router_calls["host_launches"]),
        dict(name="hot_gather", route="cuda",
             source="src/repro_torch/kernels/hot_gather/csrc/hot_gather.cu",
             replaces="src/repro/kernels/hot_gather/kernel.py:34",
             launches=ml_launches["hot_gather"], max_abs_err=err_gather,
             ms=gather_ms, plain_ms=gather_plain, bound_ms=gather_bound, bound_by="bytes",
             library_ms=None),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:31",
             launches=serve_launches["flash_attention"], max_abs_err=err_fa,
             variant={k: v for k, v in attn_variants.items() if v},
             ms=fa_ms, plain_ms=fa_plain, bound_ms=fa_bound,
             bound_by="operations" if fa_flops / BF16_OPS_PER_S >= fa_bytes / BW_BYTES_PER_S else "bytes",
             library_ms=fa_lib),
        dict(name="flash_decode", route="cuda",
             source="src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
             replaces="src/repro/kernels/flash_decode/kernel.py:29",
             launches=serve_launches["flash_decode"], max_abs_err=err_fd,
             ms=fd_ms, plain_ms=fd_plain, bound_ms=fd_bound,
             bound_by="bytes" if fd_bytes / BW_BYTES_PER_S >= fd_flops / BF16_OPS_PER_S else "operations",
             library_ms=fd_lib),
    ]
    record["kernels"] = kernels
    record["ml_launches"] = ml_launches
    record["card"] = smi
    lap("phase 8")
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
