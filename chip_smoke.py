#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from the sources in the checkout, holds each
against its plain PyTorch version on the card, drives ``run_scenario`` at
the paper's size (card against CPU, telemetry on) and at full size (the
first 10 M requests of a 100 M-request trace over a 1 M-key metadata store
on the card; the kernels timed on the whole trace): first without telemetry
(phase 4), then with ``TelemetryConfig()`` for Redynis and static remote
and with the M/M/1 contention model for Redynis (phase 5), each full-size
run held against the same run through the plain versions on the card. Phase
6 drives Redynis on ML state at deepseek-moe-16b widths: 50 steps of 32,768
Zipf tokens through the hot-row embedding cache and 4 full-width MoE
layers, both placement daemons folded every step and swept every 25, held
every step against the same steps through the plain versions. Phase 7
serves qwen3-1.7b at full width and all 28 layers through
``launch/serve.py``'s loop (8 requests to a 16-lane ``ServeEngine`` with an
8,192-slot cache behind a 4-pod ``SessionRouter`` whose leader fails
half-way), first on the kernel path alone with its launches counted, then
with every prefill's and every 8th decode step's attention held against the
plain versions beside a teacher-forced plain-version engine. Phase 8 runs
the paper's experiment grid: ``run_experiment`` for Figures 2 and 3 at the
paper's size (card against the CPU port on the same traces), the policy
head-to-head of ``benchmarks/policy_matrix.py`` and the budgets of
``benchmarks/capacity_sweep.py`` at 1 M keys and 2.5 M requests (held
against the plain-version engine), with the ``capacity_projection``
kernel held against its plain version bit for bit on a sweep's input and
an edge-preset one, and timed. Phase 10 drives the routing tier and failure injection:
``benchmarks/directory_staleness.py`` and ``availability.py`` at their
default sizes (card against the CPU port, and the benchmarks' own checks),
then publish lags, a bounded router cache, a region crash and a partition
at 2.5 M requests over 1 M keys, each Redynis row held against the
plain-version engine. Phase 2 also holds ``chunk_replay`` on empty replica
rows and on the fault path's operands (negative ``extra_ms``, refused rows,
a dead node's column), and ``flash_attention``'s TMA/wgmma kernel through
every mask at D 128 and 64, and phase 7 checks that every prefill layer
went through it. It times each kernel (phase 9 prints the record):
attention beside SDPA at every prefill length, the sweep on int32 and f32
counts, the histogram at the static path's full-size shape on its own
latencies and on log-uniform ones, in the flat form and in 997-row chunks.
Phase 2 holds the histogram's threshold count against the bin rule on all
2**32 f32 bit patterns at five settings (two of them the cost
attribution's), the attribution fold (80 groups a launch) and the
``trace_window`` kernel (a window of a trace from its threefry stream;
uniform and skewed, one and five nodes, diurnal, a window past the trace
and one at 2**30) against their plain versions. Phase 11 drives cost
attribution, the flight recorder and streamed traces:
``benchmarks/latency_attribution.py`` at its defaults (card against the CPU
port, the component-sum check, the exports byte for byte), its four
policies at 1 M keys and 2.5 M requests (against the plain-version engine),
static policies at 100 M requests on the whole-trace path, and a streamed
10 M-request Redynis run against the materialized one, bit for bit, with
their peak memory. Phase 12 drives the key-sharded engine on ranks that
share the card (``repro_torch.spmd.run_ranks``, gloo): the sharded test
scenario at 2 and 4 ranks against the CPU port's one-rank run, the streamed
trendline shape of ``benchmarks/engine_throughput.py`` at 10**7 keys and 5
x 10**5 requests on 2 ranks (routing off, on, and with a bounded cache)
against the card's one-rank run, with wall time, launches and collectives a
chunk and each rank's peak memory, and ``publish_and_fill`` on 2 ranks at
10**6 objects against its one-process path. Phase 13 trains through
``Trainer.run``: deepseek-moe-16b at full width (4 layers, remat, the sort
dispatch, then the einsum dispatch) for 7 + 3 steps of 32,768 Zipf tokens,
through a sweep of both placement daemons at step 5 (held exactly against
plain daemons fed the same traffic), and qwen3-1.7b at full width and 8 of
its 28 layers through a checkpoint at step 2 and a resume that replays
steps 3-4; steps 1 and 6 of the first and step 1 of the second are held
against the kernels' plain versions (the loss, every gradient, and the
router weights' gradient against the aux term's alone). Phase 14 serves the
four other families through ``ServeEngine`` behind the router: rwkv6-1.6b,
recurrentgemma-2b and whisper-base at full width and depth, llava-next-34b
at full width and 8 of its 60 layers; rwkv6-1.6b is held against the CPU
port and its chunked form against its step form, the others' attention
against the plain versions beside a teacher-forced plain engine, and
llava-next-34b's int8 decode against its bf16 decode and against the plain
versions. Phase 15 trains those four families at full width: rwkv6-1.6b at
6 of its 24 layers and recurrentgemma-2b at full depth through
``Trainer.run`` (4,096-token rows, the hot-row daemon sweeping, held
exactly against a plain daemon), whisper-base at full depth and
llava-next-34b at 4 of its 60 layers through ``Trainer.step`` on
``make_batch`` batches of the train_4k cell; each first step is held
against the kernels' plain versions. Every phase raises on a mismatch and
prints its duration; the script exits non-zero without a CUDA device or
outside a checkout. The last line of its output is the JSON device record.

Phase 16 drives the distribution seam (``dist.py``, ``launch/sharding.py``)
on two gloo ranks that share the card, mesh (data 1, model 2): qwen3-1.7b
at full width and depth prefills 2 x 1,024 tokens (``flash_attention`` on
each rank's 8 of 16 heads) and decodes 8 tokens (``flash_decode`` on its 4
of 8 kv heads), against one rank with ``dist=None``; one training step of
qwen3-1.7b (4 layers) and of granite-moe-1b-a400m (all 24 layers, its 32
experts over the model axis through ``moe_router``) and granite's prefill,
against one rank; the collectives by kind and bytes, each rank's peak
memory and the walls. It prints the analytic memory model on one card for
every (arch x cell) against 80 GB, runs one decode step of rwkv6-1.6b and
recurrentgemma-2b ``long_500k`` at full size and depth beside the model's
bytes, and prints the dry run of qwen3-1.7b train_4k on the fake 16 x 16
mesh (``python -m repro_torch.launch.dryrun``, a CPU subprocess started
after the build and run beside the other phases).
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BW_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# 32-bit integer instructions a second, at most: the data sheet's 67 TFLOP/s
# f32 is 128 lanes an SM issuing a fused multiply-add (two operations) each
# clock, and an SM issues at most 128 thread-instructions a clock (four
# schedulers of 32 lanes), integer ones on its ALU and FMA pipes together.
INT32_OPS_PER_S = 67e12 / 2
F32_OPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores (NVIDIA data sheet)
FULL_REQUESTS = 100_000_000
FULL_KEYS = 1_000_000
FULL_INTERVAL = 10_000
# The Redynis drives of phases 4, 5 and 11 (c) (each with its plain-version
# run) replay the first DRIVE_REQUESTS of a 100 M-request trace over the
# 1 M-key store; the kernels are still timed on the whole trace. Reduced:
# 100 M -> 10 M requests, for the script's time limit (the drives at 100 M
# took about 240 s of a 1,061 s run on an NVIDIA H100 80GB HBM3 machine).
DRIVE_REQUESTS = 10_000_000
# Phase 11 (c): generate_trace on the card against the CPU port; reduced:
# 5 M -> 1 M requests (the CPU port took 13.6 s at 5 M).
GEN_CHECK_REQUESTS = 1_000_000
# Phase 12: benchmarks/engine_throughput.py's trendline shape at its spec
# scale of 10**7 keys; reduced: 10**8 -> 5 x 10**5 requests (50 chunks),
# interval 1,000 -> 10,000, for the time limit (at 10**7 requests the phase
# took 163 s; at 4 x 10**6, 126 s, cut again for phase 13's time; at
# 2 x 10**6, 115 s, cut to 5 x 10**5 for the time limit). The bounded cache
# runs the admission fold.
SHARD_KEYS = 10_000_000
SHARD_REQUESTS = 500_000
SHARD_INTERVAL = 10_000
SHARD_CACHE = 100_000
PUBLISH_OBJECTS, PUBLISH_PAYLOAD, PUBLISH_SLOTS = 1_000_000, 64, 1024
# Phase 8: benchmarks/policy_matrix.py's eight specs and the sixth family,
# on benchmarks/common.py's WAN5_WORKLOAD_KWARGS; capacity_sweep.py's
# budgets (KiB) at 1,000 times its keys.
# policy_matrix and capacity_sweep at full key scale; reduced: 10 M -> 5 M
# requests (phases 8, 10 and 11 with it), for phase 13's time, then 5 M ->
# 2.5 M for the time limit.
GRID_REQUESTS = 2_500_000
GRID_ITERATIONS = 3
MATRIX_SPECS = ("local", "remote", "replicated", "redynis", "redynis:h=0.05,decay=0.9",
                "topk:k=100", "costgreedy", "decaylfu:alpha=0.5", "sizeaware")
WAN5_WORKLOAD_KWARGS = dict(num_nodes=5, region_weights=(0.35, 0.25, 0.20, 0.12, 0.08), affinity=0.8)
CAPACITY_KIB = (float("inf"), 256_000, 128_000, 64_000, 32_000, 16_000)
EDGE_CAPACITY_BYTES = 64 * 1024.0 * 1_000
ML_LAYERS = 4  # deepseek-moe-16b has 28; cut for the time limit shared with the other phases
ML_BATCH, ML_SEQ = 16, 2048  # 32,768 tokens per step
# two sweeps at sweep_period 25; reduced: 150 -> 100 steps for phase 13's
# time, then 100 -> 50 with the sweep period 50 -> 25 for the time limit
ML_STEPS, ML_SWEEP_PERIOD = 50, 25
ML_NODES = 4
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
# Phase 13: training through Trainer.run. (a) deepseek-moe-16b at full width;
# reduced: 28 -> 4 layers (as phase 6 cuts), 7 + 3 steps with the daemons'
# sweep_period 50 -> 5 (a step takes 2.54 s on the card; 22 steps with a
# sweep at 20 took the phase to 189 s, and 12 + 3 with a sweep at 10 to 171 s,
# cut again for phase 15's time). (b) qwen3-1.7b at full width; reduced:
# 4 steps of 4 x 2048 tokens (6 before phase 15), the checkpoint at step 2,
# and 28 -> 14 layers for the time limit (at 28 the checkpoint's save and
# restore took 28 s of the phase's 101), 14 -> 8 for phase 16's time.
TRAIN_LAYERS = ML_LAYERS
TRAIN_BATCH, TRAIN_SEQ = 16, 2048
TRAIN_SWEEP_PERIOD = 5
TRAIN_STEPS = 7  # both daemons sweep at step 5; steps 6-7 run the hot path
TRAIN_EINSUM_STEPS = 3
TRAIN_CHECK_STEPS = (1, 6)
DENSE_BATCH, DENSE_STEPS, DENSE_CKPT_STEP, DENSE_LAYERS = 4, 4, 2, 8
# Kernel path against the plain versions on the same state and batch: the
# loss to 1e-3 relative and each leaf's gradient to 5e-2 relative L2 (bf16
# activations; the kernel's gates differ from the plain version's by f32
# ulps, and a near-tied router pick moves whole rows); the router weights'
# gradient must differ from the aux term's alone by more than 0.1.
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL_L2, TRAIN_ROUTER_NOT_AUX = 1e-3, 5e-2, 0.1
# Resumed losses against the uninterrupted run's: the embedding's backward
# adds with atomics in no fixed order, so bf16 params may differ by an ulp.
RESUME_RTOL = 1e-4
SERVE_ARCH = "qwen3-1.7b"  # full width and all 28 layers
SERVE_LANES, SERVE_CACHE = 16, 8192
# reduced: 96 -> 64 requests (for phase 13's time) -> 32 over 16 sessions
# (for phase 14's; its lockstep with the plain versions took 73 of 110 s)
# -> 8 over 4 sessions, for the time limit (16 took the phase to 96 s on a
# slow host)
SERVE_REQUESTS, SERVE_SESSIONS, SERVE_PODS = 8, 4, 4
# The router ticks once a request and sweeps every SERVE_SWEEP_PERIOD ticks:
# in an 8-request drive once before the leader fails and once after (every
# 16 ticks before the drives were cut to 8 requests).
SERVE_SWEEP_PERIOD = 4
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
# Phase 14: the four families of the serving slice through ServeEngine
# behind SessionRouter (Zipf sessions, 4 pods, the leader failing half-way),
# each at full width; rwkv6-1.6b, recurrentgemma-2b and whisper-base at full
# depth. Reduced: llava-next-34b 60 -> 30 layers (its bf16 params at 30
# layers are 35.3 GB and their int8 copy 17.7 GB, both beside the caches for
# the int8 comparison; 60 layers in bf16 alone are 68.8 GB), then 30 -> 12
# for the time limit (it took 43 s of the phase's 107 at 30); every drive
# 8 requests over 4 sessions (16 over 8 before the cuts for the time limit;
# llava-next-34b on 2 lanes), as phase 7 serves 8 over 4. An RWKV-6 prompt of
# 32 tokens or more must be a multiple of 32 (the reference asserts it), so
# its lengths are drawn in steps of 32. ``cache`` is the KV cache's slots:
# recurrentgemma-2b's attention keeps rings of its 2,048-token window and
# rwkv6-1.6b keeps no cache, so both ignore it.
FAMILY_LAYERS = {"llava-next-34b": 8}  # 12 -> 8 for phase 16's time
FAMILY_DRIVES = {
    "rwkv6-1.6b": dict(lanes=8, cache=0, requests=8, sessions=4, prompt_len=(256, 2048),
                       prompt_step=32, max_new=32),
    "recurrentgemma-2b": dict(lanes=8, cache=0, requests=8, sessions=4, prompt_len=(512, 4096),
                              prompt_step=1, max_new=64),
    "whisper-base": dict(lanes=8, cache=512, requests=8, sessions=4, prompt_len=(64, 448),
                         prompt_step=1, max_new=64),
    "llava-next-34b": dict(lanes=2, cache=4096, requests=8, sessions=4, prompt_len=512,
                           prompt_step=1, max_new=32),
}
# The lockstep's logit bar, LOGIT_TOL but where a card run read more (an
# NVIDIA H100 80GB HBM3 at 700 W), each of the family's attention calls within the
# kernels' own bars: recurrentgemma-2b, whose RG-LRU layers carry a token's
# bf16 difference to every later token, read 0.135 at its first prefill and
# 0.175 over a whole drive; llava-next-34b, whose logits spread 1.9 times
# qwen3-1.7b's (a 7,168-wide embedding at the same 0.02 scale) over 30
# layers, read 0.261 at its first prefill of 3,392 positions. qwen3-1.7b
# reads 0.0949 over 28 layers.
FAMILY_LOGIT_TOL = {"recurrentgemma-2b": 0.25, "llava-next-34b": 0.5}
# (a) rwkv6-1.6b against the CPU port: full width, 2 layers (cut for the CPU's
# time only), a 64-token prompt and 8 decode steps, logits at LOGIT_TOL and
# the state within CPU_STATE_REL_L2 relative L2 (bf16 on both sides, each
# device's own roundings); at full depth, in f32, the chunked form over 96
# tokens against 64 tokens and 32 steps of the step form: each state tensor
# and the last output within WKV_REL_L2 relative L2: two orders of the same
# f32 recurrence, whose exp of a chunk's log-decay sum (up to 32 in size at
# the init's decay) carries a relative rounding of |sum| x 2**-24 into every
# key and state, through 24 layers of random weights (1.2e-4 on an NVIDIA
# H100 80GB HBM3; an error of the chunked form would be of order 1).
RWKV_CPU_LAYERS, RWKV_CPU_PROMPT, RWKV_CPU_STEPS = 2, 64, 8
CPU_STATE_REL_L2, WKV_REL_L2 = 0.05, 1e-3
# Phase 15: the ssm, hybrid, audio and vlm families in training, each at full
# width. rwkv6-1.6b and recurrentgemma-2b (26 layers) through
# Trainer.run on Pipeline batches of 4,096 tokens, the hot-row daemon
# sweeping every "sweep" steps; whisper-base (6 + 6 layers, 1,500 frames) and
# llava-next-34b through Trainer.step on make_batch batches of the train_4k
# cell. Reduced: the train_4k cell's global batch 256 -> the rows one card
# holds ("batch"; recurrentgemma-2b's peak was 55.8 GB at 1 on an H100 80GB);
# llava-next-34b 60 -> 4 layers (as phase 13 cuts deepseek-moe-16b);
# rwkv6-1.6b 24 -> 6 layers, for the time limit (its chunk loop is host
# dispatch: a 24-layer step of 2 rows took 19-22 s on one NVIDIA H100 80GB
# HBM3 machine at 700 W and its three passes 105 s on a slower host);
# sweep_period 50 -> "sweep"; 2-3 steps, the first held against the plain
# versions, the last profiled.
FAMILY_TRAIN = {
    "rwkv6-1.6b": dict(batch=2, steps=2, sweep=1, run=True, layers=6),
    "recurrentgemma-2b": dict(batch=1, steps=3, sweep=2, run=True),
    "whisper-base": dict(batch=8, steps=3, run=False),
    "llava-next-34b": dict(batch=1, steps=3, run=False, layers=4),
}
# (d) llava-next-34b int8: 16 decode steps with bf16 and with int8 params
# from one bf16 prefill state (the int8 run teacher-forced with the bf16
# run's tokens), held at tests/test_beyond_paper.py's bar; then 16 int8 steps
# with the kernels against the plain versions.
INT8_STEPS, INT8_REL_BAR = 16, 0.2
# tests/test_kernels.py's attention shapes: (b, s, t, h, kh, dh, causal, window).
ATTN_CASES = [(2, 256, 256, 4, 2, 64, True, 0), (1, 128, 128, 8, 1, 128, True, 0),
              (2, 256, 256, 4, 4, 32, True, 64), (1, 128, 384, 4, 2, 64, False, 0),
              (1, 192, 192, 6, 2, 64, True, 0)]
DECODE_CASES = [(2, 1024, 8, 2, 64), (4, 512, 4, 1, 128), (2, 768, 16, 16, 32)]  # (b, t, h, kh, dh)
# The TMA/wgmma kernel's masks at D 128, 64 and 256: causal S 4096 and 3001,
# causal ragged S 1000 and 130, a 256-key window at S 2048, non-causal S 128
# over T 384; GQA groups 2, 1, 8.
TMA_CASES = [(b, s, t, h, kh, dh, causal, window) for dh in (128, 64, 256) for b, s, t, h, kh, causal, window in (
    (1, 4096, 4096, 16, 8, True, 0), (1, 3001, 3001, 16, 8, True, 0), (1, 1000, 1000, 8, 8, True, 0),
    (2, 130, 130, 16, 2, True, 0), (1, 2048, 2048, 16, 8, True, 256), (2, 128, 384, 8, 1, False, 0))]
# Rows with no allowed key (window > 0, T + window <= S: rows from T + window - 1
# on are the mean of v), causal and not, in q tiles with and without kv tiles
# to visit; (b, s, t, h, kh, causal, window), run through every variant, and
# through mma_sync at D 256 by name (the dispatch takes D 256 to tma_wgmma).
EMPTY_ROW_CASES = [(1, 256, 64, 4, 2, True, 16), (2, 192, 128, 4, 2, False, 24),
                   (1, 1000, 100, 8, 2, True, 30)]
EMPTY_ROW_VARIANTS = [("f32_simt", "float32", 64), ("mma_sync", "bfloat16", 32),
                      ("mma_sync", "bfloat16", 256), ("tma_wgmma", "bfloat16", 64),
                      ("tma_wgmma", "bfloat16", 128), ("tma_wgmma", "bfloat16", 256)]
# flash_decode beyond DECODE_CASES: recurrentgemma-2b's 8 rings of 2,048 slots
# (10 q heads on 1 kv head of 256) and a group of 16 at D 256.
DECODE_RING_CASES = [(8, 2048, 10, 1, 256), (4, 2048, 16, 1, 256)]


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


# (lo, hi, B) of tests/test_torch_telemetry.py::HIST_GRID, then the cost
# attribution's rules (AttributionConfig's 0.01 ms floor, 64 and 96 bins),
# whose bin rules phase 2 checks on every f32 bit pattern.
RULE_CHECKS = ((1.0, 10_000.0, 128), (5.0, 500.0, 32), (0.1, 1e6, 128),
               (0.01, 10_000.0, 64), (0.01, 10_000.0, 96))


def _histogram_cases(torch, dev, rng) -> tuple[int, float, list, dict]:
    """Hold ``latency_histogram`` against its plain version on the card:
    log-uniform latencies over [0.1, 1e5] ms with the decade edges first, G
    up to 128, flat and per-chunk forms (a short last chunk); rows that all
    share one latency or a handful (collisions in every warp); all weights
    0; G 1 and the largest G the wrapper admits at B 128 (454: neither the
    u32 counts nor the threshold table fit beside the histogram, so the
    search reads the table from global memory), 227 (counts, table in
    global memory) and 228 (table, no counts); rows_per_chunk 1, 997 and
    larger than R; R
    not a multiple of 4; inputs at an offset off 16 bytes. 0/1 weights
    exact, real weights to rtol 1e-5, atol 1e-3 (per chunk where a flat
    cell would sum 10**5 of them). Then the bin rule: the
    kernel's threshold count against ``bin_of`` on all 2**32 f32 bit
    patterns, 0 mismatches, at ``RULE_CHECKS``. Returns (cases, the real
    weights' largest error, the decade-edge bins, mismatches by rule)."""
    from repro_torch.kernels.latency_histogram import ops as hist_ops

    def cuda_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    latency_histogram = hist_ops.latency_histogram
    err, cases = 0.0, 0

    def exact(lat, group, weight, ctx, **kw):
        nonlocal cases
        got = latency_histogram(lat, group, weight, **kw)
        assert torch.equal(got, _plain_histogram(lat, group, weight, **kw)), ctx
        cases += 1

    def close(lat, group, weight, ctx, **kw):
        nonlocal cases, err
        got = latency_histogram(lat, group, weight, **kw)
        want = _plain_histogram(lat, group, weight, **kw)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3, msg=ctx)
        err = max(err, float((got - want).abs().max()))
        cases += 1

    def log_uniform(r):
        lat = np.exp(rng.uniform(np.log(0.1), np.log(1e5), r)).astype(np.float32)
        lat[:4] = [1.0, 10.0, 100.0, 1000.0]
        return lat

    for g in (6, 10, 128):
        r = 1_000_003
        hargs = [cuda_t(log_uniform(r)), cuda_t(rng.integers(0, g, r).astype(np.int32)),
                 cuda_t((rng.random(r) < 0.8).astype(np.float32))]
        hkw = dict(num_groups=g, num_bins=128, lo=1.0, hi=10_000.0)
        for rpc in (None, 10_000, 997):
            exact(*hargs, (g, rpc), rows_per_chunk=rpc, **hkw)
        real = torch.rand(r, device=dev, generator=torch.Generator(device=dev).manual_seed(g))
        close(hargs[0], hargs[1], real, ("real", g), **hkw)
        close(hargs[0], hargs[1], real, ("real", g, 997), rows_per_chunk=997, **hkw)
    # Collisions: one latency for every row, then five; all weights 0.
    r, g = 1_000_003, 10
    group = cuda_t(rng.integers(0, g, r).astype(np.int32))
    ones = torch.ones(r, device=dev)
    hkw = dict(num_groups=g, num_bins=128, lo=1.0, hi=10_000.0)
    for lat in (np.full(r, 123.4, np.float32),
                rng.choice(np.float32([2.5, 40.0, 123.4, 180.25, 20_000.0]), r)):
        for rpc in (None, 10_000, 997):
            exact(cuda_t(lat), group, ones, ("collide", len(np.unique(lat)), rpc),
                  rows_per_chunk=rpc, **hkw)
            if rpc is not None:  # a flat cell would sum 10**5 real weights: f32 drift
                close(cuda_t(lat), group, torch.rand(r, device=dev), ("collide real", rpc),
                      rows_per_chunk=rpc, **hkw)
    exact(cuda_t(log_uniform(r)), group, torch.zeros(r, device=dev), "zero weights",
          rows_per_chunk=10_000, **hkw)
    # G 1, the largest G at B 128, and the two other shared-memory layouts;
    # rows_per_chunk 1, 997 and above R; R not a multiple of 4; offset views.
    for g, r, rpcs in ((1, 1_000_003, (None, 10_000, 997)), (454, 300_001, (None, 10_000)),
                       (227, 300_001, (None, 10_000)), (228, 300_001, (None, 10_000)),
                       (6, 20_011, (1, 997, 10**8)),
                       (10, 4_099, (None, 1, 4_096, 4_099, 10**8))):
        lat, grp = cuda_t(log_uniform(r)), cuda_t(rng.integers(-1, g + 1, r).astype(np.int32))
        w = cuda_t((rng.random(r) < 0.8).astype(np.float32))
        kw = dict(num_groups=g, num_bins=128, lo=1.0, hi=10_000.0)
        for rpc in rpcs:
            exact(lat, grp, w, (g, r, rpc), rows_per_chunk=rpc, **kw)
            exact(lat[1:], grp[1:], w[1:], (g, r, rpc, "offset"), rows_per_chunk=rpc, **kw)
        close(lat, grp, torch.rand(r, device=dev), (g, r, "real"), rows_per_chunk=997, **kw)
    # Other rules of tests/test_torch_telemetry.py::HIST_GRID.
    for lo, hi, b in RULE_CHECKS[1:]:
        r = 1_000_003
        lat = cuda_t(np.exp(rng.uniform(np.log(lo / 10), np.log(hi * 10), r)).astype(np.float32))
        grp = cuda_t(rng.integers(0, 16, r).astype(np.int32))
        exact(lat, grp, ones, (lo, hi, b), num_groups=16, num_bins=b, lo=lo, hi=hi,
              rows_per_chunk=997)
    one = torch.ones(4, dtype=torch.int32, device=dev)
    edge_hist = latency_histogram(cuda_t(np.asarray([1.0, 10.0, 100.0, 1000.0], np.float32)), one,
                                  torch.ones(4, device=dev), num_groups=2, num_bins=128)
    edge_bins = edge_hist[1].nonzero().flatten().tolist()
    assert edge_bins == [1, 32, 64, 95], edge_bins
    rule = {}
    for lo, hi, b in RULE_CHECKS:
        bad, first = hist_ops.check_bin_rule(lo, hi, b, dev)
        assert bad == 0, ("bin rule", lo, hi, b, bad, first)
        rule[(lo, hi, b)] = bad
    return cases, err, edge_bins, rule


def _attribution_fold_cases(torch, dev, rng) -> float:
    """Hold the attribution fold on the card against its plain version: a
    chunk's ``[8, 2N, Ba]`` histograms in one ``latency_histogram`` launch
    of ``8 * 2N`` = 80 groups (N 5) and a trace's per-chunk form (a launch a
    component), at Ba 64 and 96 on the attribution rule (lo 0.01, hi 1e4);
    components log-uniform over [1e-3, 1e5] ms with zeros (unpaid) and the
    decade and rule edges, 0/1 weights: exact. Returns the largest error (0)."""
    from repro_torch.kvsim.telemetry import (
        AttributionConfig,
        attribution_chunk_hist,
        attribution_trace_hist,
    )

    cases = 0
    for num_bins in (64, 96):
        acfg = AttributionConfig(num_bins=num_bins)
        for r, rows_per_chunk in ((10_000, None), (1_000_003, 10_000)):
            comps = np.exp(rng.uniform(np.log(1e-3), np.log(1e5), (8, r))).astype(np.float32)
            comps[rng.random((8, r)) < 0.4] = 0.0
            comps[:, :6] = [0.01, 0.1, 1.0, 10.0, 100.0, 10_000.0]
            group = rng.integers(0, 10, r).astype(np.int32)
            weight = (rng.random(r) < 0.95).astype(np.float32)
            cpu = [torch.from_numpy(a) for a in (comps, group, weight)]
            card = [t.to(dev) for t in cpu]
            if rows_per_chunk is None:
                got = attribution_chunk_hist(*card, acfg, 5)
                want = attribution_chunk_hist(*card, acfg, 5, histogram=_plain_histogram)
            else:
                got = attribution_trace_hist(*card, acfg, 5, rows_per_chunk=rows_per_chunk)
                with _plain_versions():
                    want = attribution_trace_hist(*card, acfg, 5, rows_per_chunk=rows_per_chunk)
            assert torch.equal(got, want), ("attribution fold", num_bins, r)
            cases += 1
    print(f"phase 2 latency_histogram attribution fold ok: {cases} cases (Ba 64 and 96, lo 0.01, "
          f"hi 1e4; a chunk in one launch of 80 groups, a 1 M-row trace in per-chunk launches a "
          f"component), exact")
    return 0.0


def _window_cases():
    """``(label, workload, seed, start, count)`` of phase 2's ``trace_window``
    cases: uniform and skewed, region weights, diurnal, read fractions 0.5
    and 1.0, one and five nodes, a window past the end of its trace, one at
    position 2**30."""
    from repro_torch.kvsim import WorkloadConfig, diurnal_workload, wan5_workload

    return [
        ("uniform read 0.5", WorkloadConfig(num_requests=1_000_003, num_keys=100_000, read_fraction=0.5),
         0, 0, 1_000_003),
        ("skewed one node", WorkloadConfig(num_requests=1_000_000, num_keys=999, num_nodes=1, skewed=True,
                                           affinity=0.3, read_fraction=0.8), 1, 7, 999_993),
        ("wan5 read 1.0", wan5_workload(num_requests=100_000_000, num_keys=1_000_000, affinity=0.8,
                                        read_fraction=1.0), 2, 10_000, 10_000),
        ("wan5 chunk", wan5_workload(num_requests=100_000_000, num_keys=1_000_000, read_fraction=0.9),
         0, 99_990_000, 10_000),
        ("diurnal past the end", diurnal_workload(num_requests=1_000_000, num_keys=50_000, affinity=0.7,
                                                  read_fraction=0.7), 3, 995_000, 10_000),
        ("diurnal at 2**30", diurnal_workload(num_requests=2**31 - 1, num_keys=1_000_000, affinity=0.8,
                                              read_fraction=0.9), 4, 2**30, 1_000_001),
    ]


def _trace_window_cases(torch, dev) -> list:
    """Hold ``trace_window`` against its plain version on the card (the
    same draws in torch ops, on the card too) on :func:`_window_cases`:
    keys, nodes and read flags exact. Returns the cases' labels."""
    from repro_torch.kernels.trace_window.ops import trace_window
    from repro_torch.kernels.trace_window.ref import trace_window_ref
    from repro_torch.kvsim.workload import generate_key_state, window_params

    labels = []
    for label, wl, seed, start, count in _window_cases():
        params = window_params(wl, seed)
        natural = generate_key_state(wl, seed, device=dev)[0]
        got = trace_window(start, count, params, natural)
        want = trace_window_ref(start, count, params, natural)
        for name, g, w in zip(("keys", "nodes", "is_read"), got, want):
            assert torch.equal(g, w), (label, name)
        labels.append(label)
    print(f"phase 2 trace_window ok: {len(labels)} cases ({'; '.join(labels)}), keys, nodes and "
          f"read flags exact")
    return labels


def _check_result(a, b, ctx: str, rtol: float = 1e-5) -> float:
    """Hold two ``SimResult``s of one trace to the engine tolerances: move
    counts (capacity evictions too) and hit rate exact, the f32 aggregates
    to ``rtol`` (1e-5; 1e-4 between a sharded run, whose ranks' partial
    sums re-associate, and a one-rank run). Returns the largest relative
    difference of the latter."""
    for f in ("replication_moves", "deletion_moves", "evictions", "capacity_evictions", "hit_rate"):
        assert getattr(a, f) == getattr(b, f), (ctx, f, getattr(a, f), getattr(b, f))
    rel = 0.0
    for f in ("throughput_ops_s", "mean_latency_ms", "node_busy_ms", "peak_occupancy_bytes"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        np.testing.assert_allclose(x, y, rtol=rtol, err_msg=f"{ctx} {f}")
        rel = max(rel, float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-30))))
    return rel


@contextlib.contextmanager
def _plain_versions():
    """Route the engine through the kernels' plain PyTorch versions (on the
    card), the yardstick for a whole run."""
    from repro_torch.kernels.ownership_sweep import ops as sweep_ops  # core/placement.py::sweep imports it per call
    from repro_torch.kernels.capacity_projection import ops as cp_ops  # core/costmodel.py imports it per call
    import repro_torch.kvsim.simulate as sim_mod
    import repro_torch.kvsim.telemetry as telemetry_mod
    from repro_torch.kernels.capacity_projection.ref import project_capacity_ref
    from repro_torch.kernels.chunk_replay.ref import chunk_replay_ref
    from repro_torch.kernels.ownership_sweep.ref import sweep_ref

    saved = (sim_mod.chunk_replay, sweep_ops.ownership_sweep, telemetry_mod.latency_histogram,
             cp_ops.capacity_projection)
    sim_mod.chunk_replay, sweep_ops.ownership_sweep = chunk_replay_ref, sweep_ref
    telemetry_mod.latency_histogram = _plain_histogram
    cp_ops.capacity_projection = project_capacity_ref
    try:
        yield
    finally:
        (sim_mod.chunk_replay, sweep_ops.ownership_sweep, telemetry_mod.latency_histogram,
         cp_ops.capacity_projection) = saved


def _profile_window(torch, trace, wl, cl, policy, run_scenario, out_dir,
                    unprofiled_chunk_ms: float, label: str = "phase 4", telemetry=None,
                    chunks: int = 50) -> dict:
    """Where a full-size Redynis chunk's time goes: ``torch.profiler`` over
    the first ``chunks`` chunks of the full-size trace against the full
    1 M-key store. Prints the device time per chunk, its share of the
    unprofiled wall time per chunk, the host launches per chunk, and the
    top kernels by device time and operations by host time. With ``trace``
    ``None`` the run is streamed (its windows drawn on the card, the same
    positions as the full trace's first chunks where the workload has no
    diurnal rotation)."""
    kw = {} if telemetry is None else dict(telemetry=telemetry)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sub_r = chunks * FULL_INTERVAL
    if trace is None:
        kw["trace_mode"] = "streamed"
        sub = None
    else:
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


def _plain_hot_gather(tokens, slot_map, hot_table):
    """``hot_gather``'s plain version with the wrapper's own gradient (the
    reference's VJP: the hits' row cotangents scatter-added into their
    slots in f32), so that a training step through the plain versions
    differs from the kernel path in the forward only. Autograd through
    ``hot_gather_ref`` itself would add a hot row's thousands of
    cotangents in bf16."""
    import torch
    from repro_torch.kernels.hot_gather import ops
    from repro_torch.kernels.hot_gather.ref import hot_gather_ref

    class PlainHotGather(torch.autograd.Function):
        @staticmethod
        def forward(ctx, tok, smap, table):
            rows, hit = hot_gather_ref(tok, smap, table)
            ctx.save_for_backward(tok, smap)
            ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
            ctx.mark_non_differentiable(hit)
            return rows, hit

        backward = ops._HotGather.backward

    return PlainHotGather.apply(tokens, slot_map, hot_table)


@contextlib.contextmanager
def _ml_plain_versions():
    """Route the ML-state path (``moe_apply``, ``embed_with_cache``, the
    expert sweep) through the kernels' plain PyTorch versions on the card.
    The router's plain version is differentiated by autograd, which holds
    the kernel's closed-form backward against it."""
    import repro_torch.core.expert_placement as ep_mod
    import repro_torch.core.hot_embedding as he_mod
    import repro_torch.models.moe as moe_mod
    from repro_torch.kernels.moe_router.ref import router_ref
    from repro_torch.kernels.ownership_sweep.ref import sweep_ref

    def plain_router(logits, *, k, group):
        return router_ref(logits, k, group)

    saved = moe_mod.moe_router, he_mod.hot_gather, ep_mod.ownership_sweep
    moe_mod.moe_router, he_mod.hot_gather, ep_mod.ownership_sweep = plain_router, _plain_hot_gather, sweep_ref
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
    table = init_params(ParamSpec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed_rep"), embed_init(1.0)), gen, dev)
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


# Phase 7's drive; phase 14 passes its own, key for key.
SERVE_DRIVE = dict(lanes=SERVE_LANES, cache=SERVE_CACHE, requests=SERVE_REQUESTS,
                   sessions=SERVE_SESSIONS, prompt_len=SERVE_PROMPT, prompt_step=1,
                   max_new=SERVE_MAX_NEW)


def _serve_engines(torch, dev, model, params, drive=SERVE_DRIVE):
    """A ``ServeEngine`` with its ``SessionRouter`` at ``drive``'s sizes
    (the router's store on the card)."""
    from repro_torch.serving import ServeEngine, SessionRouter
    from repro_torch.serving.kvcache import state_bytes

    engine = ServeEngine(model, params, num_lanes=drive["lanes"], cache_len=drive["cache"])
    router = SessionRouter(num_pods=SERVE_PODS, max_sessions=2 * drive["sessions"],
                           sweep_period=SERVE_SWEEP_PERIOD,
                           session_bytes=state_bytes(engine.state) / drive["lanes"], device=dev)
    return engine, router


def _serve_loop(engine, router, model, drive, seed: int = 0, log=print) -> float:
    """``launch/serve.py``'s loop over ``drive``'s stream, a pod failing
    half-way."""
    from repro_torch.launch.serve import serve_loop

    return serve_loop(engine, router, np.random.default_rng(seed), requests=drive["requests"],
                      sessions=drive["sessions"], pods=SERVE_PODS, prompt_len=drive["prompt_len"],
                      prompt_step=drive["prompt_step"], max_new=drive["max_new"],
                      vocab_size=model.cfg.vocab_size, fail_pod=SERVE_FAIL_POD, log=log)


def _serve_drive(torch, dev, model, params, seed: int = 0, log=print, drive=SERVE_DRIVE) -> dict:
    """``launch/serve.py``'s loop on the kernel path, at ``drive``'s sizes,
    a pod failing half-way. Each prefill and each decode step is timed on
    the host clock; both end in a readback of the sampled tokens, so the
    card is done when the clock stops."""
    engine, router = _serve_engines(torch, dev, model, params, drive)
    prefills, steps = [], []
    admit, step = engine.admit, engine.step

    def timed_admit(req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lane = admit(req)
        prefills.append((len(req.tokens), (time.perf_counter() - t0) * 1e3))
        return lane

    def timed_step():
        length = getattr(engine.state, "length", None)  # RWKV's state has none
        lengths = None if length is None else length.clone()
        t0 = time.perf_counter()
        out = step()
        if out:
            steps.append(((time.perf_counter() - t0) * 1e3, len(out), lengths))
        return out

    engine.admit, engine.step = timed_admit, timed_step
    wall = _serve_loop(engine, router, model, drive, seed, log)
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

    def __init__(self, torch, eng, plain, tol: float = LOGIT_TOL):
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
            assert diff <= tol, f"logits differ by {diff}, beyond {tol}"
            widest = float(margin[differ].max()) if bool(differ.any()) else 0.0
            assert widest <= tol, f"a greedy token differs at a top-2 margin of {widest}"
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


def _profile_calls(torch, call, calls: int = 20) -> dict:
    """Device ms and host kernel launches a call of ``call``, by
    ``torch.profiler`` over ``calls`` calls after a warm one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return dict(
        device_ms=sum(e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA)
        / 1e3 / calls,
        host_launches=sum(e.count for e in events if e.key.startswith("cudaLaunchKernel")) / calls,
    )


def _experiment_phase(torch, dev, out_dir) -> dict:
    """Phase 8: the paper's experiment grid and the policy family.

    (a) Figures 2 and 3 exactly as ``benchmarks/fig2_uniform.py`` and
        ``fig3_skewed.py`` call ``run_experiment``, on the card and through
        the port on the CPU on the same traces, every per-seed result held;
    (b) ``benchmarks/policy_matrix.py``'s head-to-head (and ``sizeaware``)
        at 1 M keys, seed 0 of every active policy held against the
        plain-version engine on the card;
    (c) ``benchmarks/capacity_sweep.py``'s budgets at 1,000 times its keys,
        and the edge-node preset under Redynis and ``costgreedy``, one
        finite budget held against the plain-version engine; then the
        ``capacity_projection`` kernel against its plain version, bit for
        bit, at the sweep's shape and on an edge-preset input, and timed.

    The kernel counters are zeroed before (a) and read after (c), before
    any plain-version run or profile. Returns the phase's record."""
    from repro_torch.kernels.capacity_projection.ops import capacity_projection
    from repro_torch.kernels.capacity_projection.ref import project_capacity_ref
    from repro_torch.kernels.chunk_replay.ops import chunk_replay
    from repro_torch.kernels.latency_histogram.ops import latency_histogram
    from repro_torch.kernels.ownership_sweep.ops import ownership_sweep
    from repro_torch.core.costmodel import project_capacity
    from repro_torch.core.ownership import ownership_fraction
    from repro_torch.kvsim import (
        ClusterConfig,
        RedynisPolicy,
        StaticPolicy,
        TelemetryConfig,
        WorkloadConfig,
        generate_trace,
        parse_policy,
        run_experiment,
        run_scenario,
        wan5_cluster,
        wan5_edge_cluster,
        wan5_workload,
    )

    rec: dict = {}
    expect = {"chunk_replay": 0, "ownership_sweep": 0, "latency_histogram": 0, "capacity_projection": 0}

    def expect_runs(policy, requests: int, interval: int, runs: int, telemetry: bool,
                    finite: bool = False) -> None:
        """The launches ``runs`` kernel-path runs of ``policy`` make; ``finite``:
        the cluster has a finite budget, projected once a due sweep."""
        chunks = -(-requests // interval)
        if policy.is_active:
            expect["chunk_replay"] += runs * chunks
            if isinstance(policy, RedynisPolicy):  # the one policy on the sweep kernel
                expect["ownership_sweep"] += runs * -(-chunks // policy.period)
            expect["capacity_projection"] += runs * finite * -(-chunks // policy.period)
        else:
            expect["chunk_replay"] += runs
            expect["latency_histogram"] += runs * telemetry

    def cached(store: dict):
        def traces(wl, seed):
            if (wl, seed) not in store:
                store[(wl, seed)] = generate_trace(wl, seed, device=dev)
            return store[(wl, seed)]
        return traces

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    for fn in (chunk_replay, ownership_sweep, latency_histogram, capacity_projection):
        fn.launches = 0

    # (a) The paper's Figures 2 and 3.
    baselines = {"local": StaticPolicy("local"), "optimized": RedynisPolicy(),
                 "remote": StaticPolicy("remote"), "replicated": StaticPolicy("replicated")}
    fig_rfs, fig_iters, fig_r = (1.0, 0.9, 0.75, 0.5), 5, 100_000
    rec["figures"] = {}
    fig_checked = 0
    for skewed in (False, True):
        kw = dict(policies=list(baselines.values()), read_fractions=fig_rfs, skewed=skewed,
                  iterations=fig_iters, num_requests=fig_r, traces=cached({}))
        t0 = time.perf_counter()
        card = run_experiment(**kw)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        cpu = run_experiment(**kw, device="cpu")
        for pol in baselines.values():
            expect_runs(pol.resolve(3), fig_r, 1000, len(fig_rfs) * fig_iters, False)
        rows = dict(zip(baselines, card["policies"].values()))
        for name, label in zip(baselines, card["policies"]):
            for rc, rp in zip(card["policies"][label], cpu["policies"][label]):
                for seed, (a, c) in enumerate(zip(rc["results"], rp["results"])):
                    _check_result(a, c, f"phase 8 fig {skewed} {name} rf {rc['read_fraction']} seed {seed}")
                    fig_checked += 1
        fig = "fig3_skewed" if skewed else "fig2_uniform"
        for i, rf in enumerate(fig_rfs):
            tput = {name: rows[name][i]["throughput"] for name in baselines}
            assert tput["local"] > tput["optimized"] > tput["remote"], (fig, rf, tput)
            print(f"phase 8 {fig} rf {rf}: " + ", ".join(
                f"{name} {rows[name][i]['throughput']:.2f} ± {rows[name][i]['ci99']:.2f} ops/s "
                f"(hit {rows[name][i]['hit_rate']:.4f})" for name in baselines))
        rec["figures"][fig] = dict(card_wall_s=card_s, rows={
            name: [dict(read_fraction=r["read_fraction"], throughput=r["throughput"], ci99=r["ci99"],
                        hit_rate=r["hit_rate"], hit_rate_ci99=r["hit_rate_ci99"],
                        mean_latency_ms=r["mean_latency_ms"]) for r in rows[name]]
            for name in baselines})
    print(f"phase 8 (a) ok: figures 2 and 3, card against the CPU port on the same traces "
          f"({fig_checked} per-seed results held); local > optimized > remote in every row")

    # (b) The policy head-to-head at full key scale.
    tcfg = TelemetryConfig()
    wl_b = WorkloadConfig(num_requests=GRID_REQUESTS, read_fraction=0.9, skewed=True,
                          num_keys=FULL_KEYS, **WAN5_WORKLOAD_KWARGS)
    traces_b = cached({})
    for seed in range(GRID_ITERATIONS):
        traces_b(wl_b, seed)
    torch.cuda.synchronize()
    matrix = {}
    for spec in MATRIX_SPECS:
        pol = parse_policy(spec)
        t0 = time.perf_counter()
        out = run_experiment(read_fractions=(0.9,), skewed=True, iterations=GRID_ITERATIONS,
                             num_requests=GRID_REQUESTS, cluster=wan5_cluster(),
                             daemon_interval=FULL_INTERVAL, policies=[pol], telemetry=tcfg,
                             traces=traces_b, num_keys=FULL_KEYS, **WAN5_WORKLOAD_KWARGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect_runs(pol.resolve(5), GRID_REQUESTS, FULL_INTERVAL, GRID_ITERATIONS, True)
        (label, (row,)), = out["policies"].items()
        assert row["trace"].hist.sum() == GRID_ITERATIONS * GRID_REQUESTS, label
        assert np.isfinite(row["p99_latency_ms"]) and row["throughput"] > 0, label
        matrix[label] = dict(spec=spec, row=row, wall_s=wall,
                             sim_requests_per_s=GRID_ITERATIONS * GRID_REQUESTS / wall)
        print(f"phase 8 matrix {label}: hit_rate {row['hit_rate']:.4f} ± {row['hit_rate_ci99']:.4f}, "
              f"mean {row['mean_latency_ms']:.3f} ms, p99 {row['p99_latency_ms']:.3f} ± "
              f"{row['p99_ci99']:.3f} ms, throughput {row['throughput']:.3f} ± {row['ci99']:.3f} ops/s; "
              f"wall {wall:.3f} s for {GRID_ITERATIONS} seeds, "
              f"{GRID_ITERATIONS * GRID_REQUESTS / wall:.0f} simulated req/s")

    # (c) Capacity at full key scale.
    wl_c = WorkloadConfig(num_requests=GRID_REQUESTS, num_keys=FULL_KEYS, skewed=True,
                          object_bytes_sigma=0.5)
    trace_c = generate_trace(wl_c, 0, device=dev)
    wl_e = wan5_workload(num_requests=GRID_REQUESTS, num_keys=FULL_KEYS, affinity=0.8,
                         object_bytes_sigma=0.5)
    trace_e = generate_trace(wl_e, 0, device=dev)
    cl_e = wan5_edge_cluster(edge_capacity_bytes=EDGE_CAPACITY_BYTES)
    chunks = -(-GRID_REQUESTS // FULL_INTERVAL)
    capacity = {}
    runs_c = [(f"{kib:g} KiB", wl_c, ClusterConfig(capacity_bytes=kib * 1024.0), trace_c, RedynisPolicy())
              for kib in CAPACITY_KIB]
    runs_c += [(f"wan5 edge {spec}", wl_e, cl_e, trace_e, parse_policy(spec))
               for spec in ("redynis", "costgreedy")]
    for label, w, c, t, pol in runs_c:
        t0 = time.perf_counter()
        res = run_scenario(w, c, pol, daemon_interval=FULL_INTERVAL, trace=t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect_runs(pol.resolve(c.num_nodes), GRID_REQUESTS, FULL_INTERVAL, 1, False,
                    finite=c.has_finite_capacity)
        capacity[label] = dict(result=res, wall_s=wall)
        print(f"phase 8 capacity {label}: hit_rate {res.hit_rate:.4f}, capacity_evictions "
              f"{res.capacity_evictions:.0f}, peak occupancy {res.peak_occupancy_bytes.max():.0f} bytes "
              f"(per node {np.round(res.peak_occupancy_bytes).astype(np.int64).tolist()}), moves "
              f"{res.replication_moves:.0f}, throughput {res.throughput_ops_s:.3f} ops/s, wall {wall:.3f} s")
    assert capacity["inf KiB"]["result"].capacity_evictions == 0
    assert all(capacity[f"{kib:g} KiB"]["result"].capacity_evictions > 0 for kib in CAPACITY_KIB[1:])
    assert capacity["wan5 edge redynis"]["result"].capacity_evictions > 0

    # The projection runs once a due sweep with a finite budget: in (c) only.
    launches = {"chunk_replay": chunk_replay.launches, "ownership_sweep": ownership_sweep.launches,
                "latency_histogram": latency_histogram.launches,
                "capacity_projection": capacity_projection.launches}
    assert launches == expect, (launches, expect)
    assert all(v > 0 for v in launches.values()), launches
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    rec["held_at_start"] = held
    print(f"phase 8 launches {json.dumps(launches)}")
    print(f"phase 8 max_memory_allocated {rec['max_memory_allocated']} bytes, "
          f"{held} of them held from earlier phases at its start")
    rec["launches"] = launches

    # The plain-version engine on the card: seed 0 of every active policy of
    # (b), and one finite budget of (c) (capacity evictions exact).
    with _plain_versions():
        for label, m in matrix.items():
            pol = parse_policy(m["spec"])
            if not pol.is_active:
                continue
            plain = run_scenario(wl_b, wan5_cluster(), pol, daemon_interval=FULL_INTERVAL,
                                 trace=traces_b(wl_b, 0), telemetry=tcfg)[0]
            m["plain_max_rel_diff"] = _check_result(m["row"]["results"][0], plain,
                                                    f"phase 8 matrix {label}")
        held_kib = CAPACITY_KIB[3]  # 64,000 KiB: the middle of the sweep
        held = f"{held_kib:g} KiB"
        plain = run_scenario(wl_c, ClusterConfig(capacity_bytes=held_kib * 1024.0), RedynisPolicy(),
                             daemon_interval=FULL_INTERVAL, trace=trace_c)
        capacity[held]["plain_max_rel_diff"] = _check_result(
            capacity[held]["result"], plain, f"phase 8 capacity {held}")
    print(f"phase 8 (b), (c) ok: seed 0 of {sum('plain_max_rel_diff' in m for m in matrix.values())} "
          f"active policies and the {held} budget match the plain-version engine "
          f"(capacity evictions {plain.capacity_evictions:.0f}, exact)")
    del traces_b

    # The projection a sweep, at the capacity run's shape (the budget of
    # the held run) and on an edge-preset input (one finite budget among
    # infinite ones), against its plain version on the same tensors; then
    # the chunk loop's launches with and without a budget.
    gen = torch.Generator(device=dev).manual_seed(1)
    inputs = {}
    for label, n, cap, sizes in ((f"{FULL_KEYS} keys x 3 nodes, {held}", 3,
                                  ClusterConfig(capacity_bytes=held_kib * 1024.0).capacity_vector(dev),
                                  trace_c.object_bytes),
                                 (f"{FULL_KEYS} keys x 5 nodes, wan5 edge", 5, cl_e.capacity_vector(dev),
                                  trace_e.object_bytes)):
        counts = torch.randint(0, 4, (FULL_KEYS, n), device=dev, generator=gen, dtype=torch.int32)
        f = ownership_fraction(counts)
        owners = f >= 1 / n
        hosts = torch.rand((FULL_KEYS, n), device=dev, generator=gen) < 0.4
        got = project_capacity(owners, hosts, f, sizes, cap)
        want = project_capacity_ref(owners, hosts, f, sizes, cap)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), f"phase 8 project_capacity {label}"
        finite = torch.isfinite(cap)
        # The budgets cut: some owned entries are admitted and some are not.
        assert bool(got[0][:, finite].any()) and bool((owners & ~got[0])[:, finite].any()), label
        assert torch.equal(got[0][:, ~finite], owners[:, ~finite]), label
        inputs[label] = (owners, hosts, f, sizes, cap)
    print(f"phase 8 project_capacity ok: kernel = plain version bit for bit ({'; '.join(inputs)})")
    owners, hosts, f, sizes, cap = next(iter(inputs.values()))
    proj = _profile_calls(torch, lambda: project_capacity(owners, hosts, f, sizes, cap))
    proj["ms"] = _device_ms(lambda: project_capacity(owners, hosts, f, sizes, cap), torch, iters=20)
    proj["plain_ms"] = _device_ms(lambda: project_capacity_ref(owners, hosts, f, sizes, cap), torch,
                                  reps=3, iters=5)
    # Owners, hosts (1 B), f (4 B) and a key's size (4 B) read once, the two
    # planes callers read written once.
    proj["bound_ms"] = (8 * FULL_KEYS * 3 + 4 * FULL_KEYS) / BW_BYTES_PER_S * 1e3
    proj["kernels_per_call"] = _kernels_per_call(torch, lambda: project_capacity(owners, hosts, f, sizes, cap),
                                                 capacity_projection)
    assert proj["kernels_per_call"]["host_launches"] == 9, proj["kernels_per_call"]  # a memset and nine kernels
    assert proj["kernels_per_call"]["counted"] == 1, proj["kernels_per_call"]
    proj["checked"] = list(inputs)
    print(f"phase 8 project_capacity ({FULL_KEYS} keys x 3 nodes): kernel {proj['ms']:.4f} ms by events "
          f"(device {proj['device_ms']:.4f} ms a sweep by the profiler), plain {proj['plain_ms']:.4f} ms, "
          f"bound {proj['bound_ms']:.4f} ms ({proj['bound_ms'] / proj['ms']:.3f} of it), "
          f"{proj['kernels_per_call']['host_launches']:.1f} kernel launches a call")
    rec["projection"] = proj
    del inputs, got, want
    rec["chunk_profile"] = {}
    for label, kib in (("no_budget", float("inf")), (f"{held_kib:g}_KiB", held_kib)):
        unprofiled = capacity[f"{kib:g} KiB"]["wall_s"] * 1e3 / chunks
        rec["chunk_profile"][label] = _profile_window(
            torch, trace_c, wl_c, ClusterConfig(capacity_bytes=kib * 1024.0), RedynisPolicy(),
            run_scenario, out_dir, unprofiled_chunk_ms=unprofiled, label=f"phase 8 capacity {label}")
    rec["matrix"] = {label: dict(
        spec=m["spec"], wall_s=m["wall_s"], sim_requests_per_s=m["sim_requests_per_s"],
        plain_max_rel_diff=m.get("plain_max_rel_diff"),
        **{k: m["row"][k] for k in ("hit_rate", "hit_rate_ci99", "mean_latency_ms", "throughput",
                                    "ci99", "p99_latency_ms", "p99_ci99", "quantiles")})
        for label, m in matrix.items()}
    rec["capacity"] = {label: dict(
        wall_s=c["wall_s"], plain_max_rel_diff=c.get("plain_max_rel_diff"),
        hit_rate=c["result"].hit_rate, capacity_evictions=c["result"].capacity_evictions,
        replication_moves=c["result"].replication_moves,
        throughput_ops_s=c["result"].throughput_ops_s,
        peak_occupancy_bytes=c["result"].peak_occupancy_bytes.tolist())
        for label, c in capacity.items()}
    del trace_c, trace_e, counts, f, owners, hosts, sizes, cap
    torch.cuda.empty_cache()
    return rec


def _check_tiers(a, b, ctx: str) -> None:
    """The routing and failure-injection counters of two ``SimResult``s
    of one trace: exact (integer counts)."""
    for f in ("router_consults", "directory_fetches", "mis_routes", "stale_consults",
              "unavailable_reads", "unavailable_writes", "failovers", "repair_moves"):
        assert getattr(a, f) == getattr(b, f), (ctx, f, getattr(a, f), getattr(b, f))


def _check_tier_series(a, b, ctx: str) -> None:
    """The per-chunk routing and failure-injection series of two
    ``SimTrace``s of one trace: exact (counts, and f32 fractions of equal
    counts)."""
    for f in ("router_consults", "directory_fetches", "mis_routes", "stale_consults",
              "stale_age_hist", "unavailable_reads", "unavailable_writes", "failovers",
              "repair_moves", "unreachable_frac", "wiped_frac", "availability"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                      err_msg=f"{ctx} {f}")


def _identical(a, b, ctx: str) -> None:
    """Two results (``SimResult`` or ``SimTrace``) bit for bit."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), (ctx, f)
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"{ctx} {f}")


def _faults_routing_phase(torch, dev, out_dir) -> dict:
    """Phase 10: the routing tier and failure injection.

    (a) ``benchmarks/directory_staleness.py`` and ``availability.py`` at
        their default sizes, each run on the card and through the port on
        the CPU on the same trace, and the benchmarks' own checks;
    (b) full width on the card: 2.5 M requests over 1 M keys, 250 chunks,
        the publish lags, a bounded cache, a region crash and a partition,
        each with its wall time, simulated requests/s and peak memory, seed
        0 of every Redynis row held against the plain-version engine, and a
        profile of each run's device time and launches a chunk.

    The kernel counters are zeroed before (a) and read after (b), before any
    plain-version run or profile. Returns the phase's record."""
    from repro_torch.kernels.chunk_replay.ops import chunk_replay
    from repro_torch.kernels.latency_histogram.ops import latency_histogram
    from repro_torch.kernels.ownership_sweep.ops import ownership_sweep
    from repro_torch.kvsim import (
        FaultConfig,
        FaultEvent,
        RedynisPolicy,
        RoutingConfig,
        StaticPolicy,
        TelemetryConfig,
        blast_radius_rows,
        diurnal_workload,
        generate_trace,
        region_outage,
        run_scenario,
        wan5_cluster,
        wan5_workload,
    )

    rec: dict = {"paper": {}, "full": {}}
    tcfg = TelemetryConfig()
    expect = {"chunk_replay": 0, "ownership_sweep": 0, "latency_histogram": 0}

    def card_run(wl, cl, pol, trace, interval, telemetry=tcfg):
        """One run on the card; every routing or fault run is a chunk loop."""
        out = run_scenario(wl, cl, pol, daemon_interval=interval, trace=trace, telemetry=telemetry)
        chunks = -(-wl.num_requests // interval)
        loop = pol.is_active or cl.routing is not None or cl.faults is not None
        expect["chunk_replay"] += chunks if loop else 1
        expect["ownership_sweep"] += chunks if isinstance(pol, RedynisPolicy) else 0
        expect["latency_histogram"] += int(not loop and telemetry is not None)
        return out

    def held(wl, cl, pol, trace, interval, ctx):
        """The run on the card held against the CPU port on the same trace."""
        a, ta = card_run(wl, cl, pol, trace, interval)
        c, tc = run_scenario(wl, cl, pol, daemon_interval=interval, trace=trace.cpu(), device="cpu",
                             telemetry=tcfg)
        _check_result(a, c, ctx)
        _check_tiers(a, c, ctx)
        _check_trace(ta, tc, ctx)
        _check_tier_series(ta, tc, ctx)
        return a, ta

    rec["held_at_start"] = torch.cuda.memory_allocated()
    wan5 = wan5_cluster()
    # (b)'s traces and runs, warmed up outside the counts and the clock.
    full = dict(num_requests=GRID_REQUESTS, num_keys=FULL_KEYS, affinity=0.8, read_fraction=0.7)
    wl_d, wl_w = diurnal_workload(**full), wan5_workload(**full)
    traces = {"diurnal": generate_trace(wl_d, 0, device=dev), "wan5": generate_trace(wl_w, 0, device=dev)}
    workloads = {"diurnal": wl_d, "wan5": wl_w}
    chunks = -(-GRID_REQUESTS // FULL_INTERVAL)
    c0, c1 = chunks // 3, chunks * 8 // 15  # chunks [83, 133) of 250

    def crash(mode="crash", scale=1):  # the outage, on a trace of chunks // scale chunks
        return region_outage(0, c0 // scale, (c1 - c0) // scale, mode=mode)

    bounded = RoutingConfig(publish_lag_chunks=8, cache_entries=100_000, decay=0.9)
    runs_b = [
        ("diurnal redynis lag 0", "diurnal", lambda s: dict(routing=RoutingConfig()), RedynisPolicy()),
        ("diurnal redynis lag 8", "diurnal", lambda s: dict(routing=RoutingConfig(publish_lag_chunks=8)),
         RedynisPolicy()),
        ("diurnal redynis lag 64", "diurnal", lambda s: dict(routing=RoutingConfig(publish_lag_chunks=64)),
         RedynisPolicy()),
        ("diurnal redynis lag 8 cache 100000", "diurnal", lambda s: dict(routing=bounded), RedynisPolicy()),
        ("diurnal remote lag 8 cache 100000", "diurnal", lambda s: dict(routing=bounded), StaticPolicy("remote")),
        ("wan5 redynis crash", "wan5", lambda s: dict(faults=crash(scale=s)), RedynisPolicy()),
        ("wan5 replicated crash", "wan5", lambda s: dict(faults=crash(scale=s)), StaticPolicy("replicated")),
        ("wan5 remote crash", "wan5", lambda s: dict(faults=crash(scale=s)), StaticPolicy("remote")),
        ("wan5 redynis partition", "wan5", lambda s: dict(faults=crash("partition", s)), RedynisPolicy()),
        ("diurnal redynis lag 8 crash home 0", "diurnal",
         lambda s: dict(faults=crash(scale=s), routing=RoutingConfig(publish_lag_chunks=8)), RedynisPolicy()),
    ]
    # The first 20 chunks of each shape.
    for _, name, cl_of, pol in runs_b[:1] + runs_b[5:6]:
        sub_r = 20 * FULL_INTERVAL
        t = traces[name]
        run_scenario(workloads[name]._replace(num_requests=sub_r), wan5._replace(**cl_of(50)), pol,
                     daemon_interval=FULL_INTERVAL, telemetry=tcfg,
                     trace=t._replace(keys=t.keys[:sub_r], nodes=t.nodes[:sub_r], is_read=t.is_read[:sub_r]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (chunk_replay, ownership_sweep, latency_histogram):
        fn.launches = 0
    paper = dict(num_requests=100_000, num_keys=1_000, affinity=0.8, read_fraction=0.7)
    interval = 200
    checks = {}
    t_a = time.perf_counter()

    # (a) directory_staleness.py: redynis against the publish lag, diurnal wan5.
    wl_s = diurnal_workload(**paper)
    trace_s = generate_trace(wl_s, 0, device=dev)
    off = card_run(wl_s, wan5, RedynisPolicy(), trace_s, interval)
    disabled = card_run(wl_s, wan5._replace(routing=RoutingConfig(enabled=False)), RedynisPolicy(),
                        trace_s, interval)
    for x, y in zip(off, disabled):
        _identical(x, y, "phase 10 routing off")
    checks["routing_off_bitexact"] = True
    lag_rows = {}
    for label, routing in (("lag 0", RoutingConfig()), ("lag 8", RoutingConfig(publish_lag_chunks=8)),
                           ("lag 64", RoutingConfig(publish_lag_chunks=64)),
                           ("lag 8 cache 50", RoutingConfig(publish_lag_chunks=8, cache_entries=50,
                                                            decay=0.9))):
        a, ta = held(wl_s, wan5._replace(routing=routing), RedynisPolicy(), trace_s, interval,
                     f"phase 10 staleness {label}")
        lag_rows[label] = dict(p99_ms=ta.quantile(0.99), p99_read_ms=ta.quantile(0.99, "read"),
                               mean_latency_ms=a.mean_latency_ms, mis_routes=a.mis_routes,
                               stale_consults=a.stale_consults, directory_fetches=a.directory_fetches,
                               router_consults=a.router_consults,
                               peak_mis_route_rate=float(ta.mis_route_rate.max()))
        r = lag_rows[label]
        print(f"phase 10 staleness {label}: p99 {r['p99_ms']:.3f} ms, read p99 {r['p99_read_ms']:.3f} ms, "
              f"mean {r['mean_latency_ms']:.4f} ms, consults {a.router_consults:.0f}, fetches "
              f"{a.directory_fetches:.0f}, stale {a.stale_consults:.0f}, mis-routes {a.mis_routes:.0f} "
              f"(peak rate {r['peak_mis_route_rate']:.4f}); card = CPU port")
    ladder = [lag_rows[f"lag {lag}"] for lag in (0, 8, 64)]
    checks["p99_read_monotone_in_lag"] = all(
        x["p99_read_ms"] <= y["p99_read_ms"] for x, y in zip(ladder, ladder[1:]))
    checks["mis_routes_monotone_in_lag"] = all(
        x["mis_routes"] <= y["mis_routes"] for x, y in zip(ladder, ladder[1:]))
    assert lag_rows["lag 0"]["mis_routes"] == 0 and lag_rows["lag 8"]["mis_routes"] > 0, lag_rows
    assert lag_rows["lag 8 cache 50"]["directory_fetches"] > 0, lag_rows
    rec["paper"]["staleness"] = lag_rows
    del trace_s

    # (a) availability.py: a region-0 crash over chunks [166, 266) of 500.
    wl_a = wan5_workload(**paper)
    trace_a = generate_trace(wl_a, 0, device=dev)
    chunks_a = -(-wl_a.num_requests // interval)
    start, length = chunks_a // 3, max(chunks_a // 5, 2)
    outage = region_outage(0, start, length)
    off = card_run(wl_a, wan5, RedynisPolicy(), trace_a, interval)
    for faults in (FaultConfig(enabled=False), FaultConfig(),
                   FaultConfig(events=(FaultEvent(target=1, start_chunk=10**6),))):
        got = card_run(wl_a, wan5._replace(faults=faults), RedynisPolicy(), trace_a, interval)
        _identical(off[0], got[0], f"phase 10 faults off {faults}")
        for f in ("hist_group", "chunk_hist", "mean_latency_ms", "moves", "occupancy_bytes"):
            np.testing.assert_array_equal(getattr(off[1], f), getattr(got[1], f), err_msg=f)
    checks["fault_off_bitexact"] = checks["all_up_equals_off"] = True
    avail_rows, blast = {}, []
    runs_a = [("redynis", outage, RedynisPolicy()), ("static:replicated", outage, StaticPolicy("replicated")),
              ("static:remote", outage, StaticPolicy("remote")),
              ("redynis partition", region_outage(0, start, length, mode="partition"), RedynisPolicy())]
    for label, faults, pol in runs_a:
        a, ta = held(wl_a, wan5._replace(faults=faults), pol, trace_a, interval,
                     f"phase 10 availability {label}")
        window = ta.availability[start:start + length]
        avail_rows[label] = dict(
            availability_min=float(ta.availability.min()), availability_outage_mean=float(window.mean()),
            p99_ms=ta.quantile(0.99), mean_latency_ms=a.mean_latency_ms, hit_rate=a.hit_rate,
            unavailable_reads=a.unavailable_reads, unavailable_writes=a.unavailable_writes,
            failovers=a.failovers, repair_moves=a.repair_moves,
            recovery_chunks=ta.recovery_chunks(start),
            peak_unreachable_frac=float(ta.unreachable_frac.max()),
            peak_wiped_frac=float(ta.wiped_frac.max()))
        if label == "redynis":
            blast = blast_radius_rows(faults, num_chunks=chunks_a, unreachable_frac=ta.unreachable_frac,
                                      wiped_frac=ta.wiped_frac)
        r = avail_rows[label]
        print(f"phase 10 availability {label}: min {r['availability_min']:.4f}, outage mean "
              f"{r['availability_outage_mean']:.4f}, p99 {r['p99_ms']:.3f} ms, mean "
              f"{r['mean_latency_ms']:.4f} ms, unavailable {a.unavailable_reads:.0f} reads / "
              f"{a.unavailable_writes:.0f} writes, failovers {a.failovers:.0f}, repairs "
              f"{a.repair_moves:.0f}, recovery {r['recovery_chunks']} chunks, peak unreachable "
              f"{r['peak_unreachable_frac']:.4f}, wiped {r['peak_wiped_frac']:.4f}; card = CPU port")
    ladder = []
    for d in sorted({max(length // 4, 1), max(length // 2, 1), length}):
        res = card_run(wl_a, wan5._replace(faults=region_outage(0, start, d)), RedynisPolicy(), trace_a,
                       interval, telemetry=None)
        ladder.append(dict(duration_chunks=d, unavailable_total=res.unavailable_reads + res.unavailable_writes))
    checks["repair_asymmetry"] = (avail_rows["redynis"]["repair_moves"] > 0
                                  and avail_rows["static:replicated"]["repair_moves"] == 0
                                  and avail_rows["static:remote"]["repair_moves"] == 0)
    checks["blast_radius_reported"] = bool(blast) and all(
        np.isfinite(r["blast_radius_unreachable"]) and np.isfinite(r["blast_radius_wiped"]) for r in blast)
    checks["unavailability_monotone_in_duration"] = all(
        x["unavailable_total"] <= y["unavailable_total"] for x, y in zip(ladder, ladder[1:]))
    print(f"phase 10 availability ladder (unavailable requests by outage chunks): "
          + ", ".join(f"{r['duration_chunks']}: {r['unavailable_total']:.0f}" for r in ladder)
          + f"; blast radius {blast}")
    print(f"phase 10 (a) checks {json.dumps(checks)}")
    assert all(checks.values()), checks
    rec["paper"].update(availability=avail_rows, ladder=ladder, blast_radius=blast, checks=checks)
    del trace_a

    print(f"phase 10 (a) took {time.perf_counter() - t_a:.1f} s")

    # (b) Full width on the card.
    t_b = time.perf_counter()
    results = {}
    for label, name, cl_of, pol in runs_b:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, tr = card_run(workloads[name], wan5._replace(**cl_of(1)), pol, traces[name], FULL_INTERVAL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        assert np.isfinite(res.throughput_ops_s) and tr.hist.sum() + res.unavailable_reads \
            + res.unavailable_writes == GRID_REQUESTS, label
        results[label] = (res, tr)
        rec["full"][label] = dict(
            wall_s=wall, sim_requests_per_s=GRID_REQUESTS / wall, max_memory_allocated=peak,
            throughput_ops_s=res.throughput_ops_s, hit_rate=res.hit_rate,
            mean_latency_ms=res.mean_latency_ms, p99_ms=tr.quantile(0.99),
            replication_moves=res.replication_moves,
            **{f: getattr(res, f) for f in ("router_consults", "directory_fetches", "mis_routes",
                                            "stale_consults", "unavailable_reads", "unavailable_writes",
                                            "failovers", "repair_moves")})
        print(f"phase 10 full {label}: wall {wall:.3f} s, {GRID_REQUESTS / wall:.0f} simulated req/s, "
              f"max_memory_allocated {peak} bytes ({peak - rec['held_at_start']} of its own); "
              f"hit_rate {res.hit_rate:.4f}, mean "
              f"{res.mean_latency_ms:.3f} ms, p99 {tr.quantile(0.99):.3f} ms, moves "
              f"{res.replication_moves:.0f}; consults {res.router_consults:.0f}, fetches "
              f"{res.directory_fetches:.0f}, mis-routes {res.mis_routes:.0f}; unavailable "
              f"{res.unavailable_reads:.0f} / {res.unavailable_writes:.0f}, failovers {res.failovers:.0f}, "
              f"repairs {res.repair_moves:.0f}")
    launches = {"chunk_replay": chunk_replay.launches, "ownership_sweep": ownership_sweep.launches,
                "latency_histogram": latency_histogram.launches}
    assert launches == expect, (launches, expect)
    print(f"phase 10 launches {json.dumps(launches)}")
    print(f"phase 10 held {rec['held_at_start']} bytes of earlier phases' tensors at its start")
    rec["launches"] = launches
    full_rows = rec["full"]
    assert full_rows["diurnal redynis lag 0"]["mis_routes"] == 0
    assert full_rows["diurnal redynis lag 64"]["mis_routes"] >= full_rows["diurnal redynis lag 8"]["mis_routes"] > 0
    assert full_rows["wan5 redynis crash"]["repair_moves"] > 0
    assert full_rows["wan5 remote crash"]["repair_moves"] == full_rows["wan5 replicated crash"]["repair_moves"] == 0

    # Seed 0 of every Redynis row against the plain-version engine on the card.
    with _plain_versions():
        for label, name, cl_of, pol in runs_b:
            if not isinstance(pol, RedynisPolicy):
                continue
            plain, ptr = run_scenario(workloads[name], wan5._replace(**cl_of(1)), pol,
                                      daemon_interval=FULL_INTERVAL, trace=traces[name], telemetry=tcfg)
            res, tr = results[label]
            _check_tiers(res, plain, f"phase 10 full {label}")
            _check_tier_series(tr, ptr, f"phase 10 full {label}")
            rel = max(_check_result(res, plain, f"phase 10 full {label}"),
                      _check_trace(tr, ptr, f"phase 10 full {label}"))
            full_rows[label]["plain_max_rel_diff"] = rel
    print(f"phase 10 (b) ok: {sum('plain_max_rel_diff' in r for r in full_rows.values())} Redynis rows "
          f"match the plain-version engine (counters, histograms and the routing and fault series exact), "
          f"max rel diff {max(r.get('plain_max_rel_diff', 0.0) for r in full_rows.values())}")

    print(f"phase 10 (b) runs and plain-version runs took {time.perf_counter() - t_b:.1f} s")
    # Where a run's time goes: its first 20 chunks, the outage scaled into
    # them, for the routing tier's three shapes (no lag, a lag and a bounded
    # cache, a region crash); reduced: 10 -> 3 rows, for the time limit.
    t_p = time.perf_counter()
    for label, name, cl_of, pol in (runs_b[0], runs_b[3], runs_b[5]):
        full_rows[label]["profile"] = _profile_window(
            torch, traces[name], workloads[name], wan5._replace(**cl_of(chunks // 20)), pol, run_scenario,
            out_dir, unprofiled_chunk_ms=full_rows[label]["wall_s"] * 1e3 / chunks,
            label=f"phase 10 {label}", telemetry=tcfg, chunks=20)
    print(f"phase 10 profiles took {time.perf_counter() - t_p:.1f} s")
    del traces, results
    torch.cuda.empty_cache()
    return rec


def _check_attribution(a, b, ctx: str, exact_vals: bool = True) -> None:
    """Hold the attribution and flight fields of two ``SimTrace``s of one
    trace: component histograms, flight records exact (integer plane, and the
    float plane of equal components added in one order); the per-chunk
    component sums to rtol 1e-6 (f64 sums rounded once, in each device's
    order)."""
    np.testing.assert_array_equal(a.attr_hist_group, b.attr_hist_group, err_msg=f"{ctx} attr_hist_group")
    np.testing.assert_array_equal(a.flight_meta, b.flight_meta, err_msg=f"{ctx} flight_meta")
    if exact_vals:
        np.testing.assert_array_equal(a.flight_vals, b.flight_vals, err_msg=f"{ctx} flight_vals")
    np.testing.assert_allclose(a.attr_chunk_sum_ms, b.attr_chunk_sum_ms, rtol=1e-6, atol=1e-9,
                               err_msg=f"{ctx} attr_chunk_sum_ms")


def _attribution_stream_phase(torch, dev, out_dir) -> dict:
    """Phase 11: cost attribution, the flight recorder and streamed traces.

    (a) ``benchmarks/latency_attribution.py`` at its defaults (wan5, 30,000
        requests, interval 1,000, contention and a 2-chunk-lag 256-entry
        router cache, 96 bins, 8 stride samples a chunk), its four policies
        and a reservoir-mode Redynis run, each on the card and through the
        CPU port: counts, histograms and flight records equal, the
        component-sum check true, the JSON-lines and Chrome-trace exports
        byte for byte;
    (b) the same configuration at 1 M keys, 2.5 M requests, interval 10,000
        (250 chunks), a 256,000-entry cache, each policy held against the
        plain-version engine; static ``remote`` and ``replicated`` with
        contention only at 100 M requests on the whole-trace path;
    (c) ``generate_trace`` on the card against the CPU port at 1 M requests
        (diurnal wan5, lognormal sizes), and Redynis at 10 M requests over
        1 M keys streamed against materialized, every result and leaf bit
        for bit, with wall time and peak memory for each.

    The kernel counters are zeroed before (a) and read after (c), before any
    plain-version run or profile. Returns the phase's record."""
    from repro_torch.kernels.chunk_replay.ops import chunk_replay
    from repro_torch.kernels.latency_histogram.ops import latency_histogram
    from repro_torch.kernels.ownership_sweep.ops import ownership_sweep
    from repro_torch.kernels.trace_window.ops import trace_window
    from repro_torch.kernels.trace_window.ref import trace_window_ref
    from repro_torch.kvsim import (
        AttributionConfig,
        FlightRecorderConfig,
        RedynisPolicy,
        RoutingConfig,
        ServiceConfig,
        TelemetryConfig,
        describe_policy,
        diurnal_workload,
        generate_trace,
        parse_policy,
        run_scenario,
        wan5_cluster,
        wan5_workload,
        write_chrome_trace,
        write_jsonl,
    )
    from repro_torch.kvsim.workload import generate_key_state, window_params

    rec: dict = {"paper": {}, "full": {}, "stream": {}}
    service = ServiceConfig(serve_bytes_per_ms=128.0, capacity_factor=2.0)
    specs = ("remote", "replicated", "redynis", "costgreedy")
    bench = dict(num_keys=1_000, read_fraction=0.9, affinity=0.8)  # benchmarks/common.py's wan5

    def attr_cfg(mode="stride"):
        return TelemetryConfig(num_bins=96, attribution=AttributionConfig(num_bins=96),
                               flight=FlightRecorderConfig(samples_per_chunk=8, mode=mode))

    expect = {"chunk_replay": 0, "ownership_sweep": 0, "latency_histogram": 0, "trace_window": 0}

    def card_run(wl, cl, pol, interval, telemetry, trace=None, trace_mode="materialized"):
        """One run on the card, its launches added to ``expect``."""
        out = run_scenario(wl, cl, pol, daemon_interval=interval, trace=trace, telemetry=telemetry,
                           trace_mode=trace_mode)
        chunks = -(-wl.num_requests // interval)
        loop = (pol.is_active or cl.routing is not None or cl.faults is not None
                or trace_mode == "streamed")
        attributed = telemetry is not None and telemetry.attribution is not None
        expect["chunk_replay"] += chunks if loop else 1
        expect["ownership_sweep"] += chunks if isinstance(pol, RedynisPolicy) else 0
        if telemetry is not None:
            expect["latency_histogram"] += (chunks if attributed else 0) if loop else 1 + 8 * attributed
        expect["trace_window"] += chunks if trace_mode == "streamed" else int(trace is None)
        return out

    rec["held_at_start"] = torch.cuda.memory_allocated()
    # Warm-ups outside the counts and the clock: a few chunks of each shape.
    warm_cl = wan5_cluster()._replace(service=service, routing=RoutingConfig(publish_lag_chunks=2,
                                                                             cache_entries=256))
    run_scenario(wan5_workload(num_requests=3_000, **bench), warm_cl, RedynisPolicy(),
                 daemon_interval=1_000, telemetry=attr_cfg())
    run_scenario(wan5_workload(num_requests=30_000, num_keys=1_000_000), wan5_cluster(), RedynisPolicy(),
                 daemon_interval=FULL_INTERVAL, telemetry=TelemetryConfig(), trace_mode="streamed")
    torch.cuda.synchronize()
    for fn in (chunk_replay, ownership_sweep, latency_histogram, trace_window):
        fn.launches = 0
    t_a = time.perf_counter()

    # (a) latency_attribution.py at its defaults, card against the CPU port.
    wl_a = wan5_workload(num_requests=30_000, **bench)
    cl_a = warm_cl
    checks, rows = {}, {}
    runs_a = [(describe_policy(parse_policy(sp).resolve(5)), parse_policy(sp), "stride") for sp in specs]
    runs_a.append(("redynis reservoir", RedynisPolicy(), "reservoir"))
    for label, pol, mode in runs_a:
        a, ta = card_run(wl_a, cl_a, pol, 1_000, attr_cfg(mode))
        c, tc = run_scenario(wl_a, cl_a, pol, daemon_interval=1_000, telemetry=attr_cfg(mode), device="cpu")
        ctx = f"phase 11 (a) {label}"
        # Attribution and the flight recorder off: the same run, bit for bit,
        # without their fields.
        off, toff = card_run(wl_a, cl_a, pol, 1_000, TelemetryConfig(num_bins=96))
        _identical(off, a, ctx + " attribution off")
        for name in toff._fields:
            if getattr(toff, name) is not None:
                np.testing.assert_array_equal(getattr(toff, name), getattr(ta, name), err_msg=ctx + name)
        _check_result(a, c, ctx)
        _check_tiers(a, c, ctx)
        _check_trace(ta, tc, ctx, load_rtol=1e-6)
        _check_attribution(ta, tc, ctx)
        attr = ta.attribution
        comp_sum = sum(v["mean_ms"] for v in attr.values())
        checks[f"component_sum_reconstructs_total/{label}"] = bool(
            abs(comp_sum - a.mean_latency_ms) <= 1e-3 * max(a.mean_latency_ms, 1.0))
        records = ta.flight_records()
        assert records == tc.flight_records(), ctx
        exports = {}
        for device, tr in (("card", ta), ("cpu", tc)):
            for name, writer in (("jsonl", write_jsonl), ("chrome", write_chrome_trace)):
                path = out_dir / f"phase11_{label.replace(' ', '_').replace(':', '_')}_{device}.{name}"
                writer(tr.flight_records(), str(path))
                exports[(device, name)] = path.read_bytes()
        checks[f"exports_equal/{label}"] = all(exports[("card", x)] == exports[("cpu", x)]
                                               for x in ("jsonl", "chrome"))
        top = max((x for x in attr if x != "service"), key=lambda x: attr[x]["mean_ms"])
        rows[label] = dict(mean_latency_ms=a.mean_latency_ms, component_sum_ms=comp_sum,
                           hit_rate=a.hit_rate, records=len(records), top_component=top,
                           **{f"{x}_ms": attr[x]["mean_ms"] for x in attr})
        print(f"phase 11 (a) {label}: mean {a.mean_latency_ms:.4f} ms, component sum {comp_sum:.4f} ms, "
              f"top {top} {attr[top]['mean_ms']:.4f} ms, detour "
              f"{attr['routing_detour']['mean_ms']:.4f} ms, fetch {attr['directory_fetch']['mean_ms']:.4f} ms, "
              f"broadcast {attr['write_broadcast']['mean_ms']:.4f} ms, {len(records)} flight records; "
              f"card = CPU port")
    print(f"phase 11 (a) checks {json.dumps(checks)}")
    assert all(checks.values()), checks
    rec["paper"] = dict(rows=rows, checks=checks, wall_s=time.perf_counter() - t_a)
    print(f"phase 11 (a) took {time.perf_counter() - t_a:.1f} s")

    # (b) Full width: 1 M keys, 2.5 M requests, 250 chunks, each policy held
    # against the plain-version engine; static policies with contention only
    # at 100 M requests on the whole-trace path.
    t_b = time.perf_counter()
    wl_b = wan5_workload(num_requests=GRID_REQUESTS, num_keys=FULL_KEYS, read_fraction=0.9, affinity=0.8)
    cl_b = wan5_cluster()._replace(service=service, routing=RoutingConfig(publish_lag_chunks=2,
                                                                          cache_entries=256_000))
    trace_b = generate_trace(wl_b, 0, device=dev)
    expect["trace_window"] += 1
    full = {}
    wl_s = wan5_workload(num_requests=FULL_REQUESTS, num_keys=FULL_KEYS, read_fraction=0.9, affinity=0.8)
    cl_s = wan5_cluster()._replace(service=service)
    runs_b = [(describe_policy(parse_policy(sp).resolve(5)), wl_b, cl_b, parse_policy(sp)) for sp in specs]
    runs_b += [(f"{sp} 100M static", wl_s, cl_s, parse_policy(sp)) for sp in ("remote", "replicated")]
    trace_s = None
    outs = {}
    for label, wl, cl, pol in runs_b:
        if wl is wl_s and trace_s is None:
            trace = trace_b = None
            torch.cuda.empty_cache()
            trace_s = generate_trace(wl_s, 0, device=dev)
            expect["trace_window"] += 1
        trace = trace_s if wl is wl_s else trace_b
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, tr = card_run(wl, cl, pol, FULL_INTERVAL, attr_cfg(), trace=trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        attr = tr.attribution
        comp_sum = sum(v["mean_ms"] for v in attr.values())
        assert abs(comp_sum - res.mean_latency_ms) <= 1e-3 * max(res.mean_latency_ms, 1.0), label
        assert tr.hist.sum() == wl.num_requests and tr.flight_meta.shape[1] == 8, label
        with _plain_versions():
            plain, ptr = run_scenario(wl, cl, pol, daemon_interval=FULL_INTERVAL, trace=trace,
                                      telemetry=attr_cfg())
        ctx = f"phase 11 (b) {label}"
        rel = max(_check_result(res, plain, ctx), _check_trace(tr, ptr, ctx, load_rtol=1e-6))
        _check_tiers(res, plain, ctx)
        _check_attribution(tr, ptr, ctx)
        full[label] = dict(wall_s=wall, sim_requests_per_s=wl.num_requests / wall, max_memory_allocated=peak,
                           mean_latency_ms=res.mean_latency_ms, component_sum_ms=comp_sum,
                           hit_rate=res.hit_rate, plain_max_rel_diff=rel,
                           **{f"{x}_ms": attr[x]["mean_ms"] for x in attr})
        print(f"phase 11 (b) {label}: wall {wall:.3f} s, {wl.num_requests / wall:.0f} simulated req/s, "
              f"max_memory_allocated {peak} bytes; mean {res.mean_latency_ms:.4f} ms = component sum "
              f"{comp_sum:.4f} ms; read_rtt {attr['read_rtt']['mean_ms']:.4f}, broadcast "
              f"{attr['write_broadcast']['mean_ms']:.4f}, contention {attr['contention_wait']['mean_ms']:.4f}, "
              f"detour {attr['routing_detour']['mean_ms']:.4f}, fetch {attr['directory_fetch']['mean_ms']:.4f} "
              f"ms; matches the plain-version engine (histograms, counts and flight records exact), "
              f"max rel diff {rel}")
        del plain, ptr
    del trace_s
    torch.cuda.empty_cache()
    rec["full"] = full
    print(f"phase 11 (b) took {time.perf_counter() - t_b:.1f} s")

    # (c) Streamed traces.
    t_c = time.perf_counter()
    wl_g = diurnal_workload(num_requests=GEN_CHECK_REQUESTS, num_keys=FULL_KEYS, affinity=0.8,
                            read_fraction=0.7, object_bytes_sigma=1.0)
    t0 = time.perf_counter()
    g_card = generate_trace(wl_g, 5, device=dev)
    torch.cuda.synchronize()
    card_gen_s = time.perf_counter() - t0
    expect["trace_window"] += 1
    t0 = time.perf_counter()
    g_cpu = generate_trace(wl_g, 5, device="cpu")
    cpu_gen_s = time.perf_counter() - t0
    for name in g_card._fields:
        assert torch.equal(getattr(g_card, name).cpu(), getattr(g_cpu, name)), ("generate_trace", name)
    del g_card, g_cpu
    print(f"phase 11 (c) generate_trace ({GEN_CHECK_REQUESTS} requests, diurnal wan5, lognormal sizes): card "
          f"{card_gen_s:.3f} s = CPU port {cpu_gen_s:.3f} s, every field exact")
    wl_r = wan5_workload(num_requests=FULL_REQUESTS, num_keys=FULL_KEYS, read_fraction=0.9)
    wl_rd = wl_r._replace(num_requests=DRIVE_REQUESTS)
    tcfg = TelemetryConfig()
    stream = {}
    results = {}
    for mode in ("materialized", "streamed"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        results[mode] = card_run(wl_rd, wan5_cluster(), RedynisPolicy(), FULL_INTERVAL, tcfg,
                                 trace_mode=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        stream[mode] = dict(wall_s=wall, sim_requests_per_s=DRIVE_REQUESTS / wall, own_peak_bytes=peak,
                            hit_rate=results[mode][0].hit_rate)
        print(f"phase 11 (c) redynis {DRIVE_REQUESTS} requests {mode}: wall {wall:.3f} s "
              f"({DRIVE_REQUESTS / wall:.0f} simulated req/s, trace generation included), "
              f"max_memory_allocated {peak} bytes of its own")
    for a, b in zip(results["materialized"], results["streamed"]):
        _identical(a, b, "phase 11 (c) streamed against materialized")
    # The materialized trace is 9 bytes a request (keys, nodes, read flags);
    # streamed, no [R] buffer exists, so its peak is lower by nearly that.
    saved = stream["materialized"]["own_peak_bytes"] - stream["streamed"]["own_peak_bytes"]
    assert saved > 8 * DRIVE_REQUESTS, stream
    print(f"phase 11 (c) streamed = materialized: every SimResult field and SimTrace leaf bit for bit; "
          f"streamed peak {stream['streamed']['own_peak_bytes']} bytes, materialized "
          f"{stream['materialized']['own_peak_bytes']} (the [R] trace: {9 * DRIVE_REQUESTS} bytes)")
    rec["stream"] = dict(runs=stream, generate_card_s=card_gen_s, generate_cpu_s=cpu_gen_s)
    launches = {"chunk_replay": chunk_replay.launches, "ownership_sweep": ownership_sweep.launches,
                "latency_histogram": latency_histogram.launches, "trace_window": trace_window.launches}
    assert launches == expect, (launches, expect)
    print(f"phase 11 launches {json.dumps(launches)}")
    rec["launches"] = launches
    print(f"phase 11 (c) took {time.perf_counter() - t_c:.1f} s")

    # trace_window at the main path's shapes: a streamed chunk's window (10,000
    # positions of the 100 M-request trace) and the whole trace in one launch.
    params = window_params(wl_r, 0)
    natural = generate_key_state(wl_r, 0, device=dev)[0]
    one = (50 * FULL_INTERVAL, FULL_INTERVAL)
    got, want = trace_window(*one, params, natural), trace_window_ref(*one, params, natural)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), "trace_window chunk"
    win_ms = _device_ms(lambda: trace_window(*one, params, natural), torch)
    win_plain = _device_ms(lambda: trace_window_ref(*one, params, natural), torch, reps=3, iters=5)
    whole_ms = _device_ms(lambda: trace_window(0, FULL_REQUESTS, params, natural), torch, reps=3, iters=3)
    win_calls = _kernels_per_call(torch, lambda: trace_window(*one, params, natural), trace_window)
    # The bound: bytes (9 written and a 4-byte natural-node read a position)
    # at 3.35 TB/s against integer operations at the card's int32 rate,
    # counted from the source for this window's draws (a cold draw only where
    # the hot coin says cold).
    cold = int((got[0] >= params.draws[1][0]).sum())  # keys at or past n_hot
    tw_ops = _trace_window_ops(FULL_INTERVAL, cold, skewed=True, diurnal=False)
    tw_bytes = FULL_INTERVAL * 13
    tw_bound = max(tw_bytes / BW_BYTES_PER_S, tw_ops / INT32_OPS_PER_S) * 1e3
    whole_cold = int((trace_window(0, FULL_REQUESTS, params, natural)[0] >= params.draws[1][0]).sum())
    trace_window.launches -= 1  # a measurement launch, not the path's
    whole_bound = max(FULL_REQUESTS * 13 / BW_BYTES_PER_S,
                      _trace_window_ops(FULL_REQUESTS, whole_cold, True, False) / INT32_OPS_PER_S) * 1e3
    print(f"phase 11 trace_window ({FULL_INTERVAL} positions): kernel {win_ms:.4f} ms, plain "
          f"{win_plain:.4f} ms, bound {tw_bound:.6f} ms ({'operations' if tw_ops / INT32_OPS_PER_S >= tw_bytes / BW_BYTES_PER_S else 'bytes'}: "
          f"{tw_ops} int32 ops, {cold} cold draws), {tw_bound / win_ms:.4f} of it; whole trace "
          f"({FULL_REQUESTS} positions, one launch) {whole_ms:.4f} ms, bound {whole_bound:.4f} ms "
          f"({whole_bound / whole_ms:.4f} of it); per call: host {win_calls['host_launches']} launches, "
          f"{win_calls['device_events']}")
    assert win_calls["host_launches"] == win_calls["counted"] == 1, win_calls
    rec["trace_window"] = dict(ms=win_ms, plain_ms=win_plain, bound_ms=tw_bound,
                               bound_by="operations" if tw_ops / INT32_OPS_PER_S >= tw_bytes / BW_BYTES_PER_S
                               else "bytes", ops=tw_ops, bytes=tw_bytes, whole_trace_ms=whole_ms,
                               whole_trace_bound_ms=whole_bound, kernels_per_call=win_calls)
    del natural, got, want

    # Launches a chunk: Redynis with telemetry, with attribution and the
    # flight recorder, and streamed, 20 chunks each in one profiler window.
    t_p = time.perf_counter()
    trace_r = generate_trace(wl_r._replace(num_requests=20 * FULL_INTERVAL), 0, device=dev)
    per_chunk_ms = stream["materialized"]["wall_s"] * 1e3 / -(-DRIVE_REQUESTS // FULL_INTERVAL)
    rec["profiles"] = {}
    for label, telemetry, trace in (("telemetry", tcfg, trace_r), ("attribution", attr_cfg(), trace_r),
                                    ("streamed", tcfg, None)):
        rec["profiles"][label] = _profile_window(
            torch, trace, wl_r, wan5_cluster(), RedynisPolicy(), run_scenario, out_dir,
            unprofiled_chunk_ms=per_chunk_ms, label=f"phase 11 {label}", telemetry=telemetry, chunks=20)
    print("phase 11 launches a chunk: " + ", ".join(
        f"{k} {v['launches_per_chunk']:.1f}" for k, v in rec["profiles"].items()))
    print(f"phase 11 profiles took {time.perf_counter() - t_p:.1f} s")
    del trace_r
    torch.cuda.empty_cache()
    return rec


def _shard_rank(jobs: list) -> list:
    """Phase 12 on one rank of a ``spmd.run_ranks`` group sharing the card:
    each job is ``("scenario", args, kwargs, chunks)`` (one timed
    ``run_scenario`` call, its kernel launches and collectives counted on
    this rank), ``("profile", args, kwargs, chunks)`` (host kernel launches
    a chunk: ``torch.profiler``'s CUDA activity over that call, its raw
    ``cudaLaunchKernel`` records counted without ``key_averages()``, which
    costs about a millisecond an operator) or ``("publish", spec)``
    (``publish_and_fill`` over the group, its inputs made on the card from a
    seed). Returns one record a job."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.chunk_replay.ops import chunk_replay
    from repro_torch.kernels.latency_histogram.ops import latency_histogram
    from repro_torch.kernels.ownership_sweep.ops import ownership_sweep
    from repro_torch.kernels.trace_window.ops import trace_window
    from repro_torch.kvsim import run_scenario

    kernels = dict(chunk_replay=chunk_replay, ownership_sweep=ownership_sweep,
                   latency_histogram=latency_histogram, trace_window=trace_window)
    all_reduce = dist.all_reduce

    def counted(*a, **kw):  # every fold of the port is one all_reduce
        counted.calls += 1
        return all_reduce(*a, **kw)

    counted.calls = 0
    dist.all_reduce = counted
    out = []
    try:
        for job in jobs:
            if job[0] == "publish":
                out.append(_publish_job(torch, job[1], dist.get_rank(), dist.group.WORLD))
                continue
            _, args, kw, chunks = job
            if job[0] == "profile":  # after the same shape's timed run: warm
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    run_scenario(*args, **kw)
                    torch.cuda.synchronize()
                launches = sum(1 for e in prof.profiler.kineto_results.events()
                               if e.name().startswith("cudaLaunchKernel"))
                out.append(dict(launches_per_chunk=launches / chunks))
                continue
            for fn in kernels.values():
                fn.launches = 0
            counted.calls = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            got = run_scenario(*args, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out.append(dict(result=got, wall_s=wall, collectives_per_chunk=counted.calls / chunks,
                            launches={name: fn.launches for name, fn in kernels.items()},
                            peak_bytes=torch.cuda.max_memory_allocated() - held))
    finally:
        dist.all_reduce = all_reduce
    return out


def _publish_inputs(torch, spec: dict):
    """``publish_and_fill``'s inputs at ``spec``'s size, made on the card
    from ``spec["seed"]`` (the same on every process): a random plan over
    ``objects`` objects on two ranks (homes alternate), its moves and the
    ``[objects, payload]`` f32 objects."""
    from repro_torch.core import PlacementPlan, plan_moves

    k, d = spec["objects"], spec["payload"]
    gen = torch.Generator(device="cuda").manual_seed(spec["seed"])
    dev = torch.device("cuda")
    home = torch.arange(k, device=dev) % 2
    owners = torch.rand((k, 2), generator=gen, device=dev) < 0.6
    owners[torch.arange(k, device=dev), home] = True
    prev = torch.rand((k, 2), generator=gen, device=dev) < 0.3
    plan = PlacementPlan(owners=owners, to_add=owners & ~prev, to_drop=prev & ~owners,
                         expired=torch.zeros(k, dtype=torch.bool, device=dev))
    # The lowest wanted ids are the hottest, so that many desired slots are
    # among the published objects (the lowest added ids).
    moves = plan_moves(plan, home, spec["slots"], spec["slots"], 4.0 * d,
                       priority=-torch.arange(k, dtype=torch.float32, device=dev))
    objects = torch.randn((k, d), generator=gen, device=dev)
    return home, moves, objects


def _publish_job(torch, spec: dict, rank: int, group) -> dict:
    """One rank's ``publish_and_fill`` over ``group`` at ``spec``'s size:
    its home shard only, a cache already holding some desired objects."""
    from repro_torch.core import ReplicaCache, publish_and_fill

    home, moves, objects = _publish_inputs(torch, spec)
    mine = (home == rank).nonzero().flatten()
    cache = _publish_cache(torch, moves, rank, spec["payload"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = publish_and_fill(ReplicaCache(*cache), moves, objects[mine].contiguous(),
                           mine.to(torch.int32), rank, group=group)
    torch.cuda.synchronize()
    return dict(ids=got.ids.cpu(), data=got.data.cpu(), wall_s=time.perf_counter() - t0)


def _publish_cache(torch, moves, rank: int, payload: int) -> tuple:
    """A rank's cache before the move: every other desired slot already
    holds its object (a stale copy, -1 elsewhere)."""
    ids = moves.slot_ids[rank].clone()
    ids[1::2] = -1
    data = torch.full((ids.shape[0], payload), -1.0, device=ids.device)
    return ids, data


def _sharded_phase(torch, dev, out_dir) -> dict:
    """Phase 12: the key-sharded engine (``run_scenario(num_shards=S)``)
    on ranks that share the card (``spmd.run_ranks``, gloo).

    (a) ``tests/test_sharded_engine.py``'s scenario (wan5, 20,000 requests,
        500 keys, contention and telemetry on, interval 1,000), Redynis and
        static ``local`` at 2 and 4 ranks, and at 501 keys on 2 ranks, held
        against the CPU port's one-rank run;
    (b) ``benchmarks/engine_throughput.py``'s trendline shape (skewed wan5,
        Redynis, streamed) at 10**7 keys and 5 x 10**5 requests (interval
        10,000) on 2 ranks, routing off, on
        (``RoutingConfig(publish_lag_chunks=8)``) and on with a bounded
        100,000-entry cache, each held against the card's one-rank run of
        the same shape; wall time, kernel launches and collectives a chunk
        and each rank's own peak memory;
    (c) ``publish_and_fill`` on 2 ranks at 10**6 objects of 64 f32, held
        against the ``group=None`` path on the card.

    Returns the phase's record; its ``launches`` are the sharded runs'
    kernel launches, summed over the ranks."""
    from repro_torch.core import ReplicaCache, publish_and_fill
    from repro_torch.kvsim import (
        RedynisPolicy,
        RoutingConfig,
        ServiceConfig,
        StaticPolicy,
        TelemetryConfig,
        WorkloadConfig,
        run_scenario,
        wan5_cluster,
        wan5_workload,
    )
    from repro_torch.spmd import run_ranks

    rec: dict = {}
    launches = dict.fromkeys(("chunk_replay", "ownership_sweep", "latency_histogram",
                              "trace_window"), 0)

    # (a) the paper-size scenario at 2 and 4 ranks
    cl_a = wan5_cluster()._replace(service=ServiceConfig(enabled=True))
    kw_a = dict(seed=3, daemon_interval=1000, telemetry=TelemetryConfig())
    cases_a = {2: [(500, "redynis"), (500, "local"), (501, "redynis"), (501, "local")],
               4: [(500, "redynis"), (500, "local")]}

    def policy_of(name):
        return RedynisPolicy() if name == "redynis" else StaticPolicy(mode=name)

    chunks_a = 20
    jobs_2, rec["a"] = [], {}
    for shards, cases in cases_a.items():
        jobs = [("scenario", (wan5_workload(num_requests=20_000, num_keys=keys), cl_a, policy_of(p)),
                 dict(kw_a, num_shards=shards), chunks_a) for keys, p in cases]
        if shards == 2:
            jobs_2 = jobs
            continue
        t0 = time.perf_counter()
        ranks = run_ranks(_shard_rank, shards, jobs, timeout=300)
        rec["a"][f"{shards}_ranks_s"] = time.perf_counter() - t0
        _check_sharded_a(ranks, cases, shards, cl_a, kw_a, policy_of, launches, rec["a"], chunks_a)

    # (b) the trendline shape at 10**7 keys, and (c), on the 2-rank launch of (a)
    wl_b = WorkloadConfig(num_requests=SHARD_REQUESTS, num_keys=SHARD_KEYS, skewed=True,
                          read_fraction=0.9, **WAN5_WORKLOAD_KWARGS)
    clusters_b = {
        "routing_off": wan5_cluster(),
        "routing_on": wan5_cluster(routing=RoutingConfig(publish_lag_chunks=8)),
        "routing_bounded": wan5_cluster(routing=RoutingConfig(publish_lag_chunks=8,
                                                              cache_entries=SHARD_CACHE)),
    }
    kw_b = dict(daemon_interval=SHARD_INTERVAL, trace_mode="streamed")
    chunks_b = -(-SHARD_REQUESTS // SHARD_INTERVAL)
    prof_chunks = 50
    wl_prof = wl_b._replace(num_requests=prof_chunks * SHARD_INTERVAL)
    jobs_b = [("scenario", (wl_b, c, RedynisPolicy()), dict(kw_b, num_shards=2), chunks_b)
              for c in clusters_b.values()]
    jobs_b += [("profile", (wl_prof, c, RedynisPolicy()), dict(kw_b, num_shards=2), prof_chunks)
               for c in clusters_b.values()]
    spec = dict(seed=12, objects=PUBLISH_OBJECTS, payload=PUBLISH_PAYLOAD, slots=PUBLISH_SLOTS)
    warm = ("scenario", (wl_b._replace(num_requests=4 * SHARD_INTERVAL), clusters_b["routing_bounded"],
                         RedynisPolicy()), dict(kw_b, num_shards=2), 4)
    t0 = time.perf_counter()
    ranks = run_ranks(_shard_rank, 2, jobs_2 + [warm] + jobs_b + [("publish", spec)], timeout=900)
    rec["two_ranks_s"] = time.perf_counter() - t0
    _check_sharded_a(ranks, cases_a[2], 2, cl_a, kw_a, policy_of, launches, rec["a"], chunks_a)
    at = len(jobs_2) + 1
    rec["b"] = {}
    for i, (label, c) in enumerate(clusters_b.items()):
        # The card's one-rank run of the same shape, after a short warm one.
        run_scenario(wl_b._replace(num_requests=4 * SHARD_INTERVAL), c, RedynisPolicy(), **kw_b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        one = run_scenario(wl_b, c, RedynisPolicy(), **kw_b)
        torch.cuda.synchronize()
        one_wall = time.perf_counter() - t1
        one_peak = torch.cuda.max_memory_allocated() - held
        runs = [r[at + i] for r in ranks]
        ctx = f"phase 12 (b) {label}"
        rel = _check_result(runs[0]["result"], one, ctx, rtol=1e-4)
        _check_tiers(runs[0]["result"], one, ctx)
        assert all(_same_result(r["result"], runs[0]["result"]) for r in runs[1:]), label
        for r in runs:
            assert r["launches"] == dict(chunk_replay=chunks_b, ownership_sweep=chunks_b,
                                         latency_histogram=0, trace_window=chunks_b), r["launches"]
            for name in launches:
                launches[name] += r["launches"][name]
        prof = [r[at + len(clusters_b) + i]["launches_per_chunk"] for r in ranks]
        res = runs[0]["result"]
        row = dict(wall_s=max(r["wall_s"] for r in runs), rank_wall_s=[r["wall_s"] for r in runs],
                   one_rank_wall_s=one_wall, launches_per_chunk=prof,
                   collectives_per_chunk=[r["collectives_per_chunk"] for r in runs],
                   rank_peak_bytes=[r["peak_bytes"] for r in runs], one_rank_peak_bytes=one_peak,
                   max_rel_diff=rel, hit_rate=res.hit_rate, mean_latency_ms=res.mean_latency_ms,
                   replication_moves=res.replication_moves, mis_routes=res.mis_routes,
                   directory_fetches=res.directory_fetches)
        rec["b"][label] = row
        print(f"phase 12 (b) {label}: 2 ranks wall {row['wall_s']:.3f} s (ranks "
              f"{row['rank_wall_s']}), one rank {one_wall:.3f} s; launches a chunk per rank "
              f"{prof}; collectives a chunk {row['collectives_per_chunk']}; peak bytes per rank "
              f"{row['rank_peak_bytes']} (one rank {one_peak}); hit rate {res.hit_rate:.6f}, "
              f"moves {res.replication_moves:.0f}, mis-routes {res.mis_routes:.0f}; "
              f"max rel diff to one rank {rel}")
    assert rec["b"]["routing_on"]["mis_routes"] > 0
    assert rec["b"]["routing_bounded"]["directory_fetches"] > rec["b"]["routing_on"]["directory_fetches"]

    # (c) publish_and_fill at 2 ranks against the group=None path
    home, moves, objects = _publish_inputs(torch, spec)
    ids_all = torch.arange(spec["objects"], dtype=torch.int32, device=dev)
    rec["c"] = dict(objects=spec["objects"], payload=spec["payload"], slots=spec["slots"],
                    rank_wall_s=[r[-1]["wall_s"] for r in ranks])
    for rank in range(2):
        cache = _publish_cache(torch, moves, rank, spec["payload"])
        want = publish_and_fill(ReplicaCache(*cache), moves, objects, ids_all, rank)
        got = ranks[rank][-1]
        assert torch.equal(got["ids"], want.ids.cpu()), rank
        assert torch.equal(got["data"].view(torch.int32), want.data.cpu().view(torch.int32)), rank
        published = (got["data"] != -1.0).all(dim=1)  # slots refreshed from the publish buffer
        assert (got["ids"] >= 0).sum() > spec["slots"] // 2 and published.sum() > 0, rank
    del home, moves, objects
    print(f"phase 12 (c) publish_and_fill: 2 ranks x {spec['slots']} slots from "
          f"{spec['objects']} objects of {spec['payload']} f32 equal the group=None path "
          f"(ids exact, data bit for bit); rank walls {rec['c']['rank_wall_s']} s")
    rec["launches"] = launches
    print(f"phase 12 launches {launches}")
    return rec


def _check_sharded_a(ranks, cases, shards, cluster, kw, policy_of, launches, rec, chunks) -> None:
    """Hold (a)'s sharded card runs (the first ``len(cases)`` jobs of every
    rank) to the CPU port's one-rank runs: counts, histograms and moves
    exact, f32 aggregates and series to rtol 1e-4."""
    from repro_torch.kvsim import run_scenario, wan5_workload

    for i, (keys, p) in enumerate(cases):
        runs = [r[i] for r in ranks]
        ctx = f"phase 12 (a) {shards} ranks {keys} keys {p}"
        res, tr = runs[0]["result"]
        assert all(_same_result(r["result"][0], res) for r in runs[1:]), ctx
        one, one_tr = run_scenario(wan5_workload(num_requests=20_000, num_keys=keys), cluster,
                                   policy_of(p), device="cpu", **kw)
        rel = _check_result(res, one, ctx, rtol=1e-4)
        _check_tiers(res, one, ctx)
        for f in ("hist_group", "chunk_hist", "hit_rate", "requests", "moves", "drops"):
            np.testing.assert_array_equal(getattr(tr, f), getattr(one_tr, f), err_msg=f"{ctx} {f}")
        for f in ("mean_latency_ms", "occupancy_bytes", "load_factor"):
            np.testing.assert_allclose(getattr(tr, f), getattr(one_tr, f), rtol=1e-4, err_msg=f"{ctx} {f}")
        # A materialized run draws its trace in one trace_window launch.
        want = dict(chunk_replay=chunks, ownership_sweep=chunks if p == "redynis" else 0,
                    latency_histogram=0, trace_window=1)
        for r in runs:
            assert r["launches"] == want, (ctx, r["launches"])
            for name in launches:
                launches[name] += r["launches"][name]
        rec[f"{shards}_{keys}_{p}"] = dict(max_rel_diff=rel, hit_rate=res.hit_rate,
                                           replication_moves=res.replication_moves,
                                           rank_wall_s=[r["wall_s"] for r in runs],
                                           collectives_per_chunk=[r["collectives_per_chunk"] for r in runs])
        print(f"{ctx}: equals the CPU port's one-rank run (histograms, counts and moves exact; "
              f"max rel diff {rel}); hit rate {res.hit_rate:.6f}, moves {res.replication_moves:.0f}, "
              f"collectives a chunk {runs[0]['collectives_per_chunk']}")


def _same_result(a, b) -> bool:
    """Two ``SimResult``s equal field by field, bit for bit."""
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


def _trace_window_ops(positions: int, cold: int, skewed: bool, diurnal: bool) -> int:
    """The fewest 32-bit instructions ``trace_window``'s source can compile
    to: a threefry block is 74 (2 key adds; 20 rounds of an add, a rotate as
    one funnel shift and an xor; 5 injections of a two- and a three-input
    add; the parity key as one three-input xor; the output xor); a draw 6
    (three remainders counted one each, a multiply, two adds), a coin 4
    (shift, or, the f32 subtract, the compare), the node 5 and the diurnal
    phase 4. A position takes the key draw, the shift draw, the coins (hot
    where skewed, stay, read) and the node; a cold position the cold draw
    too."""
    block, draw, coin = 74, 6, 4
    per = 2 * (2 * block + draw) + (3 if skewed else 2) * (block + coin) + 5 + 4 * diurnal
    return positions * per + cold * (2 * block + draw)


# ---------------------------------------------------------------------------
# Phase 13: training through Trainer.run (repro_torch.train)


def _train_grads(torch, model, params, batch, hot_ids, hot_embed):
    """``Model.loss`` and its gradient in every param leaf (tree order).
    Returns ``(loss, metrics, grads)``."""
    from repro_torch import tree as tree_lib

    loss, met = model.loss(params, batch, hot_ids=hot_ids, hot_embed=hot_embed)
    grads = torch.autograd.grad(loss, tree_lib.leaves(params))
    return float(loss.detach()), {k: v.detach() for k, v in met.items()}, grads


def _rel_l2(a, b) -> float:
    """``|a - b| / |b|`` in f64, a slice of 2**26 elements at a time (an f64
    copy of a whole embedding gradient is 3.7 GB at llava-next-34b's)."""
    a, b = a.reshape(-1), b.reshape(-1)
    num = den = 0.0
    for i in range(0, b.numel(), 1 << 26):
        x, y = a[i:i + (1 << 26)].double(), b[i:i + (1 << 26)].double()
        num += float(((x - y) ** 2).sum())
        den += float((y * y).sum())
    return num ** 0.5 / max(den ** 0.5, 1e-30)


def _train_check(torch, model, state, batch, ctx: str, log=print) -> dict:
    """One step's loss and gradients on the kernel path and through the
    kernels' plain versions (``_ml_plain_versions``) on the same state and
    batch, on the card. The router calls of the kernel pass are held
    against ``router_ref`` on their own logits to count near-tie rows (as
    phase 6 does). Bars: the loss to TRAIN_LOSS_RTOL, every leaf's
    gradient to TRAIN_GRAD_REL_L2 by relative L2. For MoE a third pass runs
    the kernel path with the gates detached: the router weights reach the
    loss through the gates and the aux term only, so its router gradient is
    the aux term's alone, and the kernel path's must differ from it by more
    than TRAIN_ROUTER_NOT_AUX (the gates' gradient reached the weights).
    The kernel pass's gradients wait on the host while the plain pass runs."""
    import repro_torch.models.moe as moe_mod
    from repro_torch import tree as tree_lib
    from repro_torch.kernels.moe_router.ref import router_ref

    hot_ids = state.expert_placement.hot_ids if state.expert_placement is not None else None
    moe = bool(model.cfg.num_experts)
    names = ["/".join(str(v) for _, v in path) for path, _ in tree_lib.leaves_with_paths(state.params)]
    kernel_router = moe_mod.moe_router
    calls = []

    def recording_router(logits, *, k, group):
        out = kernel_router(logits, k=k, group=group)
        calls.append((logits.detach(), tuple(t.detach() for t in out), k, group))
        return out

    def detached_router(logits, *, k, group):
        gates, ids, counts = kernel_router(logits, k=k, group=group)
        return gates.detach(), ids, counts

    aux_router = None
    if moe:
        moe_mod.moe_router = detached_router
        try:
            _, _, g_aux = _train_grads(torch, model, state.params, batch, hot_ids, state.hot_embed)
        finally:
            moe_mod.moe_router = kernel_router
        aux_router = g_aux[names.index("blocks/mlp/router")].clone()
        del g_aux
    moe_mod.moe_router = recording_router
    try:
        lk, mk, gk = _train_grads(torch, model, state.params, batch, hot_ids, state.hot_embed)
    finally:
        moe_mod.moe_router = kernel_router
    gk = [g.cpu() for g in gk]
    near = 0
    for i, (logits, got, k, group) in enumerate(calls):
        rows, _ = _router_near_ties(got, router_ref(logits, k, group), _plain_probs(logits),
                                    f"{ctx} router call {i}")
        near += int(rows.sum())
    calls.clear()
    torch.cuda.empty_cache()
    with _ml_plain_versions():
        lp, mp, gp = _train_grads(torch, model, state.params, batch, hot_ids, state.hot_embed)
    assert abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp), (ctx, lk, lp)
    worst, worst_name, rels = 0.0, "", {}
    for name, a, b in zip(names, gk, gp):
        a = a.to(b.device)
        assert bool(torch.isfinite(a).all()), (ctx, name)
        rels[name] = _rel_l2(a, b)
        if rels[name] >= worst:
            worst, worst_name = rels[name], name
        assert rels[name] <= TRAIN_GRAD_REL_L2, (ctx, name, rels[name])
    out = dict(loss_kernel=lk, loss_plain=lp, loss_rel_diff=abs(lk - lp) / abs(lp),
               grad_worst_rel_l2=worst, grad_worst_leaf=worst_name, near_tie_rows=near)
    if moe:
        ri = names.index("blocks/mlp/router")
        out["router_grad_rel_l2"] = rels["blocks/mlp/router"]
        out["router_grad_vs_aux_only_rel_l2"] = _rel_l2(gk[ri].to(aux_router.device), aux_router)
        assert out["router_grad_vs_aux_only_rel_l2"] > TRAIN_ROUTER_NOT_AUX, (ctx, out)
        for key in ("moe_dropped", "moe_hot_frac"):
            out[key] = (float(mk[key]), float(mp[key]))
    log(f"{ctx}: loss kernel {lk!r} plain {lp!r} (rel {out['loss_rel_diff']:.3e}); worst leaf grad "
        f"rel L2 {worst:.3e} ({worst_name}); near-tie router rows {near}"
        + (f"; router grad rel L2 {out['router_grad_rel_l2']:.3e}, against the aux term's alone "
           f"{out['router_grad_vs_aux_only_rel_l2']:.3f}" if moe else ""))
    del gk, gp
    torch.cuda.empty_cache()
    return out


def _profile_train_step(torch, step, out_dir, label: str, unprofiled_ms: float) -> dict:
    """One warm training step under ``torch.profiler``: device ms, its share
    of the unprofiled step's wall time (the busy share), host launches and
    the top device operations. CUDA activity only (CUPTI's kernel, copy and
    runtime records, no CPU operator records), read from the raw event list:
    building ``key_averages()``'s operator tree costs about a millisecond an
    operator, and a step of rwkv6-1.6b's chunk loop launches over 400,000
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_name: dict = {}
    launches = 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            entry = by_name.setdefault(name, [0, 0])
            entry[0] += 1
            entry[1] += e.duration_ns()
        elif name.startswith("cudaLaunchKernel"):
            launches += 1
    rows = sorted(((ns / 1e6, n, name) for name, (n, ns) in by_name.items()), reverse=True)
    (out_dir / f"profile_{label.replace(' ', '_')}.txt").write_text(
        "device ms\tcalls\tname\n" + "".join(f"{ms:.3f}\t{n}\t{name}\n" for ms, n, name in rows[:40]))
    total = sum(ms for ms, _, _ in rows)
    gemm = sum(ms for ms, _, name in rows
               if any(w in name.lower() for w in ("gemm", "xmma", "cutlass", "wgmma", "nvjet")))
    top = rows[:8]
    rec = dict(device_ms=total, unprofiled_ms=unprofiled_ms,
               device_busy_share=total / unprofiled_ms if total else None, matmul_ms=gemm,
               host_launches=launches, top_device=[(name[:120], ms) for ms, _, name in top])
    print(f"{label} profile (one step): device {total:.3f} ms, busy share "
          f"{rec['device_busy_share']} of the unprofiled {unprofiled_ms:.3f} ms step, matrix products "
          f"{gemm:.3f} ms, {launches} host launches")
    print(f"{label} profile top device: " + "; ".join(f"{name[:60]} {ms:.3f} ms" for ms, _, name in top))
    return rec


def _train_run_summary(label, walls_s, tokens, active, launches, steps, peak, smi, prof) -> dict:
    med = float(np.median(walls_s))
    rec = dict(steps=steps, median_step_s=med, tokens_per_s=tokens / med,
               share_of_bf16_peak=6 * active * tokens / med / BF16_OPS_PER_S,
               launches_per_step={k: v / steps for k, v in launches.items()}, launches=launches,
               peak_bytes=peak, profile=prof)
    print(f"{label}: {steps} steps, median step {med:.4f} s, {tokens / med:.1f} tokens/s, "
          f"{rec['share_of_bf16_peak']:.4f} of 989 TFLOP/s (6 x {active} active params x {tokens} "
          f"tokens), busy share {prof.get('device_busy_share')}, launches a step "
          f"{rec['launches_per_step']}, peak {peak} bytes [{smi}]")
    return rec


def _training_phase(torch, dev, out_dir) -> dict:
    """Phase 13: training through ``Trainer.run``.

    (a) deepseek-moe-16b at full width (TRAIN_LAYERS layers), remat "full",
    moe_impl "sort", TRAIN_BATCH x TRAIN_SEQ tokens a step from ``Pipeline``
    (Zipf 1.2), 4 nodes: TRAIN_STEPS steps, so that both daemons sweep at
    step TRAIN_SWEEP_PERIOD and the last steps run the hot path, then TRAIN_EINSUM_STEPS
    steps with moe_impl "einsum" on the same state. The daemons are held
    exactly against plain daemons fed the same counts and tokens. (b)
    qwen3-1.7b at full width (DENSE_LAYERS layers), DENSE_BATCH x TRAIN_SEQ
    tokens a step in 2 microbatches: steps 1 to DENSE_CKPT_STEP with a ``save_async``
    checkpoint at its last into a temporary directory, the steps up to
    DENSE_STEPS, then a fresh ``Trainer`` restores the checkpoint and replays
    them; the losses must agree to
    RESUME_RTOL. TRAIN_CHECK_STEPS of (a) and step 1 of (b) are also run
    through the kernels' plain versions (``_train_check``)."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core.expert_placement import ExpertPlacement
    from repro_torch.core.hot_embedding import HotEmbedding
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.kernels.hot_gather.ops import hot_gather
    from repro_torch.kernels.moe_router.ops import moe_router
    from repro_torch.kernels.ownership_sweep.ops import ownership_sweep
    from repro_torch.models import build
    from repro_torch.train import OptConfig, TrainConfig, Trainer

    smi = _smi()
    kernels = (moe_router, hot_gather, ownership_sweep)
    rec: dict = {"card": smi}

    def counts():
        return {fn.__name__: fn.launches for fn in kernels}

    def delta(before):
        return {k: v - before[k] for k, v in counts().items()}

    # ---- (a) deepseek-moe-16b ---------------------------------------------
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), num_layers=TRAIN_LAYERS, moe_impl="sort",
                              remat="full", sweep_period=TRAIN_SWEEP_PERIOD)
    model = build(cfg, dev)
    total_steps = TRAIN_STEPS + TRAIN_EINSUM_STEPS
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4, warmup_steps=10, total_steps=total_steps), log_every=10)
    tr = Trainer(model, tcfg, num_nodes=ML_NODES)
    state = tr.init_state(torch.Generator(device=dev).manual_seed(0))
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                               zipf_a=1.2), dev)
    tokens_a = TRAIN_BATCH * TRAIN_SEQ
    print(f"phase 13 (a) deepseek-moe-16b: {model.num_params()} params, {model.active_params()} active "
          f"a token, {TRAIN_LAYERS} layers, {tokens_a} tokens a step")
    # The plain daemons, fed what the Trainer's daemons are fed.
    dkw = dict(h=cfg.ownership_h or None, decay=cfg.traffic_decay, period=cfg.sweep_period)
    ep_plain = ExpertPlacement(cfg.num_layers, cfg.num_experts, ML_NODES, cfg.hot_expert_slots, **dkw)
    he_plain = HotEmbedding(cfg.padded_vocab, ML_NODES, cfg.hot_embed_rows, **dkw)
    fed = []

    def recorder(daemon, name):
        orig = daemon.fold

        def fold(st, a, b):
            fed.append((name, a.detach().clone(), b.clone()))
            return orig(st, a, b)

        return fold

    tr.expert_daemon.fold = recorder(tr.expert_daemon, "experts")
    tr.embed_daemon.fold = recorder(tr.embed_daemon, "embed")
    plain_ep, plain_he = ep_plain.init_state(dev), he_plain.init_state(dev)

    def check_daemons(st, step):
        nonlocal plain_ep, plain_he
        with _ml_plain_versions():
            for name, a, b in fed:
                if name == "experts":
                    plain_ep = ep_plain.fold(plain_ep, a, b)
                    if ep_plain.due(step):
                        plain_ep = ep_plain.sweep(plain_ep)
                else:
                    plain_he = he_plain.fold(plain_he, a, b)
                    if he_plain.due(step):
                        plain_he = he_plain.sweep(plain_he)
        fed.clear()
        for field in ("counts", "hot_ids", "step", "sweeps", "moved"):
            assert torch.equal(getattr(st.expert_placement, field), getattr(plain_ep, field)), (step, field)
        for field in ("counts", "hot_ids", "slot_map", "sweeps"):
            assert torch.equal(getattr(st.hot_embed, field), getattr(plain_he, field)), (step, field)

    def batch_at(step):  # the pipeline's batch of a 1-based step
        return pipe.next(pipe.seek(step - 1))[0]

    checks = {}
    walls, losses, hist_a = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    t_phase = time.perf_counter()
    before = counts()
    for step in range(1, TRAIN_STEPS + 1):
        if step in TRAIN_CHECK_STEPS:
            saved = counts()  # comparison launches are not the path's
            checks[f"a{step}"] = _train_check(torch, model, state, batch_at(step),
                                              f"phase 13 (a) check step {step}")
            for fn in kernels:
                fn.launches = saved[fn.__name__]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if step == TRAIN_STEPS:  # the last step under the profiler, after its unprofiled peers
            prof_a = _profile_train_step(torch, lambda: hist_a.append(tr.run(state, pipe, 1, log=False)),
                                         out_dir, "phase 13 (a) sort", float(np.median(walls)) * 1e3)
            state, hist = hist_a[-1]
        else:
            state, hist = tr.run(state, pipe, 1, log=False)
            walls.append(time.perf_counter() - t0)
        losses.append(hist[0]["loss"])
        check_daemons(state, step)
        if step in (1, 2, 10, TRAIN_SWEEP_PERIOD - 1, TRAIN_SWEEP_PERIOD, TRAIN_SWEEP_PERIOD + 1,
                    TRAIN_STEPS):
            print(f"phase 13 (a) step {step}: loss {hist[0]['loss']:.4f}, step {hist[0]['step_time_s']:.4f} s, "
                  f"hot_frac {hist[0]['moe_hot_frac']:.4f}, dropped {hist[0]['moe_dropped']:.4f}, "
                  f"sweeps {int(state.expert_placement.sweeps)}/{int(state.hot_embed.sweeps)}")
    launches_a = delta(before)
    peak_a = torch.cuda.max_memory_allocated()
    assert launches_a == {"moe_router": 2 * TRAIN_LAYERS * TRAIN_STEPS, "hot_gather": TRAIN_STEPS,
                          "ownership_sweep": TRAIN_STEPS // cfg.sweep_period}, launches_a
    assert int(state.expert_placement.sweeps) == int(state.hot_embed.sweeps) == TRAIN_STEPS // cfg.sweep_period
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    rec["a_sort"] = _train_run_summary("phase 13 (a) sort", walls, tokens_a, model.active_params(),
                                       launches_a, TRAIN_STEPS, peak_a, smi, prof_a)
    rec["a_sort"].update(losses=losses, wall_s=time.perf_counter() - t_phase,
                         hot_frac_last=hist[0]["moe_hot_frac"],
                         expert_hit_rate=float(tr.expert_daemon.hit_rate(state.expert_placement)),
                         embed_hit_rate=float(tr.embed_daemon.hit_rate(state.hot_embed)))
    assert hist[0]["moe_hot_frac"] > 0

    # The same state on moe_impl "einsum".
    model_e = build(dataclasses.replace(cfg, moe_impl="einsum"), dev)
    tr_e = Trainer(model_e, tcfg, num_nodes=ML_NODES)
    tr_e.expert_daemon.fold = recorder(tr_e.expert_daemon, "experts")
    tr_e.embed_daemon.fold = recorder(tr_e.embed_daemon, "embed")
    walls_e, hist_e = [], []
    torch.cuda.reset_peak_memory_stats()
    before = counts()
    for i in range(TRAIN_EINSUM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == TRAIN_EINSUM_STEPS - 1:
            prof_e = _profile_train_step(torch, lambda: hist_e.append(tr_e.run(state, pipe, 1, log=False)),
                                         out_dir, "phase 13 (a) einsum", float(np.median(walls_e)) * 1e3)
            state, hist = hist_e[-1]
        else:
            state, hist = tr_e.run(state, pipe, 1, log=False)
            walls_e.append(time.perf_counter() - t0)
        check_daemons(state, TRAIN_STEPS + i + 1)
        assert np.isfinite(hist[0]["loss"])
    launches_e = delta(before)
    sweeps_e = sum(1 for s in range(TRAIN_STEPS + 1, total_steps + 1) if s % cfg.sweep_period == 0)
    assert launches_e == {"moe_router": 2 * TRAIN_LAYERS * TRAIN_EINSUM_STEPS,
                          "hot_gather": TRAIN_EINSUM_STEPS, "ownership_sweep": sweeps_e}, launches_e
    rec["a_einsum"] = _train_run_summary("phase 13 (a) einsum", walls_e, tokens_a, model.active_params(),
                                         launches_e, TRAIN_EINSUM_STEPS, torch.cuda.max_memory_allocated(),
                                         smi, prof_e)
    rec["a_einsum"]["last_loss"] = hist[0]["loss"]
    del state, tr, tr_e, model, model_e, pipe, hist_a, hist_e
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) qwen3-1.7b at full width, checkpoint and resume ----------------
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=DENSE_LAYERS)
    model = build(cfg, dev)
    tmp = tempfile.mkdtemp(prefix="phase13_ckpt_")
    try:
        opt = OptConfig(lr=3e-4, warmup_steps=2, total_steps=DENSE_STEPS)
        tr = Trainer(model, TrainConfig(opt=opt, microbatches=2, checkpoint_dir=tmp,
                                        checkpoint_every=DENSE_CKPT_STEP, log_every=100))
        tr_free = Trainer(model, TrainConfig(opt=opt, microbatches=2, log_every=100))
        pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=DENSE_BATCH), dev)
        tokens_b = DENSE_BATCH * TRAIN_SEQ
        print(f"phase 13 (b) qwen3-1.7b: {model.num_params()} params, {cfg.num_layers} layers, "
              f"{tokens_b} tokens a step in 2 microbatches; free disk {shutil.disk_usage(tmp).free} bytes")
        state = tr.init_state(torch.Generator(device=dev).manual_seed(0))
        checks["b1"] = _train_check(torch, model, state, pipe.next(pipe.seek(0))[0], "phase 13 (b) check step 1")
        torch.cuda.reset_peak_memory_stats()
        before = counts()
        hist_b = []
        t0 = time.perf_counter()
        state, h1 = tr.run(state, pipe, DENSE_CKPT_STEP, log=False)  # saves step DENSE_CKPT_STEP (asynchronously)
        save_wait_s = time.perf_counter() - t0 - sum(h["step_time_s"] for h in h1)
        state, h2 = tr_free.run(state, pipe, DENSE_STEPS - DENSE_CKPT_STEP - 1, log=False)
        unprof_ms = float(np.median([h["step_time_s"] for h in h1[1:] + h2])) * 1e3
        prof_b = _profile_train_step(torch, lambda: hist_b.append(tr_free.run(state, pipe, 1, log=False)),
                                     out_dir, "phase 13 (b) qwen3", unprof_ms)
        state, h3 = hist_b[-1]
        uninterrupted = [h["loss"] for h in h1 + h2 + h3]
        launches_b = delta(before)
        assert launches_b == {"moe_router": 0, "hot_gather": 2 * DENSE_STEPS, "ownership_sweep": 0}, launches_b
        peak_b = torch.cuda.max_memory_allocated()
        rec["b_qwen3"] = _train_run_summary(
            "phase 13 (b) qwen3-1.7b", [h["step_time_s"] for h in h1[1:] + h2], tokens_b,
            model.active_params(), launches_b, DENSE_STEPS, peak_b, smi, prof_b)
        del state
        t0 = time.perf_counter()
        tr_back = Trainer(model, TrainConfig(opt=opt, microbatches=2, checkpoint_dir=tmp, log_every=100))
        back = tr_back.restore(torch.Generator(device=dev).manual_seed(1))
        restore_s = time.perf_counter() - t0
        assert int(back.opt.step) == DENSE_CKPT_STEP and back.data_step == DENSE_CKPT_STEP
        back, hr = tr_back.run(back, pipe, DENSE_STEPS - DENSE_CKPT_STEP, log=False)
        resumed = [h["loss"] for h in hr]
        diffs = [abs(a - b) / abs(b) for a, b in zip(resumed, uninterrupted[DENSE_CKPT_STEP:])]
        print(f"phase 13 (b) resume from step {DENSE_CKPT_STEP} (the save's wait {save_wait_s:.2f} s, "
              f"restore {restore_s:.2f} s): losses "
              f"{resumed} against uninterrupted {uninterrupted[DENSE_CKPT_STEP:]}, max rel diff "
              f"{max(diffs):.3e} (bar {RESUME_RTOL})")
        assert max(diffs) <= RESUME_RTOL, diffs
        assert all(np.isfinite(uninterrupted)), uninterrupted
        rec["b_qwen3"].update(losses=uninterrupted, resumed=resumed, resume_max_rel_diff=max(diffs),
                              restore_s=restore_s, save_wait_s=save_wait_s)
        del back, tr, tr_free, tr_back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    rec["checks"] = checks
    rec["launches"] = {k: launches_a[k] + launches_e[k] + launches_b[k] for k in launches_a}
    print(f"phase 13 launches {rec['launches']}")
    return rec


def _family_batch(torch, cfg, tokens):
    """A prefill batch for ``tokens [B, S]``: with zero patch embeddings
    (vlm) or zero frames (audio), as ``ServeEngine.admit`` passes them."""
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["patches"] = torch.zeros((tokens.shape[0], cfg.num_patches, cfg.d_model),
                                       dtype=torch.bfloat16, device=tokens.device)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((tokens.shape[0], cfg.num_frames, cfg.d_model),
                                      dtype=torch.bfloat16, device=tokens.device)
    return batch


def _family_attention_launches(cfg) -> tuple[int, int]:
    """Kernel launches of one prefill (``flash_attention``) and of one
    decode step (``flash_decode``) on the serving path."""
    from repro_torch.models.rglru import layer_kinds

    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "hybrid":
        n = layer_kinds(cfg).count("attn")
        return n, n
    if cfg.family == "audio":  # encoder; decoder self and cross attention
        return cfg.encoder_layers + 2 * cfg.num_layers, 2 * cfg.num_layers
    return cfg.num_layers, cfg.num_layers


def _near_tie_check(torch, got, want, bar: float, ctx: str) -> tuple[float, int]:
    """``got`` logits against ``want`` within ``bar``; a greedy token may
    differ only where ``want``'s top-2 margin is at most ``bar``. Returns
    the largest difference and the count of differing tokens."""
    got, want = got.float().cpu(), want.float().cpu()
    diff = float((got - want).abs().max())
    assert bool(torch.isfinite(got).all()), ctx
    assert diff <= bar, f"{ctx}: logits differ by {diff}, beyond {bar}"
    top2 = torch.topk(want, 2, dim=-1).values
    differ = got.argmax(-1) != want.argmax(-1)
    widest = float((top2[:, 0] - top2[:, 1])[differ].max()) if bool(differ.any()) else 0.0
    assert widest <= bar, f"{ctx}: a greedy token differs at a top-2 margin of {widest}"
    return diff, int(differ.sum())


def _rwkv_checks(torch, dev, cfg, model, params) -> dict:
    """(a)'s holds: the card against the CPU port at full width and
    RWKV_CPU_LAYERS layers, and at full depth the chunked form (a 96-token
    prefill) against the step form (64 tokens, then 32 teacher-forced
    decode steps)."""

    from repro_torch import tree as tree_lib
    from repro_torch.models import rwkv6
    from repro_torch.models.model import Model

    out = {}
    t0 = time.perf_counter()
    small = dataclasses.replace(cfg, num_layers=RWKV_CPU_LAYERS)
    mk, mc = Model(small, dev), Model(small, "cpu")
    pk = mk.init(torch.Generator(device=dev).manual_seed(1))
    pc = tree_lib.tree_map(lambda t: t.cpu(), pk)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (1, RWKV_CPU_PROMPT))
                            .astype(np.int32))
    lk, sk = mk.prefill(pk, {"tokens": toks.to(dev)})
    lc, sc = mc.prefill(pc, {"tokens": toks})
    worst, ties = _near_tie_check(torch, lk, lc, LOGIT_TOL, "rwkv card against CPU, prefill")
    for i in range(RWKV_CPU_STEPS):
        tok = lk.argmax(-1).to(torch.int32)
        lk, sk = mk.decode_step(pk, sk, tok)
        lc, sc = mc.decode_step(pc, sc, tok.cpu())
        d, n = _near_tie_check(torch, lk, lc, LOGIT_TOL, f"rwkv card against CPU, step {i + 1}")
        worst, ties = max(worst, d), ties + n
    state_err = max(_rel_l2(a.cpu(), b) for a, b in zip(sk, sc))
    assert state_err <= CPU_STATE_REL_L2, state_err
    out["card_vs_cpu"] = dict(layers=RWKV_CPU_LAYERS, prompt=RWKV_CPU_PROMPT, steps=RWKV_CPU_STEPS,
                              max_logit_diff=worst, near_tie_tokens=ties, state_rel_l2=state_err,
                              wall_s=time.perf_counter() - t0)
    del mk, pk, pc, sk, sc
    # Chunked against step form at full depth and width, in f32 (the
    # blocks' params and the embedded rows), so that the two orders of the
    # same recurrence are held tightly: in bf16, 24 layers of random weights
    # carry the forms' bf16 roundings to a state relative L2 of 0.08-0.11
    # (on an NVIDIA H100 80GB HBM3).
    blocks = tree_lib.tree_map(lambda t: t.float(), params["blocks"])
    prompt = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 96))
                              .astype(np.int32)).to(dev)
    h = params["embed"][prompt.long()].float()  # [1, 96, D]
    h96, s96 = rwkv6.rwkv_forward(blocks, h, cfg)
    _, st = rwkv6.rwkv_forward(blocks, h[:, :64], cfg)
    for t in range(64, 96):
        y, st = rwkv6.rwkv_decode_step(blocks, h[:, t], cfg, st)
    rels = {name: _rel_l2(getattr(st, name), getattr(s96, name)) for name in st._fields}
    rels["output"] = _rel_l2(y, h96[:, -1])
    assert max(rels.values()) <= WKV_REL_L2, rels
    out["chunked_vs_step"] = dict(rel_l2=rels)
    del blocks, h, h96, s96, st
    print(f"phase 14 rwkv6-1.6b (a) card against the CPU port ({RWKV_CPU_LAYERS} layers, full width, "
          f"{RWKV_CPU_PROMPT}-token prompt, {RWKV_CPU_STEPS} steps): max logit difference {worst} "
          f"(bar {LOGIT_TOL}), near-tie tokens {ties}, state relative L2 {state_err}; chunked (96 tokens) "
          f"against step form (64 + 32 decode steps) in f32 at full depth: relative L2 {rels} "
          f"(bar {WKV_REL_L2})")
    return out


def _ring_kernel_times(torch, dev, cfg, lanes: int) -> dict:
    """recurrentgemma-2b's attention kernels at its shapes, each with its
    bound. flash_attention over a 4,096-token prefill with the 2,048 window
    (q [1, 4096, 10, 256], k/v [1, 4096, 1, 256]) on the TMA/wgmma kernel,
    the dispatch's choice (and at its other q tile), beside the mma.sync
    kernel (by name) and SDPA with the window's mask and ``enable_gqa``;
    both kernels held to the plain version. flash_decode over ``lanes`` full
    2,048-slot rings (one kv head) at the split rule's splits (and at twice
    their length) beside masked SDPA, with its kernel launches a call."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    h, kh, dh, win, n = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.window, 4096
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)
               for sh in ((1, n, h, dh), (1, n, kh, dh), (1, n, kh, dh)))
    assert fa_ops.variant(q.dtype, dh) == "tma_wgmma"
    rows = fa_ops.q_rows(n, h, 1)
    flops, nbytes = _attention_flops_bytes(1, n, n, h, kh, dh, True, win)
    bound = max(flops / BF16_OPS_PER_S, nbytes / BW_BYTES_PER_S) * 1e3
    ms = _device_ms(lambda: fa_ops._launch(q, k, v, True, win), torch, reps=5, iters=20)
    other_ms = _device_ms(lambda: fa_ops._launch(q, k, v, True, win, "tma_wgmma", 192 - rows), torch,
                          reps=5, iters=20)
    mma_ms = _device_ms(lambda: fa_ops._launch(q, k, v, True, win, "mma_sync"), torch, reps=5, iters=20)
    plain = _device_ms(lambda: flash_attention_ref(q, k, v, causal=True, window=win), torch, reps=3, iters=3)
    pos = torch.arange(n, device=dev)
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < win)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = _device_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True), torch, reps=5, iters=20)
    want = flash_attention_ref(q, k, v, causal=True, window=win)
    err, use = _check_close(torch, fa_ops._launch(q, k, v, True, win), want, q.dtype,
                            "recurrentgemma prefill attention (tma_wgmma)")
    assert use <= 0.5, f"recurrentgemma prefill attention: {use:.3f} of the scaled bar"
    mma_err, _ = _check_close(torch, fa_ops._launch(q, k, v, True, win, "mma_sync"), want, q.dtype,
                              "recurrentgemma prefill attention (mma_sync)")
    attn = dict(ms=ms, variant="tma_wgmma", q_rows=rows, other_q_rows_ms=other_ms, mma_sync_ms=mma_ms,
                plain_ms=plain, sdpa_ms=lib, bound_ms=bound, max_abs_err=err, scaled_bar_used=use,
                mma_sync_max_abs_err=mma_err,
                bound_by="operations" if flops / BF16_OPS_PER_S >= nbytes / BW_BYTES_PER_S else "bytes",
                tflops=flops / ms / 1e9, mma_sync_tflops=flops / mma_ms / 1e9)
    del q, k, v, qt, kt, vt, mask, want
    dq = torch.randn((lanes, h, dh), generator=gen, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn((lanes, win, kh, dh), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    lens = torch.full((lanes,), win, dtype=torch.int32, device=dev)
    split = fd_ops.split_length(lanes, kh, win)
    splits = fd_ops.num_splits(lanes, kh, win)
    dms = _device_ms(lambda: flash_decode(dq, kc, vc, lens), torch)
    longer_ms = _device_ms(lambda: fd_ops._launch(dq, kc, vc, lens, 2 * split), torch)
    dplain = _device_ms(lambda: flash_decode_ref(dq, kc, vc, lens), torch, reps=3, iters=10)
    kct, vct = (x.transpose(1, 2).contiguous() for x in (kc, vc))
    dmask = torch.ones((lanes, 1, 1, win), dtype=torch.bool, device=dev)
    dlib = _device_ms(lambda: sdpa(dq[:, :, None], kct, vct, attn_mask=dmask, enable_gqa=True), torch)
    derr, duse = _check_close(torch, flash_decode(dq, kc, vc, lens), flash_decode_ref(dq, kc, vc, lens),
                              dq.dtype, "recurrentgemma ring decode")
    calls = _kernels_per_call(torch, lambda: flash_decode(dq, kc, vc, lens), flash_decode)
    assert calls["host_launches"] == 1 and calls["counted"] == 1, calls
    dbytes = lanes * win * kh * dh * 2 * 2 + 2 * lanes * h * dh * 2 + lanes * 4
    dflops = 4 * lanes * win * h * dh
    dbound = max(dbytes / BW_BYTES_PER_S, dflops / BF16_OPS_PER_S) * 1e3
    decode = dict(ms=dms, split=split, splits=splits, blocks=lanes * kh * splits, longer_split_ms=longer_ms,
                  plain_ms=dplain, sdpa_ms=dlib, bound_ms=dbound, max_abs_err=derr, scaled_bar_used=duse,
                  bound_by="bytes" if dbytes / BW_BYTES_PER_S >= dflops / BF16_OPS_PER_S else "operations",
                  gbs=dbytes / dms / 1e6, kernels_per_call=calls["host_launches"])
    print(f"phase 14 flash_attention tma_wgmma (q [1, {n}, {h}, {dh}], k/v [1, {n}, {kh}, {dh}], window {win}): "
          f"kernel {ms:.4f} ms ({attn['tflops']:.1f} TFLOP/s, {bound / ms:.3f} of the {attn['bound_by']} bound "
          f"{bound:.4f} ms, q tile {rows}; q tile {192 - rows}: {other_ms:.4f} ms); mma_sync {mma_ms:.4f} ms "
          f"({attn['mma_sync_tflops']:.1f} TFLOP/s, {bound / mma_ms:.3f}); plain {plain:.4f} ms, SDPA with the "
          f"window's mask {lib:.4f} ms")
    print(f"phase 14 flash_decode ({lanes} lanes over {win}-slot rings, {kh} kv head, D {dh}): kernel "
          f"{dms:.4f} ms ({decode['gbs']:.1f} GB/s, {dbound / dms:.3f} of the {decode['bound_by']} bound "
          f"{dbound:.4f} ms; {splits} splits of {split}, {decode['blocks']} blocks, "
          f"{calls['host_launches']:.0f} kernel a call; splits of {2 * split}: {longer_ms:.4f} ms), "
          f"plain {dplain:.4f} ms, masked SDPA {dlib:.4f} ms")
    return dict(attention=attn, decode=decode)


def _whisper_decode_times(torch, dev, cfg, lanes: int, cache: int) -> dict:
    """whisper-base's decode attention (8 q and 8 kv heads of 64: a group of
    1, the CUDA-core path) at its drive's shapes, each beside masked SDPA
    and held to the plain version: cross attention over the encoder's
    every frame, and self attention over a ``cache``-slot cache at ragged
    lengths from seed 5 (its prompts and new tokens)."""
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(5)
    lo, hi = FAMILY_DRIVES["whisper-base"]["prompt_len"]
    out = {}
    for name, t, lens in (
            ("cross", cfg.num_frames, torch.full((lanes,), cfg.num_frames, dtype=torch.int32, device=dev)),
            ("self", cache, torch.randint(lo, min(hi + FAMILY_DRIVES["whisper-base"]["max_new"], cache) + 1,
                                          (lanes,), generator=gen, device=dev, dtype=torch.int32))):
        q = torch.randn((lanes, h, dh), generator=gen, device=dev).to(torch.bfloat16)
        kc, vc = (torch.randn((lanes, t, kh, dh), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        ms = _device_ms(lambda: flash_decode(q, kc, vc, lens), torch)
        plain = _device_ms(lambda: flash_decode_ref(q, kc, vc, lens), torch, reps=3, iters=10)
        kct, vct = (x.transpose(1, 2).contiguous() for x in (kc, vc))
        mask = (torch.arange(t, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        lib = _device_ms(lambda: sdpa(q[:, :, None], kct, vct, attn_mask=mask, enable_gqa=True), torch)
        err, use = _check_close(torch, flash_decode(q, kc, vc, lens), flash_decode_ref(q, kc, vc, lens),
                                q.dtype, f"whisper {name} decode")
        valid = int(torch.clamp_max(lens, t).sum())
        nbytes = valid * kh * dh * 2 * 2 + 2 * lanes * h * dh * 2 + lanes * 4
        bound = max(nbytes / BW_BYTES_PER_S, 4 * valid * h * dh / BF16_OPS_PER_S) * 1e3
        splits = fd_ops.num_splits(lanes, kh, t)
        out[name] = dict(ms=ms, plain_ms=plain, sdpa_ms=lib, bound_ms=bound, bound_by="bytes", max_abs_err=err,
                         scaled_bar_used=use, valid=valid, slots=t, split=fd_ops.split_length(lanes, kh, t),
                         splits=splits)
        print(f"phase 14 flash_decode whisper {name} ({lanes} lanes, {t} slots, {valid} valid, {kh} kv heads of "
              f"{dh}, group {h // kh}): kernel {ms:.4f} ms ({bound / ms:.3f} of the bytes bound {bound:.4f} ms; "
              f"{splits} splits), plain {plain:.4f} ms, masked SDPA {lib:.4f} ms")
    return out


def _int8_check(torch, dev, cfg, model, params, drive) -> dict:
    """(d)'s int8 decode: from one bf16 prefill state (a 512-token prompt
    after the zero patches), INT8_STEPS steps with the bf16 params (greedy)
    and, in turns with each, one with ``quantize_tree(params)`` fed the bf16
    run's token and one more with the int8 params through the kernels'
    plain versions. Each run starts from its own clone of the state (the
    decode step writes the cache in place)."""
    from repro_torch import quant
    from repro_torch import tree as tree_lib
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref

    tol = FAMILY_LOGIT_TOL.get(cfg.name, LOGIT_TOL)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (1, drive["prompt_len"]))
                            .astype(np.int32)).to(dev)
    logits0, state0 = model.prefill(params, _family_batch(torch, cfg, toks), cache_len=drive["cache"])
    t0 = time.perf_counter()
    qparams = quant.quantize_tree(params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    bf16_bytes = sum(t.numel() * t.element_size() for t in tree_lib.leaves(params))
    int8_bytes = sum(t.numel() * t.element_size() for t in tree_lib.leaves(qparams))

    def clone(st):
        return st._replace(k=st.k.clone(), v=st.v.clone(), length=st.length.clone())

    sb, sq, sp = clone(state0), clone(state0), clone(state0)
    del state0
    tok = logits0.argmax(-1).to(torch.int32)
    bf16_ms, int8_ms, rels, plain_err, plain_ties = [], [], [], 0.0, 0
    step1 = None

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    for i in range(INT8_STEPS):
        (lb, sb), ms_b = timed(lambda: model.decode_step(params, sb, tok))
        (lq, sq), ms_q = timed(lambda: model.decode_step(qparams, sq, tok))
        with _attention_versions(flash_attention_ref, flash_decode_ref):
            lp, sp = model.decode_step(qparams, sp, tok)
        bf16_ms.append(ms_b)
        int8_ms.append(ms_q)
        diff = float((lq - lb).abs().max())
        rel = diff / float(lb.abs().max())
        rels.append(rel)
        assert rel < INT8_REL_BAR, f"int8 step {i + 1}: max|dlogits| / max|logits| = {rel}"
        if i == 0:  # the reference's bar: the same greedy token unless a near tie
            top2 = torch.topk(lb.float(), 2, dim=-1).values
            margin = float(top2[0, 0] - top2[0, 1])
            same = bool((lq.argmax(-1) == lb.argmax(-1)).all())
            assert same or margin <= 2 * diff, (margin, diff)
            step1 = dict(same_token=same, bf16_margin=margin, max_diff=diff, rel=rel)
        d, n = _near_tie_check(torch, lq, lp, tol, f"int8 kernels against plain, step {i + 1}")
        plain_err, plain_ties = max(plain_err, d), plain_ties + n
        tok = lb.argmax(-1).to(torch.int32)
    out = dict(steps=INT8_STEPS, quantize_s=quant_s, bf16_weight_bytes=bf16_bytes, int8_weight_bytes=int8_bytes,
               bf16_step_ms_median=float(np.median(bf16_ms)), int8_step_ms_median=float(np.median(int8_ms)),
               bf16_step_ms=bf16_ms, int8_step_ms=int8_ms, rel_max=max(rels), step1=step1,
               int8_kernel_vs_plain_max_diff=plain_err, int8_kernel_vs_plain_near_ties=plain_ties)
    print(f"phase 14 llava-next-34b int8: quantize_tree {quant_s:.2f} s; weights {bf16_bytes} bytes in bf16, "
          f"{int8_bytes} in int8 ({int8_bytes / bf16_bytes:.4f}); decode step median bf16 "
          f"{out['bf16_step_ms_median']:.3f} ms, int8 {out['int8_step_ms_median']:.3f} ms "
          f"({out['int8_step_ms_median'] / out['bf16_step_ms_median']:.3f} x); step 1 {step1}; "
          f"max|dlogits|/max|logits| over {INT8_STEPS} steps {max(rels):.4f} (bar {INT8_REL_BAR}); "
          f"int8 kernels against plain versions: max logit difference {plain_err} (bar {tol}), "
          f"near-tie tokens {plain_ties}")
    del qparams, sb, sq, sp
    return out


def _families_phase(torch, dev, out_dir) -> dict:
    """Phase 14: every family of the serving slice through ``ServeEngine``
    behind ``SessionRouter`` (FAMILY_DRIVES), each on the kernel path alone
    first (launches counted and asserted; prefill latency by prompt length,
    decode-step times, one profiled decode step, peak memory, the router's
    stats), then held: rwkv6-1.6b against the CPU port and its chunked form
    against its step form (``_rwkv_checks``); the others in lockstep with a
    teacher-forced plain-version engine, their attention against the plain
    versions in every layer of every prefill and every SERVE_CHECK_EVERY-th
    decode step; llava-next-34b's int8 decode (``_int8_check``)."""

    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.ownership_sweep.ops import ownership_sweep
    from repro_torch.models.model import Model

    kernels = (flash_attention, flash_decode, ownership_sweep)
    smi = _smi()
    rec: dict = {"card": smi, "families": {}}
    launches = dict.fromkeys((fn.__name__ for fn in kernels), 0)
    variants = dict.fromkeys(fa_ops.VARIANTS, 0)
    errs = dict(flash_attention=0.0, flash_decode=0.0)
    for arch, drive in FAMILY_DRIVES.items():
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        if arch in FAMILY_LAYERS:
            cfg = dataclasses.replace(cfg, num_layers=FAMILY_LAYERS[arch])
        model = Model(cfg, dev)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        pbytes = sum(t.numel() * t.element_size() for t in tree_lib.leaves(params))
        print(f"phase 14 {arch} ({cfg.family}, {cfg.num_layers} layers): {model.num_params()} parameters "
              f"({pbytes} bytes), initialised in {time.perf_counter() - t0:.2f} s")
        # Warm-up outside the counts: one prefill and one decode step.
        lo = drive["prompt_len"] if isinstance(drive["prompt_len"], int) else drive["prompt_len"][0]
        wtok = torch.randint(0, cfg.vocab_size, (1, lo), device=dev, dtype=torch.int32)
        model.prefill(params, _family_batch(torch, cfg, wtok), cache_len=drive["cache"])
        warm = model.init_state(drive["lanes"], max(drive["cache"], 1))
        model.decode_step(params, warm, torch.zeros(drive["lanes"], dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        del warm
        for fn in kernels:
            fn.launches = 0
        flash_attention.launches_by_variant = dict.fromkeys(fa_ops.VARIANTS, 0)
        torch.cuda.reset_peak_memory_stats()
        run = _serve_drive(torch, dev, model, params, drive=drive, log=lambda m: print(f"phase 14 {arch} {m}"))
        got = {fn.__name__: fn.launches for fn in kernels}
        var = dict(flash_attention.launches_by_variant)
        peak = torch.cuda.max_memory_allocated()
        eng, router = run["engine"], run["router"]
        n_prefill, n_steps = len(run["prefills"]), eng.steps
        sweeps = router.tick_count // router.daemon.period
        per_prefill, per_step = _family_attention_launches(cfg)
        want = {"flash_attention": per_prefill * n_prefill, "flash_decode": per_step * n_steps,
                "ownership_sweep": sweeps}
        assert got == want, (arch, got, want)
        kind = fa_ops.variant(torch.bfloat16, cfg.resolved_head_dim)
        assert var == {v: (want["flash_attention"] if v == kind else 0) for v in fa_ops.VARIANTS}, (arch, var)
        assert router.stats["elections"] == 1 and router.leader != SERVE_FAIL_POD, router.stats
        outs = [o for o in eng.outputs.values() if o]
        assert outs and all(0 <= t < cfg.vocab_size for o in outs for t in o)
        for name in launches:
            launches[name] += got[name]
        for name in variants:
            variants[name] += var[name]
        step_ms = np.asarray([m for m, _, _ in run["steps"]])
        decode_tokens = sum(n for _, n, _ in run["steps"])
        fam = dict(family=cfg.family, layers=cfg.num_layers, params=model.num_params(), param_bytes=pbytes,
                   drive=drive, wall_s=run["wall_s"], tokens_out=eng.tokens_out,
                   tokens_per_s=eng.tokens_out / run["wall_s"], prefills=run["prefills"],
                   decode_steps=n_steps, decode_step_ms_median=float(np.median(step_ms)),
                   decode_step_ms_min=float(step_ms.min()), decode_step_ms_max=float(step_ms.max()),
                   decode_tokens_per_s=decode_tokens / (step_ms.sum() / 1e3), peak_bytes=peak,
                   state_bytes=eng.cache_bytes(), router=dict(router.stats), hit_rate=router.hit_rate(),
                   leader=router.leader, sweeps=sweeps, launches=got, attention_launches_by_variant=var)
        print(f"phase 14 {arch} serve: {eng.tokens_out} tokens in {run['wall_s']:.3f} s "
              f"({fam['tokens_per_s']:.1f} tok/s end to end); {n_prefill} prefills; {n_steps} decode steps, "
              f"median {fam['decode_step_ms_median']:.3f} ms (min {fam['decode_step_ms_min']:.3f}, max "
              f"{fam['decode_step_ms_max']:.3f}), {fam['decode_tokens_per_s']:.1f} decode tok/s; peak device "
              f"memory {peak} bytes (decode state {fam['state_bytes']})")
        print(f"phase 14 {arch} prefill ms by prompt length: " + ", ".join(
            f"{n}:{m:.2f}" for n, m in sorted(run["prefills"])))
        print(f"phase 14 {arch} router: hit_rate {router.hit_rate():.4f}, migrations "
              f"{router.stats['migrations']}, migrated {router.stats['migrated_bytes']:.0f} bytes, elections "
              f"{router.stats['elections']}, leader {router.leader}, sweeps {sweeps}; launches {got}; "
              f"flash_attention by variant {var}")
        fam["decode_profile"] = _profile_steps(
            torch, lambda: model.decode_step(params, eng.state, eng.last_token), 3, out_dir,
            f"phase 14 {arch} decode", unprofiled_ms=fam["decode_step_ms_median"])
        del eng, router, run
        gc.collect()
        torch.cuda.empty_cache()

        if cfg.family == "ssm":
            fam["checks"] = _rwkv_checks(torch, dev, cfg, model, params)
        else:
            t0 = time.perf_counter()
            keng, krouter = _serve_engines(torch, dev, model, params, drive)
            peng, _ = _serve_engines(torch, dev, model, params, drive)
            tol = FAMILY_LOGIT_TOL.get(arch, LOGIT_TOL)
            lock = _Lockstep(torch, keng, peng, tol)
            _serve_loop(lock, krouter, model, drive, log=lambda m: None)
            st = lock.stats
            assert st["attn_checks"] == per_prefill * n_prefill and keng.steps == n_steps, (st, keng.steps)
            assert st["decode_checks"] == per_step * len(range(0, n_steps, SERVE_CHECK_EVERY)), st
            assert keng.outputs == peng.outputs and dict(krouter.stats) == fam["router"]
            errs["flash_attention"] = max(errs["flash_attention"], st["attn_err"])
            errs["flash_decode"] = max(errs["flash_decode"], st["decode_err"])
            fam["check"] = {k: v for k, v in st.items() if k != "check_decode"}
            fam["check"]["wall_s"] = time.perf_counter() - t0
            print(f"phase 14 {arch} ok: kernels against plain versions in every layer of {n_prefill} prefills "
                  f"(max_abs_err {st['attn_err']}, scaled bar used {st['attn_bar_use']:.4f}) and of "
                  f"{st['decode_checks'] // max(per_step, 1)} decode steps (max_abs_err {st['decode_err']}, "
                  f"scaled bar used {st['decode_bar_use']:.4f}); teacher-forced plain engine over "
                  f"{st['samples']} sampling calls: max logit difference {st['logit_err']} (bar {tol}), "
                  f"near-tie tokens {st['near_ties']} (widest top-2 margin {st['widest_tie']}) "
                  f"({fam['check']['wall_s']:.1f} s)")
            del lock, keng, krouter, peng
            gc.collect()
            torch.cuda.empty_cache()
        if cfg.family == "audio":
            fam["kernels"] = rec["whisper_decode"] = _whisper_decode_times(torch, dev, cfg, drive["lanes"],
                                                                          drive["cache"])
        if cfg.family == "hybrid":
            fam["kernels"] = _ring_kernel_times(torch, dev, cfg, drive["lanes"])
            rec["ring_kernels"] = fam["kernels"]
        if cfg.family == "vlm":
            fam["int8"] = _int8_check(torch, dev, cfg, model, params, drive)
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        fam["phase_s"] = time.perf_counter() - t_arch
        print(f"phase 14 {arch} took {fam['phase_s']:.1f} s; {torch.cuda.memory_allocated()} bytes still allocated")
        rec["families"][arch] = fam
    rec["launches"] = launches
    rec["variants"] = variants
    rec["errors"] = errs
    print(f"phase 14 launches {launches}; flash_attention by variant {variants}")
    return rec


# ---------------------------------------------------------------------------
# Phase 15: the ssm, hybrid, audio and vlm families in training


def _family_step_check(torch, tr, state, batch, step, ctx: str) -> dict:
    """The main path's first step held against the kernels' plain versions:
    ``Model.loss`` and its gradients through the plain versions
    (``_ml_plain_versions``) on the step's params, state and batch first,
    then ``step()`` itself on the kernel path with the gradients that it
    feeds AdamW captured (``Trainer._grads``; the update reads them and
    writes the params in place). Bars: phase 13's (the loss to
    TRAIN_LOSS_RTOL, every leaf's gradient to TRAIN_GRAD_REL_L2 relative
    L2) and ``tests/test_arch_smoke.py``'s (finite loss and gradients, a
    positive gradient total, ``embed``'s nonzero). Returns ``(check
    record, step()'s result)``; the record's ``step_wall_s`` is ``step()``'s
    wall time alone."""
    from repro_torch import tree as tree_lib

    names = ["/".join(str(v) for _, v in path) for path, _ in tree_lib.leaves_with_paths(state.params)]
    with _ml_plain_versions():
        lp, _, gp = _train_grads(torch, tr.model, state.params, batch, None, state.hot_embed)
    gp = [g.cpu() for g in gp]  # they wait on the host while the step runs
    torch.cuda.empty_cache()
    captured = {}
    kernel_grads = tr._grads

    def capture(*args):
        grads, metrics = kernel_grads(*args)
        captured.update(grads=grads, loss=float(metrics["loss"]))
        return grads, metrics

    tr._grads = capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        result = step()
        torch.cuda.synchronize()
    finally:
        del tr._grads  # the class's method again
    wall = time.perf_counter() - t0
    lk, gk = captured["loss"], captured["grads"]
    assert np.isfinite(lk) and abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp), (ctx, lk, lp)
    worst, worst_name, abs_sums = 0.0, "", {}
    for name, a, b in zip(names, gk, gp):
        assert bool(torch.isfinite(a).all()), (ctx, name)
        abs_sums[name] = float(a.abs().sum(dtype=torch.float32))
        rel = _rel_l2(a, b.to(a.device))
        if rel >= worst:
            worst, worst_name = rel, name
        assert rel <= TRAIN_GRAD_REL_L2, (ctx, name, rel)
    grad_total, embed_abs = sum(abs_sums.values()), abs_sums["embed"]
    assert grad_total > 0 and embed_abs > 0, (ctx, grad_total, embed_abs)
    out = dict(loss_kernel=lk, loss_plain=lp, loss_rel_diff=abs(lk - lp) / abs(lp), grad_worst_rel_l2=worst,
               grad_worst_leaf=worst_name, grad_abs_total=grad_total, embed_grad_abs_total=embed_abs,
               step_wall_s=wall)
    print(f"{ctx}: loss kernel {lk!r} plain {lp!r} (rel {out['loss_rel_diff']:.3e}); worst leaf grad rel L2 "
          f"{worst:.3e} ({worst_name}); gradient |total| {grad_total:.6g}, embed's {embed_abs:.6g}")
    del gk, gp, captured
    return out, result


def _family_training_phase(torch, dev, out_dir) -> dict:
    """Phase 15: the four families of the serving slice in training, each at
    full width (FAMILY_TRAIN; rwkv6-1.6b at 6 of its 24 layers). rwkv6-1.6b
    and recurrentgemma-2b train through
    ``Trainer.run`` on ``Pipeline`` batches (Zipf 1.2) of the train_4k cell's
    4,096 tokens, the hot-row embedding daemon folding every step and
    sweeping every ``sweep`` steps; its state is held after every step
    exactly against a plain daemon fed the same tokens. whisper-base and llava-next-34b train
    through ``Trainer.step`` on a ``make_batch`` batch of the train_4k cell
    (whisper: 1,500 frames and 4,096 tokens a row; llava: 2,880 patch rows and
    1,216 token rows) from the same state; llava's hot-row cache first folds
    the batch's tokens and sweeps once, so that its rows hit. Every family's
    step is held against the kernels' plain versions on its params and batch
    (``_family_step_check``: phase 13's bars and ``tests/test_arch_smoke.py``'s).
    The phase asserts its launches:
    ``hot_gather`` once a step where the config has a hot-row cache (the
    loss's embedding; its gradient is the wrapper's scatter, no launch), and
    no ``ownership_sweep``: the hot-row daemon's sweep is plain ops in both
    packages, and none of these families has experts."""

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.hot_embedding import HotEmbedding
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.kernels.hot_gather.ops import hot_gather
    from repro_torch.kernels.ownership_sweep.ops import ownership_sweep
    from repro_torch.kvsim import prng
    from repro_torch.models import build
    from repro_torch.train import OptConfig, TrainConfig, Trainer

    smi = _smi()
    kernels = (hot_gather, ownership_sweep)
    rec: dict = {"card": smi, "families": {}}
    launches = dict.fromkeys((fn.__name__ for fn in kernels), 0)
    for arch, drive in FAMILY_TRAIN.items():
        t_arch = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), sweep_period=drive.get("sweep", 50),
                                  num_layers=drive.get("layers", get_config(arch).num_layers))
        model = build(cfg, dev)
        steps, b = drive["steps"], drive["batch"]
        tcfg = TrainConfig(opt=OptConfig(lr=3e-5, warmup_steps=2, total_steps=steps), log_every=100)
        tr = Trainer(model, tcfg)
        state = tr.init_state(torch.Generator(device=dev).manual_seed(0))
        if drive["run"]:
            pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=SHAPES["train_4k"].seq_len,
                                       global_batch=b, zipf_a=1.2), dev)
            first = pipe.next(pipe.seek(0))[0]
        else:
            shape = dataclasses.replace(SHAPES["train_4k"], global_batch=b)
            first = model.make_batch(shape, prng.prng_key(0))
            if cfg.hot_embed_rows:
                state = state._replace(hot_embed=tr.embed_daemon.sweep(tr.embed_daemon.fold(
                    state.hot_embed, first["tokens"], tr._token_nodes(b))))
        positions = first["tokens"].numel() + (first["patches"].shape[0] * first["patches"].shape[1]
                                               if "patches" in first else 0)
        print(f"phase 15 {arch} ({cfg.family}, {cfg.num_layers} layers, remat {cfg.remat}): "
              f"{model.num_params()} params, batch {({k: tuple(v.shape) for k, v in first.items()})}, "
              f"{positions} decoder positions a step [{smi}]")
        daemon = None
        if drive["run"]:  # the plain daemon, fed what the Trainer's daemon is fed
            daemon = HotEmbedding(cfg.padded_vocab, 1, cfg.hot_embed_rows, h=cfg.ownership_h or None,
                                  decay=cfg.traffic_decay, period=cfg.sweep_period)
            plain = daemon.init_state(dev)
            fed = []
            orig_fold = tr.embed_daemon.fold

            def fold(st, toks, nodes, _orig=orig_fold, _fed=fed):
                _fed.append((toks.clone(), nodes.clone()))
                return _orig(st, toks, nodes)

            tr.embed_daemon.fold = fold

        def one(st):
            if drive["run"]:
                return tr.run(st, pipe, 1, log=False)
            p, o, met = tr.step(st.params, st.opt, first, None, st.hot_embed)
            return st._replace(params=p, opt=o), [{"loss": float(met["loss"])}]

        walls, losses, prof_out = [], [], []
        for fn in kernels:
            fn.launches = 0
        for step in range(1, steps + 1):
            if step == 1:  # the checked step (its plain pass runs first, outside the clock)
                check, (state, hist) = _family_step_check(torch, tr, state, first, lambda st=state: one(st),
                                                          f"phase 15 {arch} check step 1")
                walls.append(check["step_wall_s"])
                torch.cuda.reset_peak_memory_stats()  # the steps' peak, without the check's plain gradients
            elif step == steps:  # the last step under the profiler, after its unprofiled peers
                prof = _profile_train_step(torch, lambda st=state: prof_out.append(one(st)), out_dir,
                                           f"phase 15 {arch}", float(np.median(walls)) * 1e3)
                state, hist = prof_out[-1]
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, hist = one(state)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            losses.append(hist[0]["loss"])
            if daemon is not None:
                for toks, nodes in fed:
                    plain = daemon.fold(plain, toks, nodes)
                fed.clear()
                if daemon.due(step):
                    plain = daemon.sweep(plain)
                for field in ("counts", "hot_ids", "slot_map", "sweeps"):
                    assert torch.equal(getattr(state.hot_embed, field), getattr(plain, field)), (arch, step, field)
            print(f"phase 15 {arch} step {step}: loss {losses[-1]:.4f}"
                  + (" (profiled)" if step == steps else f", {walls[-1]:.4f} s")
                  + (f", hot-row sweeps {int(state.hot_embed.sweeps)}" if state.hot_embed is not None else ""))
        got = {fn.__name__: fn.launches for fn in kernels}
        peak = torch.cuda.max_memory_allocated()
        want = {"hot_gather": steps if cfg.hot_embed_rows else 0, "ownership_sweep": 0}
        assert got == want, (arch, got, want)
        assert all(np.isfinite(losses)), (arch, losses)
        if drive["run"]:
            assert int(state.hot_embed.sweeps) == steps // drive["sweep"] >= 1, arch
        for name in launches:
            launches[name] += got[name]
        fam = _train_run_summary(f"phase 15 {arch}", walls, positions, model.active_params(), got, steps,
                                 peak, smi, prof)
        fam.update(family=cfg.family, layers=cfg.num_layers, batch=b, params=model.num_params(),
                   losses=losses, walls_s=walls, check=check, wall_s=time.perf_counter() - t_arch)
        if state.hot_embed is not None:
            fam["embed_hit_rate"] = float(tr.embed_daemon.hit_rate(state.hot_embed))
        rec["families"][arch] = fam
        del state, tr, model, first, prof_out
        if drive["run"]:
            del pipe, plain
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 15 {arch} took {fam['wall_s']:.1f} s; {torch.cuda.memory_allocated()} bytes still allocated")
    rec["launches"] = launches
    print(f"phase 15 launches {launches}")
    return rec


# ---------------------------------------------------------------------------
# Phase 16: the distribution seam on a mesh, the memory model, the dry run.

MESH_SHAPE, MESH_AXES = (1, 2), ("data", "model")  # two gloo ranks sharing the card
MESH_PROMPT, MESH_PROMPTS, MESH_STEPS = 1024, 2, 8  # qwen3 prefill 2 x 1,024, then 8 decode steps
MESH_TRAIN_LAYERS = 4  # phase 13's depth for the qwen3 training step
MESH_TRAIN_ROWS, MESH_TRAIN_SEQ = 2, 1024
MESH_DECODE_ATOL, MESH_DECODE_RTOL = 0.15, 0.05  # tests/test_distributed.py's sharded decode bars
MESH_LOSS_RTOL = 2e-2  # tests/test_distributed.py's sharded loss bar
LONG_CELLS = ("rwkv6-1.6b", "recurrentgemma-2b")  # long_500k at full size and depth
DRYRUN_CELL = ("qwen3-1.7b", "train_4k")


def _mesh_counters():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.hot_gather.ops import hot_gather
    from repro_torch.kernels.moe_router.ops import moe_router

    return dict(flash_attention=flash_attention, flash_decode=flash_decode, moe_router=moe_router,
                hot_gather=hot_gather)


def _mesh_rank(jobs: list) -> list:
    """Phase 16 (a) on one rank of a ``spmd.run_ranks`` group of two sharing
    the card, mesh (data 1, model 2). Each job runs the sharded main path
    once (this rank's blocks of full-width params made from a seed; kernel
    launches, collectives by kind and bytes, wall and peak memory counted
    on this rank), then, on rank 0, the same path with ``dist=None`` on the
    whole params (the one-rank result it is held against). Returns one
    record a job."""
    import torch
    import torch.distributed as tdist

    from repro_torch import dist as D
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import Model
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.optim import init_opt

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(jobs[0].get("device", "cuda"))  # "cpu" rehearses the phase's logic
    cuda = dev.type == "cuda"
    rank = tdist.get_rank()
    dist = sh.make_dist(make_mesh(MESH_SHAPE, MESH_AXES, device_type=dev.type))
    kernels = _mesh_counters()
    out = []

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for job in jobs:
        cfg = get_config(job["arch"])
        if job.get("overrides"):  # a rehearsal's reduced widths
            cfg = dataclasses.replace(cfg, **job["overrides"])
        if job.get("layers"):
            cfg = dataclasses.replace(cfg, num_layers=job["layers"])
        model = Model(cfg, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        local = sh.place_tree(params, sh.param_shardings(model, dist.mesh), dist)
        gen = torch.Generator(device=dev).manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (job["rows"], job["seq"] + 1), device=dev,
                             dtype=torch.int32, generator=gen)

        def run(p, d, feed=None):
            """The job's path; returns (numbers, tokens fed to the decode)."""
            res = {}
            if job["kind"] == "serve":
                with torch.no_grad():
                    logits, state = model.prefill(p, {"tokens": toks[:, :-1]}, d,
                                                  cache_len=job["seq"] + MESH_STEPS)
                    logits = D.gather_logits(logits, d)
                    steps, fed = [logits.float()], []
                    for i in range(MESH_STEPS):
                        tok = (torch.argmax(logits, -1).to(torch.int32) if feed is None else feed[i])
                        fed.append(tok)
                        logits, state = model.decode_step(p, state, tok, d)
                        logits = D.gather_logits(logits, d)
                        steps.append(logits.float())
                res["logits"] = torch.stack(steps).cpu().numpy()
                return res, fed
            tr = Trainer(model, TrainConfig(), d)
            pp = p if d is not None else tree_lib.tree_map(lambda t: t.detach().clone(), p)
            for leaf in tree_lib.leaves(pp):
                leaf.requires_grad_(True)
            batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
            _, _, met = tr.step(pp, init_opt(pp), batch, None, None)
            res["loss"] = float(met["loss"])
            if job["kind"] == "moe":  # and a prefill
                with torch.no_grad():
                    logits, _ = model.prefill(p, {"tokens": toks[:, :-1]}, d)
                res["prefill_logits"] = D.gather_logits(logits, d).float().cpu().numpy()
            return res, None

        for fn in kernels.values():
            fn.launches = 0
        D.reset_comm()
        tdist.barrier()
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() if cuda else 0
        t0 = time.perf_counter()
        res, fed = run(local, dist)
        sync()
        rec = dict(wall_s=time.perf_counter() - t0, comm=D.comm_totals(),
                   launches={name: getattr(fn, "launches", 0) for name, fn in kernels.items()},
                   peak_bytes=(torch.cuda.max_memory_allocated() - held) if cuda else 0, **res)
        del local
        tdist.barrier()
        if rank == 0:  # the one-rank run on the card, fed the same tokens
            sync()
            t0 = time.perf_counter()
            ref, _ = run(params, None, fed)
            sync()
            rec["one_rank"] = dict(wall_s=time.perf_counter() - t0, **ref)
        tdist.barrier()
        out.append(rec)
        del params, model
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


def _start_dryrun(out_dir):
    """Phase 16 (c)'s dry run as a CPU subprocess: ``python -m
    repro_torch.launch.dryrun`` for ``DRYRUN_CELL`` on the fake 16 x 16 mesh,
    its JSON written to ``out_dir`` and printed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DRYRUN_CELL[0],
                             "--shape", DRYRUN_CELL[1], "--out", str(out_dir / "dryrun_16x16.json")],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _mesh_phase(torch, dev, out_dir, dry=None) -> dict:
    """Phase 16: the distribution seam (``dist.py``, ``launch/sharding.py``)
    and the dry run (``launch/dryrun.py``) on the card.

    (a) Two gloo ranks sharing the card, mesh (data 1, model 2): qwen3-1.7b
        at full width and all 28 layers, a prefill of 2 x 1,024 tokens
        (``flash_attention`` on each rank's 8 of 16 heads) and 8 greedy
        decode steps (``flash_decode`` on its 4 of 8 kv heads), held against
        one rank with ``dist=None`` on the card fed the same tokens (decode
        logits atol 0.15, rtol 0.05); one ``Trainer.step`` of qwen3-1.7b at
        phase 13's depth (4 layers, 2 x 1,024 tokens) and of
        granite-moe-1b-a400m at full width and all 24 layers (its 32 experts
        over the model axis through ``moe_router``), loss within rtol 2e-2
        of one rank's, and granite's prefill logits at the decode bars. The
        collectives a step by kind and bytes, each rank's peak memory and
        the wall against one rank's.
    (b) ``analytic_memory_per_chip`` on a one-card mesh for every (arch x
        cell) against 80 GB; then one decode step at full size and depth of
        rwkv6-1.6b and recurrentgemma-2b ``long_500k`` (the ring caches full,
        ``flash_decode`` over them), ``max_memory_allocated`` beside the
        analytic params + state bytes.
    (c) ``python -m repro_torch.launch.dryrun`` for qwen3-1.7b train_4k on
        the fake 16 x 16 mesh (a CPU subprocess, ``dry`` where the caller
        started it earlier, else started here): it must exit 0 and print
        its JSON."""
    from repro_torch.configs import ARCH_IDS, cells, get_config, get_shape
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.moe_router.ops import moe_router
    from repro_torch.kernels.moe_router.ref import router_ref
    from repro_torch.launch.dryrun import analytic_memory_per_chip
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.model import Model
    from repro_torch.spmd import run_ranks

    rec: dict = {}
    smi = _smi()
    t_phase = time.perf_counter()
    dry = dry or _start_dryrun(out_dir)
    try:
        # The kernels at the sharded path's shapes, against their plain versions.
        gen = torch.Generator(device=dev).manual_seed(16)
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
                   for s in ((MESH_PROMPTS, MESH_PROMPT, 8, 128), (MESH_PROMPTS, MESH_PROMPT, 4, 128),
                             (MESH_PROMPTS, MESH_PROMPT, 4, 128)))
        err_fa, _ = _check_close(torch, flash_attention(q, k, v), flash_attention_ref(q, k, v),
                                 torch.bfloat16, "phase 16 flash_attention 8 of 16 heads")
        lens = torch.tensor([MESH_PROMPT + 1, MESH_PROMPT + 5], dtype=torch.int32, device=dev)
        kc, vc = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, MESH_STEPS)) for x in (k, v))
        q0 = q[:, 0].contiguous()
        err_fd, _ = _check_close(torch, flash_decode(q0, kc, vc, lens),
                                 flash_decode_ref(q0, kc, vc, lens), torch.bfloat16,
                                 "phase 16 flash_decode 4 of 8 kv heads")
        logits = torch.randn((MESH_TRAIN_ROWS * MESH_TRAIN_SEQ, 32), generator=gen, device=dev)
        near, err_rt = _router_near_ties(moe_router(logits, k=8, group=512), router_ref(logits, 8, 512),
                                         _plain_probs(logits), "phase 16 moe_router granite")
        del q, q0, k, v, kc, vc, logits
        rec["kernel_errors"] = dict(flash_attention=err_fa, flash_decode=err_fd, moe_router=err_rt)
        print(f"phase 16 kernels at the sharded shapes ok: flash_attention max_abs_err {err_fa}, "
              f"flash_decode {err_fd}, moe_router gates {err_rt} ({int(near.sum())} near-tie rows)")

        # (a) sharded against one rank
        jobs = [dict(arch="qwen3-1.7b", kind="serve", rows=MESH_PROMPTS, seq=MESH_PROMPT),
                dict(arch="qwen3-1.7b", kind="train", rows=MESH_TRAIN_ROWS, seq=MESH_TRAIN_SEQ,
                     layers=MESH_TRAIN_LAYERS),
                dict(arch="granite-moe-1b-a400m", kind="moe", rows=MESH_TRAIN_ROWS, seq=MESH_TRAIN_SEQ)]
        t0 = time.perf_counter()
        ranks = run_ranks(_mesh_rank, 2, jobs, timeout=900)
        rec["a_wall_s"] = time.perf_counter() - t0
        launches = dict.fromkeys(_mesh_counters(), 0)
        rec["a"] = {}
        for i, job in enumerate(jobs):
            r0, r1 = ranks[0][i], ranks[1][i]
            one = r0["one_rank"]
            label = f"{job['arch']} {job['kind']}"
            for name in launches:
                launches[name] += r0["launches"][name] + r1["launches"][name]
            row = dict(wall_s=[r0["wall_s"], r1["wall_s"]], one_rank_wall_s=one["wall_s"],
                       peak_bytes=[r0["peak_bytes"], r1["peak_bytes"]], comm=r0["comm"],
                       launches=[r0["launches"], r1["launches"]])
            if job["kind"] == "serve":
                got, want = r0["logits"], one["logits"]
                assert np.array_equal(got, r1["logits"]), label
                assert np.isfinite(got).all(), label
                np.testing.assert_allclose(got, want, atol=MESH_DECODE_ATOL, rtol=MESH_DECODE_RTOL,
                                           err_msg=label)
                row["max_logit_diff"] = float(np.abs(got - want).max())
                layers = get_config(job["arch"]).num_layers
                for r in (r0, r1):  # a layer a prefill and a layer a step, on each rank
                    assert r["launches"]["flash_attention"] == layers, r["launches"]
                    assert r["launches"]["flash_decode"] == layers * MESH_STEPS, r["launches"]
            else:
                assert r0["loss"] == r1["loss"] and np.isfinite(r0["loss"]), label
                np.testing.assert_allclose(r0["loss"], one["loss"], rtol=MESH_LOSS_RTOL, err_msg=label)
                row.update(loss=r0["loss"], one_rank_loss=one["loss"])
                if job["kind"] == "moe":
                    np.testing.assert_allclose(r0["prefill_logits"], one["prefill_logits"],
                                               atol=MESH_DECODE_ATOL, rtol=MESH_DECODE_RTOL, err_msg=label)
                    row["max_logit_diff"] = float(np.abs(r0["prefill_logits"] - one["prefill_logits"]).max())
                    layers = get_config(job["arch"]).num_layers
                    for r in (r0, r1):  # the step's forward and its remat, and the prefill
                        assert r["launches"]["moe_router"] == 3 * layers, r["launches"]
                        assert r["launches"]["flash_attention"] == layers, r["launches"]
            rec["a"][label] = row
            comm = ", ".join(f"{kind} {c['calls']} calls {c['bytes']:.0f} bytes"
                             for kind, c in r0["comm"].items())
            extra = (f"loss {row['loss']} against one rank's {row['one_rank_loss']} (rtol "
                     f"{MESH_LOSS_RTOL})" if "loss" in row else "")
            if "max_logit_diff" in row:
                extra += (f"{'; ' if extra else ''}max logit difference {row['max_logit_diff']} "
                          f"(atol {MESH_DECODE_ATOL}, rtol {MESH_DECODE_RTOL})")
            print(f"phase 16 (a) {label}: 2 ranks (data 1, model 2) {extra}; wall {r0['wall_s']:.3f} / "
                  f"{r1['wall_s']:.3f} s against one rank's {one['wall_s']:.3f} s; peak memory "
                  f"{r0['peak_bytes']} / {r1['peak_bytes']} bytes; collectives a rank: {comm}; "
                  f"launches a rank {r0['launches']} [{smi}]")
        rec["launches"] = launches
        print(f"phase 16 launches {launches}; (a) took {rec['a_wall_s']:.1f} s")

        # (b) the memory model on one card, and two long_500k cells at full size
        one_card = AbstractMesh((1, 1), ("data", "model"))
        table = {}
        for arch in ARCH_IDS:
            model = Model(get_config(arch), "cpu")
            for cell in cells(arch):
                shape = get_shape(cell)
                m = analytic_memory_per_chip(model, shape, one_card, shape.kind)
                table[f"{arch} {cell}"] = dict(total_bytes=m["total_bytes"], fits_80GB=m["total_bytes"] < 80e9)
        print("phase 16 (b) analytic memory on one card (1 x 1 mesh; fits 80 GB): " + "; ".join(
            f"{k} {v['total_bytes'] / 1e9:.3f} GB {'fits' if v['fits_80GB'] else 'does not fit'}"
            for k, v in table.items()))
        rec["memory_table"] = table
        rec["long_500k"] = {}
        fd_launches = 0
        for arch in LONG_CELLS:
            cfg, shape = get_config(arch), get_shape("long_500k")
            model = Model(cfg, dev)
            params = model.init(torch.Generator(device=dev).manual_seed(0))
            state = model.init_state(shape.global_batch, shape.seq_len)
            if hasattr(state, "length"):  # a 524,287-token context before this token
                state = state._replace(length=torch.full_like(state.length, shape.seq_len - 1))
            if hasattr(state, "caches"):  # the rings hold a 524,287-token context's last window
                for kc_, vc_ in state.caches:
                    kc_.normal_(generator=gen)
                    vc_.normal_(generator=gen)
            tok = torch.zeros((shape.global_batch,), dtype=torch.int32, device=dev)
            flash_decode.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                logits, _ = model.decode_step(params, state, tok)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            assert torch.isfinite(logits[:, : cfg.vocab_size]).all(), arch
            fd_launches += flash_decode.launches
            m = analytic_memory_per_chip(model, shape, one_card, "decode")
            analytic = m["params_bytes"] + m["state_bytes"]
            rec["long_500k"][arch] = dict(peak_bytes=peak, analytic_bytes=analytic, ratio=peak / analytic,
                                          flash_decode_launches=flash_decode.launches)
            print(f"phase 16 (b) {arch} long_500k decode step at full size and depth: "
                  f"max_memory_allocated {peak} bytes, analytic params + state {analytic:.0f} bytes, "
                  f"ratio {peak / analytic:.4f}; flash_decode launches {flash_decode.launches} [{smi}]")
            del model, params, state, logits
            gc.collect()
            torch.cuda.empty_cache()
        launches["flash_decode"] += fd_launches
        rec["long_500k_flash_decode_launches"] = fd_launches

        # (c) the dry run
        t_wait = time.perf_counter()
        stdout, stderr = dry.communicate(timeout=900)
        rec["dryrun_wait_s"] = time.perf_counter() - t_wait
        print(f"phase 16 (a) and (b) took {t_wait - t_phase:.1f} s; waited {rec['dryrun_wait_s']:.1f} s "
              f"for the dry run")
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    if dry.returncode != 0:
        raise RuntimeError(f"phase 16 (c) dry run exited {dry.returncode}:\n{stderr[-3000:]}")
    res = json.loads(stdout[stdout.index("{"):])
    assert res["ok"] and res["chips"] == 256, res
    rec["dryrun"] = res
    print("phase 16 (c) dry run " + json.dumps(
        {k: res[k] for k in ("arch", "shape", "mesh", "chips", "compile_s", "memory", "roofline")}))
    return rec


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
    from repro_torch.kernels.chunk_replay.ops import launch_shape
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
        held = torch.cuda.memory_allocated()
        record.setdefault("held_after", {})[phase] = held
        print(f"{phase} took {now - mark[1]:.1f} s ({now - mark[0]:.1f} s since the start); "
              f"{held} bytes of tensors still allocated")
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
    dry = _start_dryrun(out_dir)  # phase 16 (c), on the host's CPU beside the card's phases
    atexit.register(lambda: dry.poll() is None and (dry.kill(), dry.wait()))

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
    # Empty replica rows (mask 0), reachable once a finite budget evicts a
    # key's last replica: reads pay the worst RTT. Both launch modes the
    # engine takes, a chunk (one cluster) and a whole trace (packed map);
    # whole-ms latencies, so every output is exact.
    ecases = 0
    for n_e, rtt_e in ((3, ClusterConfig().rtt_matrix(dev)), (5, wan5_cluster().rtt_matrix(dev))):
        for b_e, k_e, want_mode in ((10_000, 50_000, "cluster"), (1_000_000, 50_000, "packed")):
            assert launch_shape(b_e, n_e, k_e)[0] == want_mode, (b_e, n_e, k_e)
            for empty_share in (0.3, 1.0):
                hosts_e = rng.random((k_e, n_e)) < 0.4
                hosts_e[rng.random(k_e) < empty_share] = False
                args = [cuda_t(hosts_e), cuda_t(rng.integers(0, k_e, b_e).astype(np.int32)),
                        cuda_t(rng.integers(0, n_e, b_e).astype(np.int32)),
                        cuda_t(rng.random(b_e) < 0.75), cuda_t(rng.random(b_e) < 0.95), rtt_e]
                for mode in ("map", "no_local"):
                    kw = dict(service_ms=10.0, master=1, xfer_read_ms=2.0, xfer_write_ms=3.0,
                              read_mode=mode, num_bins=128)
                    outs = [(torch.empty(b_e, device=dev), torch.empty(b_e, dtype=torch.bool, device=dev))
                            for _ in range(2)]
                    got = chunk_replay(*args, **kw, lat_out=outs[0][0], hit_out=outs[0][1])
                    want = chunk_replay_ref(*args, **kw, lat_out=outs[1][0], hit_out=outs[1][1])
                    ctx = f"chunk_replay empty rows N={n_e} B={b_e} share={empty_share} {mode}"
                    assert all(torch.equal(g, w) for g, w in zip(got, want)), ctx
                    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1]), ctx
                    ecases += 1
    print(f"phase 2 chunk_replay empty replica rows ok: {ecases} cases (mask 0 on 30 % and on all "
          f"keys; map and no_local; N 3 and 5; a chunk (cluster) and a whole trace (packed)), "
          f"every output exact")
    # The failure-injection path's operands: a failover delta down to -300 ms
    # (negative latencies, binned to 0), a chunk of refused rows only, a down
    # node's whole column of the map False. Both launch modes, with and
    # without bins; whole-ms latencies, so every output is exact.
    fcases = 0
    rtt_w = wan5_cluster().rtt_matrix(dev)
    for b_f, k_f, want_mode in ((10_000, 50_000, "cluster"), (1_000_000, 50_000, "packed")):
        assert launch_shape(b_f, 5, k_f)[0] == want_mode, (b_f, k_f)
        for case in ("negative_extra", "all_refused", "dead_column"):
            hosts_f = rng.random((k_f, 5)) < 0.4
            valid_f = rng.random(b_f) < 0.9
            if case == "dead_column":
                hosts_f[:, 0] = False
            if case == "all_refused":
                valid_f[:] = False
            args = [cuda_t(hosts_f), cuda_t(rng.integers(0, k_f, b_f).astype(np.int32)),
                    cuda_t(rng.integers(0, 5, b_f).astype(np.int32)), cuda_t(rng.random(b_f) < 0.7),
                    cuda_t(valid_f), rtt_w]
            extra_f = cuda_t(rng.integers(-300, 30, b_f).astype(np.float32))
            for bins in (0, 128):
                kw = dict(service_ms=10.0, master=0, xfer_read_ms=2.0, xfer_write_ms=3.0,
                          read_mode="map", num_bins=bins, extra_ms=extra_f)
                outs = [(torch.empty(b_f, device=dev), torch.empty(b_f, dtype=torch.bool, device=dev))
                        for _ in range(2)]
                got = chunk_replay(*args, **kw, lat_out=outs[0][0], hit_out=outs[0][1])
                want = chunk_replay_ref(*args, **kw, lat_out=outs[1][0], hit_out=outs[1][1])
                ctx = f"chunk_replay fault path {case} B={b_f} bins={bins}"
                assert all(g is None and w is None or torch.equal(g, w) for g, w in zip(got, want)), ctx
                assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1]), ctx
                assert case != "all_refused" or (int(got[4]) == 0 and not bool(got[0].any())), ctx
                assert case == "all_refused" or bool((outs[0][0] < 0).any()), ctx
                fcases += 1
    print(f"phase 2 chunk_replay fault-path operands ok: {fcases} cases (extra_ms in [-300, 30) ms, "
          f"every row refused, a node's column all False; a chunk (cluster) and a whole trace "
          f"(packed), bins 0 and 128), every output exact")

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

    hcases, err_hist, edge_bins, rule_checks = _histogram_cases(torch, dev, rng)
    print(f"phase 2 latency_histogram ok: {hcases} cases, max_abs_err {err_hist} "
          f"(real weights; 0/1 weights exact), decade-edge bins {edge_bins}")
    print("phase 2 latency_histogram bin rule: threshold count against bin_of on all 2**32 "
          "f32 patterns: " + ", ".join(f"(lo {lo}, hi {hi}, B {b}) {bad} mismatches"
                                       for (lo, hi, b), bad in rule_checks.items()))
    record["histogram_rule_mismatches"] = [[*k, v] for k, v in rule_checks.items()]
    err_hist = max(err_hist, _attribution_fold_cases(torch, dev, rng))
    record["trace_window_cases"] = _trace_window_cases(torch, dev)

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
    print(f"phase 2 flash_attention tma_wgmma ok: {tcases} cases (D 128, 64 and 256, both q tiles), "
          f"max_abs_err {err_attn[torch.bfloat16]}, scaled bar used {use_tma:.4f} (bar 0.5)")
    # Rows that see no key, through every variant (the TMA one through both q
    # tiles): the plain version's bars, and the rows equal to the mean of v.
    ecases = 0
    for b, s_, t, h, kh, causal, window in EMPTY_ROW_CASES:
        for kind, dname, dh in EMPTY_ROW_VARIANTS:
            dtype = getattr(torch, dname)
            named = (kind, dh) == ("mma_sync", 256)  # launched by name: not the dispatch's choice
            assert (fa_ops.variant(dtype, dh) == kind) != named and fa_ops.has_empty_rows(s_, t, window)
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
    print(f"phase 2 flash_attention rows without keys ok: {ecases} cases (all three variants, mma_sync at D 256 "
          f"by name), "
          f"each such row the mean of v; max_abs_err f32 {err_attn[torch.float32]}, "
          f"bf16 {err_attn[torch.bfloat16]}")
    # flash_attention at 1,024 tokens (qwen3-1.7b's heads, causal, bf16) beside
    # SDPA, in turns (kernel, SDPA) three times; the median of each.
    sdpa_ = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (cuda_t(rng.standard_normal(sh).astype(np.float32)).to(torch.bfloat16)
               for sh in ((1, 1024, 16, 128), (1, 1024, 8, 128), (1, 1024, 8, 128)))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    turns_1k = {"kernel": [], "sdpa": []}
    for _ in range(3):
        turns_1k["kernel"].append(_device_ms(lambda: flash_attention(q, k, v), torch, reps=5, iters=20))
        turns_1k["sdpa"].append(_device_ms(lambda: sdpa_(qt, kt, vt, is_causal=True, enable_gqa=True),
                                           torch, reps=5, iters=20))
    f1k, b1k = _attention_flops_bytes(1, 1024, 1024, 16, 8, 128, True, 0)
    bound_1k = max(f1k / BF16_OPS_PER_S, b1k / BW_BYTES_PER_S) * 1e3
    med_k, med_s = float(np.median(turns_1k["kernel"])), float(np.median(turns_1k["sdpa"]))
    record["flash_attention_1024"] = dict(turns_ms=turns_1k, ms=med_k, sdpa_ms=med_s, bound_ms=bound_1k)
    print(f"phase 2 flash_attention S 1024 (q [1, 1024, 16, 128], k/v [1, 1024, 8, 128] bf16, causal) "
          f"in turns: kernel {turns_1k['kernel']} ms, SDPA {turns_1k['sdpa']} ms; medians {med_k:.4f} "
          f"against {med_s:.4f} ms, bound {bound_1k:.4f} ms")
    del qt, kt, vt

    # flash_decode: the reference kernel test's shapes and recurrentgemma-2b's
    # rings (and a group of 16 at D 256) in both dtypes, then the serving
    # shape (16 lanes, an 8,192-slot cache), lengths random with 1 and one
    # past T in every case, and 0 (every position masked: the mean of v)
    # where there are three sequences or more.
    err_dec = {torch.float32: 0.0, torch.bfloat16: 0.0}
    use_dec = 0.0
    dcases = 0
    for case in DECODE_CASES + DECODE_RING_CASES + [(16, SERVE_CACHE, 16, 8, 128)]:
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
    # The cases' inputs (the serving-shape decode cache is 0.5 GB) go with
    # the phase, so that later phases' peaks are their own.
    del q, k, v, lengths, got, want, args, outs, hosts_f, valid_f, extra_f, traffic, sargs, gargs, logits
    torch.cuda.empty_cache()

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

    def head(t, w, chunks_):  # the first chunks of a trace
        sub_r = chunks_ * FULL_INTERVAL
        return (t._replace(keys=t.keys[:sub_r], nodes=t.nodes[:sub_r], is_read=t.is_read[:sub_r]),
                w._replace(num_requests=sub_r))

    chunks = -(-DRIVE_REQUESTS // FULL_INTERVAL)
    trace_d, wl_d = head(trace, wl, chunks)  # the drives' DRIVE_REQUESTS
    policies = {"redynis": RedynisPolicy(), "remote": StaticPolicy("remote")}
    for pol in policies.values():  # warm-up run on the first 50 chunks
        sub, sub_wl = head(trace, wl, 50)
        run_scenario(sub_wl, cl, pol, daemon_interval=FULL_INTERVAL, trace=sub)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chunk_replay.launches = 0
    ownership_sweep.launches = 0
    latency_histogram.launches = 0
    full = {}
    for name, pol in policies.items():
        t0 = time.perf_counter()
        res = run_scenario(wl_d, cl, pol, daemon_interval=FULL_INTERVAL, trace=trace_d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        full[name] = dict(wall_s=wall, sim_requests_per_s=DRIVE_REQUESTS / wall,
                          throughput_ops_s=res.throughput_ops_s, hit_rate=res.hit_rate,
                          replication_moves=res.replication_moves, result=res)
        assert np.isfinite(res.throughput_ops_s) and res.throughput_ops_s > 0
        print(f"phase 4 {name} ({DRIVE_REQUESTS} requests): wall {wall:.3f} s, "
              f"{DRIVE_REQUESTS / wall:.0f} simulated req/s, "
              f"throughput {res.throughput_ops_s:.3f} ops/s, hit_rate {res.hit_rate:.4f}, "
              f"moves {res.replication_moves:.0f}")
    launches = {"chunk_replay": chunk_replay.launches, "ownership_sweep": ownership_sweep.launches,
                "latency_histogram": latency_histogram.launches}
    peak_mem = torch.cuda.max_memory_allocated()
    # The same runs through the plain versions on the card: the full-size
    # results must agree to the engine tolerances.
    with _plain_versions():
        for name, pol in policies.items():
            plain = run_scenario(wl_d, cl, pol, daemon_interval=FULL_INTERVAL, trace=trace_d)
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
    wl_c = wan5_workload(num_requests=DRIVE_REQUESTS, num_keys=FULL_KEYS, read_fraction=1.0,
                         region_weights=(0.2,) * 5, affinity=0.8, object_bytes_sigma=1.0)
    cl_c = wan5_cluster(service=ServiceConfig(serve_bytes_per_ms=128.0, capacity_factor=1.0))
    trace_c = generate_trace(wl_c, seed=0, device=dev)
    runs = {
        "redynis": (wl_d, cl, trace_d, RedynisPolicy()),
        "remote": (wl_d, cl, trace_d, StaticPolicy("remote")),
        "redynis_contention": (wl_c, cl_c, trace_c, RedynisPolicy()),
    }

    for w, c, t, pol in runs.values():
        sub, sub_wl = head(t, w, 50)
        run_scenario(sub_wl, c, pol, daemon_interval=FULL_INTERVAL, trace=sub, telemetry=tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chunk_replay.launches = 0
    ownership_sweep.launches = 0
    latency_histogram.launches = 0
    latency_histogram.setup_launches = 0  # the threshold table's, counted apart
    tele = {}
    for name, (w, c, t, pol) in runs.items():
        t0 = time.perf_counter()
        res, tr = run_scenario(w, c, pol, daemon_interval=FULL_INTERVAL, trace=t, telemetry=tcfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tail = tr.tail_summary()
        assert np.isfinite(res.throughput_ops_s) and tr.hist.sum() == DRIVE_REQUESTS, name
        assert tr.chunk_hist.shape == (chunks, 128) and np.isfinite(tr.p99_latency_ms).all(), name
        tele[name] = dict(wall_s=wall, sim_requests_per_s=DRIVE_REQUESTS / wall,
                          throughput_ops_s=res.throughput_ops_s, hit_rate=res.hit_rate,
                          mean_latency_ms=res.mean_latency_ms, quantiles=tail,
                          convergence_chunk=tr.convergence_chunk(),
                          post_convergence_moves=tr.post_convergence_moves(),
                          max_load_factor=float(tr.load_factor.max()), result=res, trace=tr)
        print(f"phase 5 {name} ({DRIVE_REQUESTS} requests): wall {wall:.3f} s, "
              f"{DRIVE_REQUESTS / wall:.0f} simulated req/s, "
              f"throughput {res.throughput_ops_s:.3f} ops/s, mean {res.mean_latency_ms:.3f} ms, "
              f"p50 {tail['p50']:.3f} ms, p99 {tail['p99']:.3f} ms, p99.9 {tail['p999']:.3f} ms, "
              f"max rho {float(tr.load_factor.max()):.4f}")
    tele_launches = {"chunk_replay": chunk_replay.launches,
                     "ownership_sweep": ownership_sweep.launches,
                     "latency_histogram": latency_histogram.launches}
    tele_setup = latency_histogram.setup_launches  # 0: the warm-up set the table up
    tele_mem = torch.cuda.max_memory_allocated()
    # Two Redynis runs replay chunk by chunk with the fused histogram and
    # sweep every chunk; the static run is one whole-trace replay and one
    # per-chunk histogram launch.
    assert tele_launches == {"chunk_replay": 2 * chunks + 1, "ownership_sweep": 2 * chunks,
                             "latency_histogram": 1}, tele_launches
    assert tele["redynis_contention"]["max_load_factor"] > 0
    # Telemetry's cost on the Redynis run within this call: phase 4's run
    # (off) against the run above (on). Reduced: the further turns in
    # alternation (off, on, off, on) are left out for phase 13's time; the
    # loop is host-bound and single runs spread widely.
    turns = {"off": [full["redynis"]["wall_s"]], "on": [tele["redynis"]["wall_s"]]}
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
    print(f"phase 5 launches {tele_launches} (latency_histogram set-up: {tele_setup}), "
          f"max_memory_allocated {tele_mem} bytes; Redynis with "
          f"telemetry takes {slowdown:.4f}x the wall time without (one turn each)")
    record["telemetry"] = tele
    record["telemetry_launches"] = tele_launches
    record["telemetry_histogram_setup_launches"] = tele_setup
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
    full_chunks = -(-FULL_REQUESTS // FULL_INTERVAL)
    fold_ms = _device_ms(lambda: torch.bincount(flat, weights=weight, minlength=full_chunks * g * nb),
                         torch, reps=3, iters=5)
    del flat
    hist_bytes = FULL_REQUESTS * 12 + full_chunks * g * nb * 4
    hist_calls = _kernels_per_call(torch, lambda: latency_histogram(lat, group, weight, **hkw),
                                   latency_histogram)
    print(f"phase 5 latency_histogram ({FULL_REQUESTS} requests -> [{full_chunks}, {g}, {nb}]): "
          f"kernel {hist_ms:.4f} ms, plain {hist_plain:.4f} ms, "
          f"bound {hist_bytes / BW_BYTES_PER_S * 1e3:.4f} ms "
          f"({hist_bytes / BW_BYTES_PER_S * 1e3 / hist_ms:.3f} of it), bincount fold floor "
          f"{fold_ms:.4f} ms; kernel launches a call by the profiler: host {hist_calls['host_launches']}, "
          f"device {hist_calls['device_kernels']} {hist_calls['device_events']}")
    assert hist_calls["host_launches"] == 1, hist_calls  # no fill, no second kernel
    # The same shape on log-uniform latencies over [0.1, 1e5] ms (few lanes
    # collide), the flat [2N, B] form (on those too: a flat cell of the
    # static replay counts up to 18 M rows, past f32's exact integers) and
    # rows_per_chunk 997, each exact.
    lat_u = torch.exp(torch.empty(FULL_REQUESTS, device=dev).uniform_(
        float(np.log(0.1)), float(np.log(1e5)), generator=torch.Generator(device=dev).manual_seed(0)))
    extra = {}
    for label, x, rpc in (("log_uniform", lat_u, FULL_INTERVAL), ("flat", lat_u, None), ("rpc_997", lat, 997)):
        kw = dict(hkw, rows_per_chunk=rpc)
        got = latency_histogram(x, group, weight, **kw)
        assert torch.equal(got, _plain_histogram(x, group, weight, **kw)), label
        del got
        n_out = 1 if rpc is None else -(-FULL_REQUESTS // rpc)
        bound = (FULL_REQUESTS * 12 + n_out * g * nb * 4) / BW_BYTES_PER_S * 1e3
        ms = _device_ms(lambda: latency_histogram(x, group, weight, **kw), torch, reps=3, iters=5)
        extra[label] = dict(ms=ms, bound_ms=bound, share=bound / ms)
        print(f"phase 5 latency_histogram {label}: kernel {ms:.4f} ms, {bound / ms:.3f} of the "
              f"{bound:.4f} ms bound")
    del lat_u
    record["latency_histogram_full"] = dict(ms=hist_ms, plain_ms=hist_plain, bincount_fold_ms=fold_ms,
                                            bound_ms=hist_bytes / BW_BYTES_PER_S * 1e3,
                                            kernels_per_call=hist_calls, **extra)

    # ``runs``, the drives' and the warm-up's sub-traces and phase 4's chunk
    # slices (views: ``contiguous`` of a slice is the slice) still hold the
    # traces, and ``x`` the latencies.
    del trace, trace_d, lat, group, weight, allv, hosts, multi, counts, live, last, runs, sub, t, x
    del ck, cn, cr, cv, sweep_inputs, traffic
    torch.cuda.empty_cache()

    lap("phase 5")

    # ---- phase 6: Redynis on ML state at deepseek-moe-16b widths ---------
    # The Trainer's daemon step, forward only: hot-row embedding cache
    # (hot_gather), ML_LAYERS MoE layers at full width (moe_router), both
    # daemons folded every step and swept every ML_SWEEP_PERIOD
    # (ownership_sweep on f32 traffic), held every step against the same
    # steps through the plain versions on the card.
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), sweep_period=ML_SWEEP_PERIOD)
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
    # behind a 4-pod SessionRouter, 32 requests over 16 Zipf-1.2 sessions,
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
    _serve_loop(lock, krouter, smodel, SERVE_DRIVE, log=lambda m: None)
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
    # The serving drive's timed wrappers and the lockstep's samplers are
    # closures over bound methods of their engines, so each engine sits in a
    # reference cycle: without a collection their caches (15 GB each) and the
    # params outlive the phase.
    gc.collect()
    torch.cuda.empty_cache()
    err_fa = max(err_attn[torch.bfloat16], err_attn[torch.float32], st["attn_err"])
    err_fd = max(err_dec[torch.bfloat16], err_dec[torch.float32], st["decode_err"])

    lap("phase 7")

    # ---- phase 8: the paper's experiment grid, policies and capacity -----
    record["experiment"] = _experiment_phase(torch, dev, out_dir)
    ex_launches, proj_rec = record["experiment"]["launches"], record["experiment"]["projection"]

    lap("phase 8")

    # ---- phase 10: the routing tier and failure injection -----------------
    record["faults_routing"] = _faults_routing_phase(torch, dev, out_dir)
    fr_launches = record["faults_routing"]["launches"]

    lap("phase 10")

    # ---- phase 11: cost attribution, the flight recorder, streamed traces --
    record["attribution_stream"] = _attribution_stream_phase(torch, dev, out_dir)
    as_launches = record["attribution_stream"]["launches"]
    tw_rec = record["attribution_stream"]["trace_window"]

    lap("phase 11")

    # ---- phase 12: the key-sharded engine ------------------------------
    record["sharded"] = _sharded_phase(torch, dev, out_dir)
    sh_launches = record["sharded"]["launches"]

    lap("phase 12")

    # ---- phase 13: training through Trainer.run -------------------------
    record["training"] = _training_phase(torch, dev, out_dir)
    tr_launches = record["training"]["launches"]

    lap("phase 13")

    # ---- phase 14: every remaining family through ServeEngine, int8 decode --
    record["families"] = _families_phase(torch, dev, out_dir)
    fm_launches = record["families"]["launches"]
    fm_errs = record["families"]["errors"]
    ring = record["families"]["ring_kernels"]
    err_fa = max(err_fa, fm_errs["flash_attention"], ring["attention"]["max_abs_err"])
    err_fd = max(err_fd, fm_errs["flash_decode"], ring["decode"]["max_abs_err"],
                 *(w["max_abs_err"] for w in record["families"]["whisper_decode"].values()))
    attn_variants = {k: attn_variants[k] + record["families"]["variants"][k] for k in attn_variants}

    lap("phase 14")

    # ---- phase 15: the ssm, hybrid, audio and vlm families in training -----
    record["family_training"] = _family_training_phase(torch, dev, out_dir)
    ft_launches = record["family_training"]["launches"]

    lap("phase 15")

    # ---- phase 16: the distribution seam, the memory model, the dry run ----
    record["mesh"] = _mesh_phase(torch, dev, out_dir, dry)
    ms_launches = record["mesh"]["launches"]

    lap("phase 16")

    # ---- phase 9: the kernel record ------------------------------------
    # Launches: the telemetry path's run (phase 5), the routing and fault
    # runs (phase 10), the attribution and streamed runs (phase 11) and the
    # sharded runs (phase 12, summed over the ranks) drive the first three,
    # the ML-state run (phase 6) and training (phases 13 and 15; phase 13's
    # expert sweeps are ownership_sweep's too, phase 15 has none) the next two, the serving drive (phase 7)
    # the two after, phases 11 and 12 the next (a port-only kernel), phase 8
    # the last (port-only, the capacity sweep's finite budgets); phase 8's
    # launches of the first three are on a line of their own ("phase 8
    # launches").
    kernels = [
        dict(name="chunk_replay", route="cuda",
             source="src/repro_torch/kernels/chunk_replay/csrc/chunk_replay.cu",
             replaces="src/repro/kernels/chunk_replay/kernel.py:71",
             launches=tele_launches["chunk_replay"] + fr_launches["chunk_replay"]
             + as_launches["chunk_replay"] + sh_launches["chunk_replay"],
             launches_by_phase={"5": tele_launches["chunk_replay"], "10": fr_launches["chunk_replay"],
                                "11": as_launches["chunk_replay"], "12": sh_launches["chunk_replay"]},
             max_abs_err=err_replay,
             ms=chunk_ms, plain_ms=chunk_plain,
             bound_ms=replay_bytes / BW_BYTES_PER_S * 1e3, bound_by="bytes",
             library_ms=None, whole_trace_ms=whole_ms, whole_trace_bound_ms=whole_bound,
             kernels_per_call=replay_calls[tcfg.num_bins]["host_launches"]),
        dict(name="ownership_sweep", route="cuda",
             source="src/repro_torch/kernels/ownership_sweep/csrc/ownership_sweep.cu",
             replaces="src/repro/kernels/ownership_sweep/kernel.py:38",
             launches=tele_launches["ownership_sweep"] + fr_launches["ownership_sweep"]
             + as_launches["ownership_sweep"] + sh_launches["ownership_sweep"]
             + tr_launches["ownership_sweep"] + serve_launches["ownership_sweep"]
             + fm_launches["ownership_sweep"] + ft_launches["ownership_sweep"],
             launches_by_phase={"5": tele_launches["ownership_sweep"],
                                "7": serve_launches["ownership_sweep"],
                                "10": fr_launches["ownership_sweep"],
                                "11": as_launches["ownership_sweep"],
                                "12": sh_launches["ownership_sweep"],
                                "13": tr_launches["ownership_sweep"],
                                "14": fm_launches["ownership_sweep"],
                                "15": ft_launches["ownership_sweep"]},
             max_abs_err=err_sweep,
             ms=sweep_ms, plain_ms=sweep_plain,
             bound_ms=sweep_bytes / BW_BYTES_PER_S * 1e3, bound_by="bytes",
             library_ms=None),
        dict(name="latency_histogram", route="cuda",
             source="src/repro_torch/kernels/latency_histogram/csrc/latency_histogram.cu",
             replaces="src/repro/kernels/latency_histogram/kernel.py:38",
             launches=tele_launches["latency_histogram"] + as_launches["latency_histogram"]
             + sh_launches["latency_histogram"],
             launches_by_phase={"5": tele_launches["latency_histogram"],
                                "11": as_launches["latency_histogram"],
                                "12": sh_launches["latency_histogram"]},
             max_abs_err=err_hist,
             ms=hist_ms, plain_ms=hist_plain,
             bound_ms=hist_bytes / BW_BYTES_PER_S * 1e3, bound_by="bytes",
             library_ms=None, kernels_per_call=hist_calls["host_launches"]),
        dict(name="moe_router", route="cuda",
             source="src/repro_torch/kernels/moe_router/csrc/moe_router.cu",
             replaces="src/repro/kernels/moe_router/kernel.py:28",
             launches=ml_launches["moe_router"] + tr_launches["moe_router"] + ms_launches["moe_router"],
             launches_by_phase={"6": ml_launches["moe_router"], "13": tr_launches["moe_router"],
                                "16": ms_launches["moe_router"]},
             max_abs_err=err_router,
             ms=router_ms, plain_ms=router_plain, bound_ms=router_bound,
             bound_by="bytes" if router_bytes / BW_BYTES_PER_S >= router_ops / F32_OPS_PER_S
             else "operations",
             library_ms=None, kernels_per_call=router_calls["host_launches"]),
        dict(name="hot_gather", route="cuda",
             source="src/repro_torch/kernels/hot_gather/csrc/hot_gather.cu",
             replaces="src/repro/kernels/hot_gather/kernel.py:34",
             launches=ml_launches["hot_gather"] + tr_launches["hot_gather"] + ft_launches["hot_gather"],
             launches_by_phase={"6": ml_launches["hot_gather"], "13": tr_launches["hot_gather"],
                                "15": ft_launches["hot_gather"]},
             max_abs_err=err_gather,
             ms=gather_ms, plain_ms=gather_plain, bound_ms=gather_bound, bound_by="bytes",
             library_ms=None),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:31",
             launches=serve_launches["flash_attention"] + fm_launches["flash_attention"]
             + ms_launches["flash_attention"],
             launches_by_phase={"7": serve_launches["flash_attention"], "14": fm_launches["flash_attention"],
                                "16": ms_launches["flash_attention"]},
             max_abs_err=err_fa,
             variant={k: v for k, v in attn_variants.items() if v},
             ms=fa_ms, plain_ms=fa_plain, bound_ms=fa_bound,
             bound_by="operations" if fa_flops / BF16_OPS_PER_S >= fa_bytes / BW_BYTES_PER_S else "bytes",
             library_ms=fa_lib, ring=ring["attention"]),
        dict(name="flash_decode", route="cuda",
             source="src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
             replaces="src/repro/kernels/flash_decode/kernel.py:29",
             launches=serve_launches["flash_decode"] + fm_launches["flash_decode"]
             + ms_launches["flash_decode"],
             launches_by_phase={"7": serve_launches["flash_decode"], "14": fm_launches["flash_decode"],
                                "16": ms_launches["flash_decode"]},
             max_abs_err=err_fd,
             ms=fd_ms, plain_ms=fd_plain, bound_ms=fd_bound,
             bound_by="bytes" if fd_bytes / BW_BYTES_PER_S >= fd_flops / BF16_OPS_PER_S else "operations",
             library_ms=fd_lib, ring=ring["decode"], whisper=record["families"]["whisper_decode"]),
        dict(name="trace_window", route="cuda",
             source="src/repro_torch/kernels/trace_window/csrc/trace_window.cu",
             replaces="none: port-only (the reference draws traces with jax.random in XLA, "
                      "src/repro/kvsim/workload.py:172 generate_trace, :288 _request_window)",
             launches=as_launches["trace_window"] + sh_launches["trace_window"],
             launches_by_phase={"11": as_launches["trace_window"], "12": sh_launches["trace_window"]},
             max_abs_err=0.0,
             ms=tw_rec["ms"], plain_ms=tw_rec["plain_ms"], bound_ms=tw_rec["bound_ms"],
             bound_by=tw_rec["bound_by"], library_ms=None,
             whole_trace_ms=tw_rec["whole_trace_ms"], whole_trace_bound_ms=tw_rec["whole_trace_bound_ms"],
             kernels_per_call=tw_rec["kernels_per_call"]["host_launches"]),
        dict(name="capacity_projection", route="cuda",
             source="src/repro_torch/kernels/capacity_projection/csrc/capacity_projection.cu",
             replaces="none: port-only (the reference projects with three chained stable sorts in XLA, "
                      "src/repro/core/costmodel.py:92 project_capacity)",
             launches=ex_launches["capacity_projection"],
             launches_by_phase={"8": ex_launches["capacity_projection"]},
             max_abs_err=0.0,
             ms=proj_rec["ms"], plain_ms=proj_rec["plain_ms"], bound_ms=proj_rec["bound_ms"],
             bound_by="bytes", library_ms=None,
             kernels_per_call=proj_rec["kernels_per_call"]["host_launches"]),
    ]
    mesh_errs = record["mesh"]["kernel_errors"]
    for entry in kernels:
        if entry["name"] in mesh_errs:
            entry["max_abs_err"] = max(entry["max_abs_err"], mesh_errs[entry["name"]])
    record["kernels"] = kernels
    record["ml_launches"] = ml_launches
    record["card"] = smi
    lap("phase 9")
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
