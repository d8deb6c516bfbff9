#!/usr/bin/env python3
"""Times ``latency_histogram`` against an earlier version of its kernel on
one NVIDIA GPU, and splits the earlier kernel's time among its costs.

Run from the repository root, with a copy of the earlier kernel's source
(it is not shipped), for example:

    mkdir -p build/dev
    git show <commit>:src/repro_torch/kernels/latency_histogram/csrc/latency_histogram.cu \\
        > build/dev/parent_histogram.cu
    python3 chip_histogram_split.py --parent build/dev/parent_histogram.cu

The earlier kernel is the one before the threshold-table redesign: a zero
fill, then a grid of (chunk, tile) blocks that add a double-precision log
bin of each row into shared memory with f32 atomics and flush with global
atomics. At the static path's full-size shapes (100 M rows into
``[10,000, 10, 128]`` with the latencies of the static-remote replay and
with log-uniform latencies over [0.1, 1e5] ms, the flat ``[10, 128]`` form,
``rows_per_chunk`` 997) it holds both kernels against the plain version and
times them in turns (earlier, this, this, earlier). Then, on the
static-remote shape, it times the fill alone and stripped copies of the
earlier kernel (no log: a bin read off the value; no shared-memory atomic:
the bins summed in a register; neither; no global flush; no rows), which
split its time among its costs. Kernel times are CUDA-event means of
back-to-back calls (``chip_smoke._device_ms``). It prints each time with
the card's name and power limit and writes
``chiprun_out/histogram_split.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
ROWS, KEYS, INTERVAL = 100_000_000, 1_000_000, 10_000
BW_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)

# Stripped copies of the earlier kernel: (name, [(text, replacement), ...]).
_P_ADD = "atomicAdd(&hist_s[g * B + bin_of(lat[i], lo, hi, log_span, B)], w);"
_P_ACC = ("  for (long long i = begin + static_cast",
          "  float acc = 0.f;\n  for (long long i = begin + static_cast")
_P_KEEP = ("  __syncthreads();\n\n  float* out",
           "  if (acc == -1.f) hist_s[0] = acc;\n  __syncthreads();\n\n  float* out")
PARENT_VARIANTS = [
    ("full", []),
    ("no_log", [(_P_ADD, "atomicAdd(&hist_s[g * B + min(max(static_cast<int>(lat[i]), 0), B - 1)], w);")]),
    ("no_shared_atomic", [
        _P_ACC, (_P_ADD, "acc += w * static_cast<float>(bin_of(lat[i], lo, hi, log_span, B));"), _P_KEEP]),
    ("no_log_no_shared_atomic", [
        _P_ACC, (_P_ADD, "acc += w * static_cast<float>(min(max(static_cast<int>(lat[i]), 0), B - 1));"),
        _P_KEEP]),
    ("no_flush", [("    if (v != 0.f) atomicAdd(&out[i], v);", "    if (v == -7.f) out[i] = v;")]),
    ("no_rows", [("       i < end; i += stride) {", "       i < begin; i += stride) {")]),
]


def _build_parent(name: str, source: str, subs) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    for text, repl in subs:
        assert text in source, (name, text)
        source = source.replace(text, repl, 1)
    d = ROOT / "build" / "dev" / "histogram" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "latency_histogram.cu").write_text(source)
    out = d / "latency_histogram.so"
    res = subprocess.run([_build._nvcc(), *_build.flags("latency_histogram"), "-I",
                          str(_build.INCLUDE_DIR), "-o", str(out), str(d / "latency_histogram.cu")],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    lib = ctypes.CDLL(str(out))
    lib.latency_histogram_error_string.restype = ctypes.c_char_p
    lib.latency_histogram_error_string.argtypes = [ctypes.c_int]
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.latency_histogram_launch.argtypes = [P, P, P, L, L, I, I, I, I, F, F, P, P]
    lib.latency_histogram_launch.restype = ctypes.c_int
    return lib


def _parent_call(torch, lib, lat, group, weight, rpc, g, b, hist=None):
    """The earlier wrapper's launch: a zero fill (unless ``hist`` is given),
    then its grid of (chunk, tile) blocks, 4,096 rows a tile."""
    r = lat.shape[0]
    if rpc is None:
        chunks, span, tiles = 1, r, min(-(-r // 4096), 132 * 8)
    else:
        chunks, span, tiles = -(-r // rpc), rpc, min(-(-rpc // 4096), 65_535)
    if hist is None:
        hist = torch.zeros((chunks, g, b), dtype=torch.float32, device=lat.device)
    code = lib.latency_histogram_launch(lat.data_ptr(), group.data_ptr(), weight.data_ptr(), r, span,
                                        chunks, tiles, g, b, 1.0, 10_000.0, hist.data_ptr(),
                                        torch.cuda.current_stream().cuda_stream)
    assert code == 0, code
    return hist


def _sass_atomics(lib_path: Path) -> dict:
    """Shared- and global-memory atomic opcodes in the built kernels."""
    cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    if not cuobjdump.exists():
        return {}
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    ops: dict = {}
    for line in text.splitlines():
        for word in line.replace(";", " ").split():
            if word.startswith(("ATOMS", "ATOMG", "RED.", "ATOM.", "MATCH", "REDUX")):
                ops[word] = ops.get(word, 0) + 1
    return ops


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_histogram_split: no CUDA device is available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True,
                    help="the earlier latency_histogram.cu to time against")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.chunk_replay.ops import chunk_replay
    from repro_torch.kernels.latency_histogram import ops
    from repro_torch.kvsim import generate_trace, wan5_cluster, wan5_workload
    from repro_torch.kvsim.simulate import _initial_hosts

    dev = torch.device("cuda")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    smi = cs._smi()
    print(smi)
    _build.build_all()
    libs = {name: _build_parent(name, args.parent.read_text(), subs)
            for name, subs in PARENT_VARIANTS}
    record: dict = {"card": smi, "sass": {
        "parent": _sass_atomics(ROOT / "build" / "dev" / "histogram" / "full" / "latency_histogram.so"),
        "kernel": _sass_atomics(_build._target("latency_histogram"))}}
    print(f"sass atomics and votes: {record['sass']}")

    wl = wan5_workload(num_requests=ROWS, num_keys=KEYS, read_fraction=0.9)
    cl = wan5_cluster()
    trace = generate_trace(wl, seed=0, device=dev)
    n = cl.num_nodes
    hosts = _initial_hosts(trace.natural_node, KEYS, n, "offsite").contiguous()
    lat = torch.empty(ROWS, device=dev)
    chunk_replay(hosts, trace.keys, trace.nodes, trace.is_read,
                 torch.ones(ROWS, dtype=torch.bool, device=dev),
                 cl.rtt_matrix(dev), lat_out=lat, service_ms=cl.service_ms, master=cl.master,
                 xfer_read_ms=0.0, xfer_write_ms=0.0, read_mode="no_local")
    group = (trace.nodes * 2 + trace.is_read.to(torch.int32)).to(torch.int32)
    del trace, hosts
    weight = torch.ones(ROWS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    lat_u = torch.exp(torch.empty(ROWS, device=dev).uniform_(float(np.log(0.1)), float(np.log(1e5)),
                                                               generator=gen))
    g, b = 2 * n, 128
    kw = dict(num_groups=g, num_bins=b, lo=1.0, hi=10_000.0)
    record["distinct_static_latencies"] = int(torch.unique(lat).numel())
    # The flat form on log-uniform latencies: a flat cell of the static
    # replay counts up to 18 M rows, past f32's exact integers.
    shapes = {"static_remote": (lat, INTERVAL), "log_uniform": (lat_u, INTERVAL),
              "flat": (lat_u, None), "rpc_997": (lat, 997)}

    def bound_ms(rpc):
        chunks = 1 if rpc is None else -(-ROWS // rpc)
        return (ROWS * 12 + chunks * g * b * 4) / BW_BYTES_PER_S * 1e3

    def timed(fn):
        return cs._device_ms(fn, torch, reps=5, iters=10)

    times: dict = {}
    full = libs["full"]
    for shape, (x, rpc) in shapes.items():
        want = cs._plain_histogram(x, group, weight, rows_per_chunk=rpc, **kw)
        got = _parent_call(torch, full, x, group, weight, rpc, g, b)
        assert torch.equal(got[0] if rpc is None else got, want), ("parent", shape)
        assert torch.equal(ops.latency_histogram(x, group, weight, rows_per_chunk=rpc, **kw),
                           want), ("kernel", shape)
        del got, want
        turns = []
        for who in ("parent", "new", "new", "parent"):
            if who == "parent":
                turns.append(timed(lambda: _parent_call(torch, full, x, group, weight, rpc, g, b)))
            else:
                turns.append(timed(
                    lambda: ops.latency_histogram(x, group, weight, rows_per_chunk=rpc, **kw)))
        times[f"turns {shape}"] = turns
        print(f"turns {shape} (parent, new, new, parent): {turns} ms; bound {bound_ms(rpc):.4f} ms")
    chunks = -(-ROWS // INTERVAL)
    fill = timed(lambda: torch.zeros((chunks, g, b), dtype=torch.float32, device=dev))
    hist = torch.zeros((chunks, g, b), dtype=torch.float32, device=dev)
    split = {"fill": fill}
    for name, lib in libs.items():
        split[name] = timed(lambda: _parent_call(torch, lib, lat, group, weight, INTERVAL, g, b, hist))
    times["parent split"] = split
    print(f"parent split (static_remote, ms; kernel alone unless 'fill'): {split}")
    record["times"] = times
    (out_dir / "histogram_split.json").write_text(json.dumps(record, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
