"""``chunk_replay``: one chunk's fused request path — the wrapper around
the Hopper kernel in ``csrc/chunk_replay.cu``.

For CUDA tensors it checks the inputs and launches the kernel (or raises);
for CPU tensors it runs the plain version, ``ref.chunk_replay_ref``. There
is no fallback from one to the other. ``chunk_replay.launches`` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunk_replay.ref import READ_MODES, chunk_replay_ref

__all__ = ["MAX_NODES", "MAX_GRID", "chunk_replay"]

MAX_NODES = 64  # the [N, N] RTT matrix and busy planes live in shared memory
MAX_GRID = 132 * 8  # blocks per launch: 8 per SM of an H100, grid-stride beyond
_READ_MODE_CODE = {"map": 0, "no_local": 1, "ideal": 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 7 + [_I] * 5 + [_F] * 5 + [_I] + [_P] * 5 + [_I, _P]


def chunk_replay(
    hosts: torch.Tensor,  # [K, N] bool frozen replica map
    keys: torch.Tensor,  # [B] int32
    nodes: torch.Tensor,  # [B] int32
    is_read: torch.Tensor,  # [B] bool
    valid: torch.Tensor,  # [B] bool (False masks rows)
    rtt: torch.Tensor,  # [N, N] f32
    *,
    service_ms: float,
    master: int,
    xfer_read_ms: float,
    xfer_write_ms: float,
    read_mode: str,
    num_bins: int = 0,
    lo: float = 1.0,
    hi: float = 10_000.0,
    extra_ms: torch.Tensor | None = None,  # [B] f32 per-request surcharge
):
    """Returns ``(busy [N] f32, lat_sum f32, hits i64, reads i64,
    count i64, hist)``; ``hist`` is the ``[2N, num_bins]`` int32 grouped
    latency histogram, ``None`` when ``num_bins == 0``. Key and node ids
    must lie in range (the kernel clamps them, as a JAX gather does)."""
    if read_mode not in READ_MODES:
        raise ValueError(f"unknown read_mode {read_mode!r}; expected one of {READ_MODES}")
    kw = dict(
        service_ms=service_ms, master=master, xfer_read_ms=xfer_read_ms,
        xfer_write_ms=xfer_write_ms, read_mode=read_mode, num_bins=num_bins,
        lo=lo, hi=hi, extra_ms=extra_ms,
    )
    dev = rtt.device
    if dev.type == "cpu":
        return chunk_replay_ref(hosts, keys, nodes, is_read, valid, rtt, **kw)
    if dev.type != "cuda":
        raise ValueError(f"chunk_replay: unsupported device {dev}")

    k, n = hosts.shape
    b = keys.shape[0]
    if not 1 <= n <= MAX_NODES:
        raise ValueError(f"chunk_replay: N={n} nodes; the kernel takes 1..{MAX_NODES}")
    if not 0 <= master < n:
        raise ValueError(f"chunk_replay: master={master} is not a node of N={n}")
    if num_bins != 0 and num_bins < 3:
        raise ValueError(f"chunk_replay: num_bins={num_bins}; need 0 or >= 3")
    _build.check_input("chunk_replay", "hosts", hosts, torch.bool, (k, n), dev)
    _build.check_input("chunk_replay", "keys", keys, torch.int32, (b,), dev)
    _build.check_input("chunk_replay", "nodes", nodes, torch.int32, (b,), dev)
    _build.check_input("chunk_replay", "is_read", is_read, torch.bool, (b,), dev)
    _build.check_input("chunk_replay", "valid", valid, torch.bool, (b,), dev)
    _build.check_input("chunk_replay", "rtt", rtt, torch.float32, (n, n), dev)
    if extra_ms is not None:
        _build.check_input("chunk_replay", "extra_ms", extra_ms, torch.float32, (b,), dev)

    if b == 0 or k == 0:
        raise ValueError("chunk_replay: needs at least one request and one key")

    f32 = dict(dtype=torch.float32, device=dev)
    lib = _build.load("chunk_replay")
    fn = lib.chunk_replay_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    threads = lib.chunk_replay_threads()
    grid = min(-(-b // threads), MAX_GRID)
    fpart = torch.empty((grid, n + 1), **f32)
    ipart = torch.empty((grid, 3), dtype=torch.int32, device=dev)
    out_f = torch.empty(n + 1, **f32)
    out_i = torch.empty(3, dtype=torch.int64, device=dev)
    hist = (
        torch.zeros((2 * n, num_bins), dtype=torch.int32, device=dev)
        if num_bins else None
    )
    code = fn(
        hosts.data_ptr(), keys.data_ptr(), nodes.data_ptr(),
        is_read.data_ptr(), valid.data_ptr(), rtt.data_ptr(),
        None if extra_ms is None else extra_ms.data_ptr(),
        b, k, n, _READ_MODE_CODE[read_mode], master,
        float(service_ms), float(xfer_read_ms), float(xfer_write_ms),
        float(lo), float(hi), num_bins,
        fpart.data_ptr(), ipart.data_ptr(), out_f.data_ptr(), out_i.data_ptr(),
        None if hist is None else hist.data_ptr(),
        grid, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "chunk_replay", code)
    chunk_replay.launches += 1
    return out_f[:n], out_f[n], out_i[0], out_i[1], out_i[2], hist


chunk_replay.launches = 0
