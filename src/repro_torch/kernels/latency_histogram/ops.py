"""``latency_histogram``: bucketize + grouped weighted fold — the wrapper
around the Hopper kernel in ``csrc/latency_histogram.cu``.

For CUDA tensors it checks the inputs and launches the kernel (or raises);
for CPU tensors it runs the plain version (``ref.latency_histogram_ref``,
or ``ref.latency_histogram_chunks_ref`` for the per-chunk form). There is
no fallback from one to the other. ``latency_histogram.launches`` counts
the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.latency_histogram.ref import (
    latency_histogram_chunks_ref,
    latency_histogram_ref,
)

__all__ = ["MAX_SHARED_BYTES", "latency_histogram"]

MAX_SHARED_BYTES = 232_448  # shared memory one block may take on an H100
ROWS_PER_BLOCK = 4096  # rows one block folds in the per-chunk form
MAX_GRID = 132 * 8  # blocks of the flat form: 8 per SM, grid-stride beyond
MAX_TILES = 65_535  # the grid's y extent

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _L, _L, _I, _I, _I, _I, _F, _F, _P, _P]


def latency_histogram(
    lat: torch.Tensor,  # [R] f32 per-request latency (ms)
    group: torch.Tensor,  # [R] int32 group id in [0, num_groups)
    weight: torch.Tensor,  # [R] f32 per-request weight (0 masks a row)
    *,
    num_groups: int,
    num_bins: int = 128,
    lo: float = 1.0,
    hi: float = 10_000.0,
    rows_per_chunk: int | None = None,
) -> torch.Tensor:
    """The ``[num_groups, num_bins]`` f32 grouped log-bin histogram, or with
    ``rows_per_chunk`` the ``[C, num_groups, num_bins]`` per-chunk form
    (``C = ceil(R / rows_per_chunk)``; the last chunk may be short)."""
    if num_bins < 3:
        raise ValueError(f"latency_histogram: num_bins={num_bins}; need >= 3")
    if num_groups < 1:
        raise ValueError(f"latency_histogram: num_groups={num_groups}; need >= 1")
    if not 0.0 < lo < hi:
        raise ValueError(f"latency_histogram: need 0 < lo < hi, got lo={lo} hi={hi}")
    if rows_per_chunk is not None and rows_per_chunk < 1:
        raise ValueError(f"latency_histogram: rows_per_chunk={rows_per_chunk}; need >= 1")
    kw = dict(num_groups=num_groups, num_bins=num_bins, lo=lo, hi=hi)
    dev = lat.device
    if dev.type == "cpu":
        if rows_per_chunk is None:
            return latency_histogram_ref(lat, group, weight, **kw)
        return latency_histogram_chunks_ref(lat, group, weight, rows_per_chunk=rows_per_chunk, **kw)
    if dev.type != "cuda":
        raise ValueError(f"latency_histogram: unsupported device {dev}")

    r = lat.shape[0]
    smem = 4 * num_groups * num_bins
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"latency_histogram: a [{num_groups}, {num_bins}] f32 histogram takes "
            f"{smem} B of shared memory; one block may take {MAX_SHARED_BYTES}"
        )
    _build.check_input("latency_histogram", "lat", lat, torch.float32, (r,), dev)
    _build.check_input("latency_histogram", "group", group, torch.int32, (r,), dev)
    _build.check_input("latency_histogram", "weight", weight, torch.float32, (r,), dev)

    if rows_per_chunk is None:
        chunks, rpc = 1, max(r, 1)
        tiles = min(-(-r // ROWS_PER_BLOCK), MAX_GRID)
    else:
        chunks, rpc = -(-r // rows_per_chunk), rows_per_chunk
        tiles = min(-(-rpc // ROWS_PER_BLOCK), MAX_TILES)
    hist = torch.zeros((chunks, num_groups, num_bins), dtype=torch.float32, device=dev)
    if r > 0:
        lib = _build.load("latency_histogram")
        fn = lib.latency_histogram_launch
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        code = fn(
            lat.data_ptr(), group.data_ptr(), weight.data_ptr(), r, rpc, chunks,
            tiles, num_groups, num_bins, float(lo), float(hi), hist.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, "latency_histogram", code)
        latency_histogram.launches += 1
    return hist[0] if rows_per_chunk is None else hist


latency_histogram.launches = 0
