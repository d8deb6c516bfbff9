"""``latency_histogram``: bucketize + grouped weighted fold — the wrapper
around the Hopper kernel in ``csrc/latency_histogram.cu``.

For CUDA tensors it checks the inputs and launches the kernel (or raises);
for CPU tensors it runs the plain version (``ref.latency_histogram_ref``,
or ``ref.latency_histogram_chunks_ref`` for the per-chunk form). There is
no fallback from one to the other. ``latency_histogram.launches`` counts
the histogram kernel's launches: one a call.

The kernel bins a row by counting the thresholds of the bin rule below it
(``csrc/latency_histogram.cu``). The thresholds come from a set-up launch
the first time a process uses a ``(lo, hi, num_bins)`` on a device, and are
kept (``_tables``); ``latency_histogram.setup_launches`` counts those
launches apart. ``check_bin_rule`` holds a table against the rule on all
2**32 f32 bit patterns. The kernel lays out its shared memory itself and
says how many of its blocks fit on the card at once; from that count
``launch_shape`` shares the rows out: a block a chunk, its slice stored
with no fill, or tiles of a chunk added into a zeroed output when the
chunks are too few to fill the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.latency_histogram.ref import (
    latency_histogram_chunks_ref,
    latency_histogram_ref,
)

__all__ = ["MAX_SHARED_BYTES", "MODES", "MIN_TILE_ROWS", "table_depth", "launch_shape",
           "vector_io", "check_bin_rule", "latency_histogram"]

MAX_SHARED_BYTES = 232_448  # shared memory one block may take on an H100
MIN_TILE_ROWS = 4096  # a chunk is split into tiles of no fewer rows
MODES = ("chunk", "split")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P]
_RESIDENT_ARGTYPES = [_I, _I, _I, _P]
_THRESHOLD_ARGTYPES = [_F, _F, _I, _I, _P, _P]
_CHECK_ARGTYPES = [_F, _F, _I, _I, _P, _P, _P]

# (device index, lo, hi, num_bins) -> (the [2**depth] f32 threshold table,
# the stream of its set-up launch, an event recorded after it).
_tables: dict[tuple, tuple[torch.Tensor, int, torch.cuda.Event]] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def table_depth(num_bins: int) -> int:
    """Levels of the threshold tree: the least ``d`` with ``2**d - 1 >=
    num_bins - 1`` (7 for 128 bins)."""
    return (num_bins - 1).bit_length()


def launch_shape(r: int, rows_per_chunk: int | None, resident: int) -> tuple[str, int, int, int]:
    """``(mode, blocks, tiles, span)`` of a launch over ``r >= 1`` rows,
    ``resident`` the blocks that fit on the card at once (the kernel's
    occupancy query).

    Work items are ``(chunk, tile)`` pairs, ``tiles`` a chunk; tile ``t``
    of a chunk takes its rows from ``t * span`` on, ``span`` of them at
    most (a multiple of 4; the last tiles of a chunk may be short or
    empty), so ``tiles * span`` covers the chunk. ``blocks`` blocks take
    the items in turn, block ``b`` the items ``b, b + blocks, ...``.

    * ``"chunk"`` (``tiles == 1``): at least ``resident`` chunks, or
      chunks too short to split (the static path's 10,000 chunks of 10,000
      rows): a block folds a whole chunk and stores its slice, no fill;
    * ``"split"``: fewer chunks than that (the flat ``[G, B]`` form): each
      is cut into up to ``resident / chunks`` tiles of at least
      ``MIN_TILE_ROWS`` rows, added into an output zeroed first."""
    rpc = r if rows_per_chunk is None else rows_per_chunk
    chunks = _cdiv(r, rpc)
    rows = min(rpc, r)
    tiles = 1 if chunks >= resident else max(1, min(_cdiv(resident, chunks), rows // MIN_TILE_ROWS))
    span = _cdiv(_cdiv(rows, tiles), 4) * 4
    return MODES[tiles > 1], min(chunks * tiles, resident), tiles, span


def vector_io(ptrs: list[int]) -> bool:
    """Whether the kernel may read rows as 16-byte vectors: every input
    pointer 16-byte aligned (a view at another offset takes scalar loads)."""
    return all(p % 16 == 0 for p in ptrs)


def _lib():
    lib = _build.load("latency_histogram")
    for fn, argtypes in ((lib.latency_histogram_launch, _ARGTYPES),
                         (lib.latency_histogram_resident, _RESIDENT_ARGTYPES),
                         (lib.latency_histogram_thresholds_launch, _THRESHOLD_ARGTYPES),
                         (lib.latency_histogram_check_launch, _CHECK_ARGTYPES)):
        if fn.argtypes is None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def _cuda_device(device) -> torch.device:
    dev = torch.device(device)
    return torch.device("cuda", torch.cuda.current_device()) if dev.index is None else dev


def _table(lib, dev: torch.device, lo: float, hi: float, num_bins: int) -> torch.Tensor:
    """The threshold table of a rule on ``dev``, set up on first use and
    ordered before the current stream's next work."""
    stream = torch.cuda.current_stream(dev)
    key = (dev.index, float(lo), float(hi), num_bins)
    if key not in _tables:
        depth = table_depth(num_bins)
        table = torch.empty(1 << depth, dtype=torch.float32, device=dev)
        code = lib.latency_histogram_thresholds_launch(float(lo), float(hi), num_bins, depth,
                                                        table.data_ptr(), stream.cuda_stream)
        _build.check(lib, "latency_histogram", code)
        latency_histogram.setup_launches += 1
        done = torch.cuda.Event()
        done.record(stream)
        _tables[key] = (table, stream.cuda_stream, done)
    table, made_on, done = _tables[key]
    if made_on != stream.cuda_stream:
        stream.wait_event(done)
    return table


def check_bin_rule(lo: float, hi: float, num_bins: int, device) -> tuple[int, int | None]:
    """``(mismatches, least mismatching bit pattern or None)`` between the
    kernel's threshold count and ``bin_of`` over all 2**32 f32 bit patterns,
    on the card."""
    dev = _cuda_device(device)
    lib = _lib()
    table = _table(lib, dev, lo, hi, num_bins)
    out = torch.empty(2, dtype=torch.int64, device=dev)
    code = lib.latency_histogram_check_launch(float(lo), float(hi), num_bins,
                                              table_depth(num_bins), table.data_ptr(),
                                              out.data_ptr(),
                                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "latency_histogram", code)
    bad, first = out.tolist()
    return bad, (first & 0xFFFFFFFF) if bad else None


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
    if 4 * num_groups * num_bins > MAX_SHARED_BYTES:
        raise ValueError(
            f"latency_histogram: a [{num_groups}, {num_bins}] f32 histogram takes "
            f"{4 * num_groups * num_bins} B of shared memory; one block may take "
            f"{MAX_SHARED_BYTES}"
        )
    _build.check_input("latency_histogram", "lat", lat, torch.float32, (r,), dev)
    _build.check_input("latency_histogram", "group", group, torch.int32, (r,), dev)
    _build.check_input("latency_histogram", "weight", weight, torch.float32, (r,), dev)

    chunks = 1 if rows_per_chunk is None else _cdiv(r, rows_per_chunk)
    if r == 0:
        hist = torch.zeros((chunks, num_groups, num_bins), dtype=torch.float32, device=dev)
        return hist[0] if rows_per_chunk is None else hist
    hist = torch.empty((chunks, num_groups, num_bins), dtype=torch.float32, device=dev)
    lib = _lib()
    table = _table(lib, dev, lo, hi, num_bins)
    depth = table_depth(num_bins)
    resident = ctypes.c_int(0)
    code = lib.latency_histogram_resident(num_groups, num_bins, depth, ctypes.addressof(resident))
    _build.check(lib, "latency_histogram", code)
    _, blocks, tiles, span = launch_shape(r, rows_per_chunk, resident.value)
    code = lib.latency_histogram_launch(
        lat.data_ptr(), group.data_ptr(), weight.data_ptr(), r,
        r if rows_per_chunk is None else rows_per_chunk, span, chunks, tiles, blocks,
        num_groups, num_bins, table.data_ptr(), depth,
        int(vector_io([lat.data_ptr(), group.data_ptr(), weight.data_ptr()])),
        hist.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "latency_histogram", code)
    latency_histogram.launches += 1
    return hist[0] if rows_per_chunk is None else hist


latency_histogram.launches = 0
latency_histogram.setup_launches = 0
