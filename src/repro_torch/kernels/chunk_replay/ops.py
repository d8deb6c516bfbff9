"""``chunk_replay``: one chunk's fused request path — the wrapper around
the Hopper kernel in ``csrc/chunk_replay.cu``.

For CUDA tensors it checks the inputs and launches the kernel (or raises);
for CPU tensors it runs the plain version, ``ref.chunk_replay_ref``. There
is no fallback from one to the other. ``chunk_replay.launches`` counts the
kernel launches: one a call.

A call allocates its outputs in one buffer and nothing else. A chunk
(up to 16,384 requests on up to 8 nodes) runs as one thread-block cluster
and combines in shared memory; a larger launch uses scratch (per-block
partial rows, the last-block ticket, a grid barrier and the histogram
accumulator, the last three left zero by the kernel; with many requests a
key, a byte-a-key copy of the map), kept per device and stream
(``_scratch``). ``launch_shape`` is the rule.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunk_replay.ref import READ_MODES, chunk_latency_ref, chunk_replay_ref

__all__ = ["MAX_NODES", "MAX_GRID", "THREADS", "CLUSTER_THREADS", "CLUSTER_MAX", "PER_THREAD",
           "PACK_RATIO", "launch_shape", "vector_io", "chunk_replay", "chunk_latency"]

MAX_NODES = 64  # the [N, N] RTT matrix and busy planes live in shared memory
THREADS = 128  # threads a block of a grid-stride launch (the kernel's kThreads)
CLUSTER_THREADS = 512  # threads a block of a one-cluster launch
CLUSTER_MAX = 8  # blocks of a cluster (the portable bound)
CLUSTER_NODES = 8  # the most nodes a cluster launch takes (its replica-set tables)
PER_THREAD = 4  # requests a thread takes per step
NUM_SMS = 132  # H100 SXM
MAX_GRID = NUM_SMS * 8  # blocks of a grid-stride launch at most (the kernel caps it
# again at the blocks that fit on the card at once)
_READ_MODE_CODE = {"map": 0, "no_local": 1, "ideal": 2}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_P] * 7 + [_L] + [_I] * 4 + [_F] * 5 + [_I] * 3 + [_P] * 9 + [_I, _I, _P]
MODES = ("grid", "cluster", "packed")  # the kernel's launch modes, by code
PACK_RATIO = 4  # a packed launch from this many requests a key up

# (device index, stream) -> [part_f [MAX_GRID, MAX_NODES + 1] f64, part_i
# [MAX_GRID, 3] i32, sync [2 + hist words] i32 (zero between calls), packed
# [K] u8 map or None].
_scratch: dict[tuple[int, int], list] = {}


def launch_shape(b: int, n: int, k: int) -> tuple[str, int, int]:
    """``(mode, threads, blocks)`` of a launch over ``b`` requests on ``n``
    nodes against a ``k``-key map.

    * ``"cluster"``: up to ``CLUSTER_MAX * CLUSTER_THREADS`` steps of four
      requests (16,384 requests) on up to 8 nodes, one step a thread in one
      thread-block cluster of a power-of-two count of 512-thread blocks (a
      10,000-request chunk: 8 blocks), combined in distributed shared
      memory;
    * ``"packed"``: at least ``PACK_RATIO`` requests a key on up to 8 nodes
      (the static path's whole trace): the map packed to a byte a key first,
      behind a grid barrier, so that a request reads one byte and the hot
      keys stay in L1;
    * ``"grid"``: otherwise. The last two take 128-thread blocks, one step a
      thread up to ``MAX_GRID`` blocks and a grid-stride loop beyond (the
      kernel caps the blocks again at those that fit on the card at once)."""
    groups = -(-b // PER_THREAD)
    if n <= CLUSTER_NODES and groups <= CLUSTER_MAX * CLUSTER_THREADS:
        blocks = 1
        while blocks * CLUSTER_THREADS < groups:
            blocks *= 2
        return "cluster", CLUSTER_THREADS, blocks
    mode = "packed" if n <= CLUSTER_NODES and b >= PACK_RATIO * k else "grid"
    return mode, THREADS, max(1, min(-(-groups // THREADS), MAX_GRID))


def vector_io(aligned16: list[int], aligned4: list[int]) -> bool:
    """Whether the kernel may move four requests a thread as vectors: the
    addresses of its 4-byte-per-request arrays (keys, nodes, extra_ms,
    lat_out) 16-byte aligned and of its 1-byte ones (is_read, valid,
    hit_out) 4-byte aligned. A view at another offset takes scalar loads."""
    return all(p % 16 == 0 for p in aligned16) and all(p % 4 == 0 for p in aligned4)


def _scratch_for(dev: torch.device, stream: int, hist_words: int, packed_keys: int):
    key = (dev.index, stream)
    got = _scratch.get(key)
    if got is None or got[2].numel() < 2 + hist_words:
        got = _scratch[key] = [
            torch.empty(MAX_GRID * (MAX_NODES + 1), dtype=torch.float64, device=dev),
            torch.empty(MAX_GRID * 3, dtype=torch.int32, device=dev),
            torch.zeros(2 + hist_words, dtype=torch.int32, device=dev),
            None if got is None else got[3],
        ]
    if packed_keys and (got[3] is None or got[3].numel() < packed_keys):
        got[3] = torch.empty(packed_keys, dtype=torch.uint8, device=dev)
    return got


def _launcher():
    lib = _build.load("chunk_replay")
    fn = lib.chunk_replay_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return lib, fn


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
    lat_out: torch.Tensor | None = None,  # [B] f32, written when given
    hit_out: torch.Tensor | None = None,  # [B] bool, written when given
):
    """Returns ``(busy [N] f32, lat_sum f32, hits i64, reads i64,
    count i64, hist)``; ``hist`` is the ``[2N, num_bins]`` int32 grouped
    latency histogram, ``None`` when ``num_bins == 0``. ``lat_out`` and
    ``hit_out``, when passed, receive each request's latency (after
    ``extra_ms`` and the valid mask) and read-hit flag. Key and node ids
    must lie in range (the kernel clamps them, as a JAX gather does)."""
    if read_mode not in READ_MODES:
        raise ValueError(f"unknown read_mode {read_mode!r}; expected one of {READ_MODES}")
    kw = dict(
        service_ms=service_ms, master=master, xfer_read_ms=xfer_read_ms,
        xfer_write_ms=xfer_write_ms, read_mode=read_mode, num_bins=num_bins,
        lo=lo, hi=hi, extra_ms=extra_ms, lat_out=lat_out, hit_out=hit_out,
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
    if lat_out is not None:
        _build.check_input("chunk_replay", "lat_out", lat_out, torch.float32, (b,), dev)
    if hit_out is not None:
        _build.check_input("chunk_replay", "hit_out", hit_out, torch.bool, (b,), dev)

    if b == 0 or k == 0:
        raise ValueError("chunk_replay: needs at least one request and one key")

    lib, fn = _launcher()
    mode, _, blocks = launch_shape(b, n, k)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part_f, part_i, sync, packed = _scratch_for(dev, stream, 2 * n * num_bins,
                                                k if mode == "packed" else 0)
    # One buffer for every output: busy and lat_sum (f32), hits, reads and
    # count (i64, 8-byte aligned), the histogram (i32), written whole.
    lead = 2 * (-(-(n + 1) // 2))
    out = torch.empty(lead + 6 + 2 * n * num_bins, dtype=torch.int32, device=dev)
    out_f = out[: n + 1].view(torch.float32)
    out_i = out[lead : lead + 6].view(torch.int64)
    hist = out[lead + 6 :].view(2 * n, num_bins) if num_bins else None
    opt = [x for x in (extra_ms, lat_out) if x is not None]
    vec = vector_io([keys.data_ptr(), nodes.data_ptr()] + [x.data_ptr() for x in opt],
                    [is_read.data_ptr(), valid.data_ptr()]
                    + ([hit_out.data_ptr()] if hit_out is not None else []))
    code = fn(
        hosts.data_ptr(), keys.data_ptr(), nodes.data_ptr(),
        is_read.data_ptr(), valid.data_ptr(), rtt.data_ptr(),
        None if extra_ms is None else extra_ms.data_ptr(),
        b, k, n, _READ_MODE_CODE[read_mode], master,
        float(service_ms), float(xfer_read_ms), float(xfer_write_ms), float(lo), float(hi),
        num_bins, int(vec), int(hosts.data_ptr() % 16 == 0 and k * n < 2**31),
        part_f.data_ptr(), part_i.data_ptr(), sync.data_ptr(),
        packed.data_ptr() if mode == "packed" else None, out_f.data_ptr(), out_i.data_ptr(),
        None if hist is None else hist.data_ptr(),
        None if lat_out is None else lat_out.data_ptr(),
        None if hit_out is None else hit_out.data_ptr(),
        MODES.index(mode), blocks, stream,
    )
    _build.check(lib, "chunk_replay", code)
    chunk_replay.launches += 1
    return out_f[:n], out_f[n], out_i[0], out_i[1], out_i[2], hist


chunk_replay.launches = 0


def chunk_latency(
    hosts: torch.Tensor,  # [K, N] bool
    keys: torch.Tensor,  # [B] int32
    nodes: torch.Tensor,  # [B] int32
    is_read: torch.Tensor,  # [B] bool
    rtt: torch.Tensor,  # [N, N] f32
    *,
    service_ms: float,
    master: int,
    xfer_read_ms: float,
    xfer_write_ms: float,
    read_mode: str,
):
    """Per-request latency + read-hit flags: ``(lat [B] f32, hits [B] bool)``.
    On the CPU ``ref.chunk_latency_ref``; on the card one ``chunk_replay``
    launch with every row valid, writing both through ``lat_out`` and
    ``hit_out`` (the same bits: phase 2 of ``chip_smoke.py`` holds them)."""
    kw = dict(service_ms=service_ms, master=master, xfer_read_ms=xfer_read_ms,
              xfer_write_ms=xfer_write_ms, read_mode=read_mode)
    if rtt.device.type == "cpu":
        if read_mode not in READ_MODES:
            raise ValueError(f"unknown read_mode {read_mode!r}; expected one of {READ_MODES}")
        return chunk_latency_ref(hosts, keys, nodes, is_read, rtt, **kw)
    b = keys.shape[0]
    lat = torch.empty(b, dtype=torch.float32, device=rtt.device)
    hits = torch.empty(b, dtype=torch.bool, device=rtt.device)
    valid = torch.ones(b, dtype=torch.bool, device=rtt.device)
    chunk_replay(hosts, keys, nodes, is_read, valid, rtt, lat_out=lat, hit_out=hits, **kw)
    return lat, hits
