"""``flash_decode``: one query token per sequence against its KV cache —
the wrapper around the Hopper kernel in ``csrc/flash_decode.cu``.

For CUDA tensors it checks the inputs and launches the kernel once (the
splits of the cache and their combine in the same launch) or raises;
``flash_decode.launches`` counts the launches. For CPU tensors it runs the
plain version, ``ref.flash_decode_ref``. There is no fallback from one to
the other. It takes the model layout of the reference's
``ops.flash_decode`` (q ``[B, H, D]``, cache ``[B, T, KH, D]``) and reads a
layer's cache slice in place.

The cache axis is cut into splits of ``split_length(B, KH, T)`` positions:
``num_splits`` of them, a block each per (sequence, kv head). A block holds
every q head of its kv head (up to ``MAX_HEADS``; a larger group is cut
into ``head_groups`` even groups), so the cache is read once. The splits
are merged in the same launch; the wrapper allocates their partial results
and the merge's counters.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

__all__ = ["flash_decode", "split_length", "num_splits", "head_groups", "HEAD_DIMS", "DTYPES",
           "TILE", "MAX_SPLIT", "MAX_HEADS", "NUM_SMS"]

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)

TILE = 64  # cache positions a tile of the kernel (``kTile``)
MAX_SPLIT = 256  # positions a split at most: ragged serving lengths stay balanced
MAX_HEADS = 16  # q heads a block at most (``kHeads``: the M of mma.sync m16n8k16)
NUM_SMS = 132  # H100 SXM

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 8 + [_I] * 6 + [_F, _I, _P]
_counters: dict[tuple, torch.Tensor] = {}  # by (device, stream): 0 between launches


def split_length(b: int, kh: int, t: int) -> int:
    """Cache positions a split covers: the longest multiple of ``TILE`` up
    to ``MAX_SPLIT`` whose splits give ``b * kh * splits >= NUM_SMS``
    blocks, else one tile (the most splits ``t`` allows)."""
    tiles = -(-t // TILE)
    for n in range(MAX_SPLIT // TILE, 1, -1):
        if b * kh * -(-tiles // n) >= NUM_SMS:
            return n * TILE
    return TILE


def num_splits(b: int, kh: int, t: int) -> int:
    """Splits of a ``t``-slot cache at ``b`` sequences and ``kh`` kv heads:
    the grid's first axis."""
    return -(-t // split_length(b, kh, t))


def head_groups(group: int) -> int:
    """Blocks a (sequence, kv head, split) takes for ``group`` q heads a kv
    head: one up to ``MAX_HEADS``."""
    return -(-group // MAX_HEADS)


def _counter_buffer(dev: torch.device, rows: int, stream: int) -> torch.Tensor:
    """The kernel's counters (two a row: arrivals and departures), zeroed
    once and left at 0 by every launch. One buffer a stream, so calls on two
    streams never share a counter."""
    key = (dev.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < rows:
        buf = torch.zeros(max(rows, 4096), dtype=torch.int32, device=dev)
        _counters[key] = buf
    return buf


def _launch(q, k_cache, v_cache, lengths, split: int | None = None) -> torch.Tensor:
    """Launch the kernel with ``split_length``'s splits, or ``split``
    positions a split where a measurement names it."""
    dev = q.device
    b, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_decode: q has dtype {q.dtype}, expected one of {DTYPES}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {d} is not one of {HEAD_DIMS}")
    if kh == 0 or h % kh:
        raise ValueError(f"flash_decode: {h} q heads do not group over {kh} kv heads")
    _build.check_input("flash_decode", "q", q, q.dtype, (b, h, d), dev)
    _build.check_input("flash_decode", "k_cache", k_cache, q.dtype, (b, t, kh, d), dev)
    _build.check_input("flash_decode", "v_cache", v_cache, q.dtype, (b, t, kh, d), dev)
    _build.check_input("flash_decode", "lengths", lengths, torch.int32, (b,), dev)
    if b == 0 or t == 0:
        raise ValueError("flash_decode: needs at least one sequence and one cache slot")
    if any(x.data_ptr() % 16 for x in (q, k_cache, v_cache)):
        raise ValueError("flash_decode: q and the caches must be 16-byte aligned")
    split = split or split_length(b, kh, t)
    if split % TILE:
        raise ValueError(f"flash_decode: a split of {split} positions is not a multiple of {TILE}")
    splits = -(-t // split)
    lib = _build.load("flash_decode")
    stream = torch.cuda.current_stream(dev).cuda_stream
    part_acc = torch.empty((b, h, splits, d), dtype=torch.float32, device=dev)
    part_ml = torch.empty((b, h, splits, 2), dtype=torch.float32, device=dev)
    counters = _counter_buffer(dev, 2 * b * kh * head_groups(h // kh), stream)
    o = torch.empty_like(q)
    fn = lib.flash_decode_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    code = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), counters.data_ptr(), o.data_ptr(), b, t, h, kh, d,
        split, float(d**-0.5), int(q.dtype == torch.bfloat16), stream,
    )
    _build.check(lib, "flash_decode", code)
    flash_decode.launches += 1
    return o


def flash_decode(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [B, T, KH, D]
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32
) -> torch.Tensor:
    """Attention of each sequence's one query over its first
    ``min(lengths[b], T)`` cache positions, ``[B, H, D]`` in q's dtype
    (bf16 or f32). A length of 0 masks every position, and then, as in the
    reference, the whole cache is weighed alike (the mean of v)."""
    dev = q.device
    if dev.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, lengths)
    if dev.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {dev}")
    return _launch(q, k_cache, v_cache, lengths)


flash_decode.launches = 0
