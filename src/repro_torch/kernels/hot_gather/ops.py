"""``hot_gather``: hot-row cache lookup — the wrapper around the Hopper
kernel in ``csrc/hot_gather.cu``.

For CUDA tensors it checks the inputs and launches the kernel (or raises);
for CPU tensors it runs the plain version, ``ref.hot_gather_ref``. There is
no fallback from one to the other. ``hot_gather.launches`` counts the kernel
launches.

The gradient is a ``torch.autograd.Function``, as the reference's is a
custom VJP (``src/repro/kernels/hot_gather/ops.py``): the backward pass
scatter-adds the row cotangents of the hits into their slots in f32 and
casts to the table's dtype. The reference's backward is a plain scatter, not
a TPU kernel, and so is this one.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hot_gather.ref import hot_gather_ref

__all__ = ["hot_gather"]

MAX_GRID = 132 * 16  # blocks per launch: 16 per SM of an H100, grid-stride beyond
DTYPES = (torch.bfloat16, torch.float32)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _L, _P, _I, _P, _I, _L, _I, _P, _P, _I, _P]


def _unit(row_bytes: int, *tensors: torch.Tensor) -> int:
    """The widest copy unit (16, 4 or 2 bytes) that divides the row and the
    tensors' addresses."""
    for unit in (16, 4, 2):
        if row_bytes % unit == 0 and all(t.data_ptr() % unit == 0 for t in tensors):
            return unit
    raise ValueError("hot_gather: rows must be a whole number of 2-byte units")


def _launch(tokens, slot_map, hot_table):
    dev = tokens.device
    (t,), (v,) = tokens.shape, slot_map.shape
    r, d = hot_table.shape
    if hot_table.dtype not in DTYPES:
        raise TypeError(f"hot_gather: hot_table has dtype {hot_table.dtype}, expected one of {DTYPES}")
    _build.check_input("hot_gather", "tokens", tokens, torch.int32, (t,), dev)
    _build.check_input("hot_gather", "slot_map", slot_map, torch.int32, (v,), dev)
    _build.check_input("hot_gather", "hot_table", hot_table, hot_table.dtype, (r, d), dev)
    if t == 0 or r == 0 or d == 0:
        raise ValueError("hot_gather: needs at least one token, one slot and one column")

    rows = torch.empty((t, d), dtype=hot_table.dtype, device=dev)
    hit = torch.empty(t, dtype=torch.bool, device=dev)
    row_bytes = d * hot_table.element_size()
    lib = _build.load("hot_gather")
    fn = lib.hot_gather_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    warps_per_block = lib.hot_gather_threads() // 32
    grid = min(-(-t // warps_per_block), MAX_GRID)
    code = fn(
        tokens.data_ptr(), t, slot_map.data_ptr(), v, hot_table.data_ptr(), r, row_bytes,
        _unit(row_bytes, hot_table, rows), rows.data_ptr(), hit.data_ptr(), grid,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "hot_gather", code)
    hot_gather.launches += 1
    return rows, hit


class _HotGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, slot_map, hot_table):
        dev = tokens.device
        if dev.type == "cpu":
            rows, hit = hot_gather_ref(tokens, slot_map, hot_table)
        elif dev.type == "cuda":
            rows, hit = _launch(tokens, slot_map, hot_table)
        else:
            raise ValueError(f"hot_gather: unsupported device {dev}")
        ctx.save_for_backward(tokens, slot_map)
        ctx.table_shape, ctx.table_dtype = hot_table.shape, hot_table.dtype
        ctx.mark_non_differentiable(hit)
        return rows, hit

    @staticmethod
    def backward(ctx, g_rows, _g_hit):
        tokens, slot_map = ctx.saved_tensors
        slots = slot_map[tokens.long()].long()
        hit = slots >= 0
        g_table = torch.zeros(ctx.table_shape, dtype=torch.float32, device=g_rows.device)
        g_table.index_add_(0, slots[hit], g_rows[hit].to(torch.float32))
        return None, None, g_table.to(ctx.table_dtype)


def hot_gather(tokens: torch.Tensor, slot_map: torch.Tensor, hot_table: torch.Tensor):
    """tokens ``[T]`` int32, slot_map ``[V]`` int32 (-1 = cold), hot_table
    ``[R, D]`` bf16 or f32 -> ``(rows [T, D]`` in the table's dtype, zeros on
    a miss, ``hit [T] bool)``. Differentiable in ``hot_table``."""
    return _HotGather.apply(tokens, slot_map, hot_table)


hot_gather.launches = 0
