"""``trace_window``: a window of a request trace from its threefry stream —
the wrapper around the Hopper kernel in ``csrc/trace_window.cu``.

For a ``natural`` on the card it launches the kernel (or raises); for one on
the CPU it runs the plain version, ``ref.trace_window_ref``. There is no
fallback from one to the other. ``trace_window.launches`` counts the kernel
launches: one a call. Streamed runs call it once a chunk; ``generate_trace``
once over the whole trace.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.trace_window.ref import WindowParams, trace_window_ref

__all__ = ["MAX_GRID", "trace_window"]

MAX_GRID = 132 * 16  # blocks a launch: 16 an SM of an H100, grid-stride beyond
THREADS = 256  # threads a block: the kernel's kThreads

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = [_L, _L, _L, _P, _F, _F, _F, _I, _I, _I, _P, _P, _P, _P, _I, _P]


def _lib():
    lib = _build.load("trace_window")
    if lib.trace_window_launch.argtypes is None:
        lib.trace_window_launch.argtypes, lib.trace_window_launch.restype = _ARGTYPES, ctypes.c_int
    return lib


@lru_cache(maxsize=64)
def _words(params: WindowParams) -> ctypes.Array:
    """The kernel's 27 parameter words, made once a trace (a streamed run
    launches once a chunk with the same parameters)."""
    return (ctypes.c_uint32 * 27)(*params.words())


def trace_window(
    start: int, count: int, params: WindowParams, natural: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(keys [count] int32, nodes [count] int32, is_read [count] bool)`` of
    trace positions ``[start, start + count)`` on ``natural``'s device
    (``natural`` the ``[K]`` int32 natural nodes of the trace's keys)."""
    if start < 0 or count < 0:
        raise ValueError(f"trace_window: start={start}, count={count}; need both >= 0")
    dev = natural.device
    if dev.type == "cpu":
        return trace_window_ref(start, count, params, natural)
    if dev.type != "cuda":
        raise ValueError(f"trace_window: unsupported device {dev}")
    _build.check_input("trace_window", "natural", natural, torch.int32, (natural.shape[0],), dev)
    keys = torch.empty(count, dtype=torch.int32, device=dev)
    nodes = torch.empty(count, dtype=torch.int32, device=dev)
    is_read = torch.empty(count, dtype=torch.bool, device=dev)
    if count == 0:
        return keys, nodes, is_read
    lib = _lib()
    blocks = max(1, min(MAX_GRID, -(-count // THREADS)))
    code = lib.trace_window_launch(
        start, count, params.num_requests, ctypes.addressof(_words(params)), params.p_hot, params.p_stay,
        params.p_read, int(params.skewed), params.num_nodes, params.diurnal_shifts,
        natural.data_ptr(), keys.data_ptr(), nodes.data_ptr(), is_read.data_ptr(), blocks,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "trace_window", code)
    trace_window.launches += 1
    return keys, nodes, is_read


trace_window.launches = 0
