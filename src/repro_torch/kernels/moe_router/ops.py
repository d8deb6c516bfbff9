"""``moe_router``: softmax -> top-k -> gates, ids and per-group expert
counts — the wrapper around the Hopper kernel in ``csrc/moe_router.cu``.

For CUDA tensors it checks the inputs and launches the kernel (or raises);
for CPU tensors it runs the plain version, ``ref.router_ref``. There is no
fallback from one to the other. ``moe_router.launches`` counts the kernel
launches.

One kernel block covers one group of ``group`` consecutive rows, so the
counts come out per group (``[G, E]``, what ``models/moe.py::moe_apply``
emits) rather than summed as the reference wrapper sums its tiles.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_router.ref import router_ref

__all__ = ["moe_router"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _L, _I, _I, _I, _P, _P, _P, _P]


def moe_router(logits: torch.Tensor, *, k: int, group: int):
    """logits ``[T, E]`` f32 -> ``(gates [T, K] f32, ids [T, K] int32,
    counts [ceil(T / group), E] f32)``."""
    if logits.dim() != 2:
        raise ValueError(f"moe_router: logits must be [T, E], got {tuple(logits.shape)}")
    t, e = logits.shape
    if not 1 <= k <= min(e, 32):
        raise ValueError(f"moe_router: need 1 <= k <= min(E, 32), got k={k}, E={e}")
    if group < 1:
        raise ValueError(f"moe_router: group={group}; need >= 1")
    dev = logits.device
    if dev.type == "cpu":
        return router_ref(logits, k, group)
    if dev.type != "cuda":
        raise ValueError(f"moe_router: unsupported device {dev}")
    _build.check_input("moe_router", "logits", logits, torch.float32, (t, e), dev)
    if t == 0:
        raise ValueError("moe_router: needs at least one row")

    lib = _build.load("moe_router")
    if e > lib.moe_router_max_experts():
        raise ValueError(f"moe_router: E={e} exceeds the kernel's {lib.moe_router_max_experts()}")
    gates = torch.empty((t, k), dtype=torch.float32, device=dev)
    ids = torch.empty((t, k), dtype=torch.int32, device=dev)
    counts = torch.empty((-(-t // group), e), dtype=torch.float32, device=dev)
    fn = lib.moe_router_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    code = fn(logits.data_ptr(), t, e, k, group, gates.data_ptr(), ids.data_ptr(),
              counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "moe_router", code)
    moe_router.launches += 1
    return gates, ids, counts


moe_router.launches = 0
