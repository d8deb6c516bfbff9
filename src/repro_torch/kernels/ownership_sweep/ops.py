"""``ownership_sweep``: Algorithm 3's analysis pass — the wrapper around
the Hopper kernel in ``csrc/ownership_sweep.cu``.

For CUDA tensors it checks the inputs and launches the kernel (or raises);
for CPU tensors it runs the plain version, ``ref.sweep_ref``. There is no
fallback from one to the other. ``ownership_sweep.launches`` counts the
kernel launches. ``h`` crosses into the kernel as a C ``float``, so
``f >= H`` is decided in f32 (ties at ``f == H`` are common).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ownership_sweep.ref import sweep_ref

__all__ = ["ownership_sweep"]

MAX_GRID = 132 * 8  # blocks per launch: 8 per SM of an H100, tiles grid-stride beyond

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _I] + [_P] * 3 + [_I] * 3 + [_F, _I] + [_P] * 5 + [_I, _P]


def ownership_sweep(
    counts: torch.Tensor,  # [K, N] int32 access counts or f32 EMA traffic
    hosts: torch.Tensor,  # [K, N] bool current replica map
    live: torch.Tensor,  # [K] bool
    last_access: torch.Tensor,  # [K] int32 ticks
    now: int,
    *,
    h: float,
    expiry: int = 0,
):
    """Returns ``(owners, add, drop, expired, f)`` — bool ``[K, N]`` ×3,
    bool ``[K]``, f32 ``[K, N]``. ``expiry <= 0`` disables expiry."""
    dev = counts.device
    if dev.type == "cpu":
        return sweep_ref(counts, hosts, live, last_access, now, h=h, expiry=expiry)
    if dev.type != "cuda":
        raise ValueError(f"ownership_sweep: unsupported device {dev}")
    k, n = counts.shape
    if counts.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"ownership_sweep: counts has dtype {counts.dtype}, expected int32 or float32")
    _build.check_input("ownership_sweep", "counts", counts, counts.dtype, (k, n), dev)
    _build.check_input("ownership_sweep", "hosts", hosts, torch.bool, (k, n), dev)
    _build.check_input("ownership_sweep", "live", live, torch.bool, (k,), dev)
    _build.check_input("ownership_sweep", "last_access", last_access, torch.int32, (k,), dev)

    if k == 0 or n == 0:
        raise ValueError("ownership_sweep: needs at least one key and one node")

    owners = torch.empty((k, n), dtype=torch.bool, device=dev)
    add = torch.empty_like(owners)
    drop = torch.empty_like(owners)
    expired = torch.empty(k, dtype=torch.bool, device=dev)
    f = torch.empty((k, n), dtype=torch.float32, device=dev)

    lib = _build.load("ownership_sweep")
    fn = lib.ownership_sweep_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    tile_keys = lib.ownership_sweep_tile_keys
    tile_keys.argtypes, tile_keys.restype = [_I], _I
    tile = tile_keys(n)  # keys per block tile
    grid = min(-(-k // tile), MAX_GRID)
    code = fn(
        counts.data_ptr(), int(counts.dtype == torch.float32), hosts.data_ptr(), live.data_ptr(),
        last_access.data_ptr(), k, n, int(now), float(h), int(max(expiry, 0)),
        owners.data_ptr(), add.data_ptr(), drop.data_ptr(), expired.data_ptr(),
        f.data_ptr(), grid, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "ownership_sweep", code)
    ownership_sweep.launches += 1
    return owners, add, drop, expired, f


ownership_sweep.launches = 0
