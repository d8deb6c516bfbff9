"""``capacity_projection``: trim a replica plan to per-node byte budgets —
the wrapper around the Hopper kernels in ``csrc/capacity_projection.cu``.

For tensors on the card it checks the inputs and launches the kernels (or
raises); for tensors on the CPU it runs the plain version,
``ref.project_capacity_ref``. There is no fallback from one to the other.
``capacity_projection.launches`` counts the calls that reach the card, each
a fixed sequence of a memset and nine kernels with no host round-trip:
once a sweep with a finite budget.

Budgets reach the kernels through a device pointer: a ``[N]`` (or
one-element) tensor on the card is used as it lies, cast to f32 as the
plain version casts it; a Python or numpy scalar becomes a device fill, and
only a host sequence is copied to the card.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.capacity_projection.ref import project_capacity_ref

__all__ = ["capacity_projection"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 2 + [_P] * 5


def _lib():
    lib = _build.load("capacity_projection")
    if lib.capacity_projection_launch.argtypes is None:
        lib.capacity_projection_launch.argtypes = _ARGTYPES
        lib.capacity_projection_launch.restype = ctypes.c_int
        lib.capacity_projection_scratch_bytes.argtypes = [_I, _I]
        lib.capacity_projection_scratch_bytes.restype = ctypes.c_longlong
        lib.capacity_projection_max_nodes.argtypes, lib.capacity_projection_max_nodes.restype = [], _I
    return lib


def _budget(capacity_bytes, n: int, dev: torch.device) -> torch.Tensor:
    """``[N]`` f32 budgets on ``dev``, rounded to f32 as the plain version
    rounds them."""
    if isinstance(capacity_bytes, torch.Tensor):
        if capacity_bytes.device != dev:
            raise ValueError(f"capacity_projection: capacity_bytes is on {capacity_bytes.device}, "
                             f"expected {dev}")
        return capacity_bytes.to(torch.float32).expand(n).contiguous()
    if isinstance(capacity_bytes, numbers.Real):
        return torch.full((n,), float(capacity_bytes), dtype=torch.float32, device=dev)
    return torch.as_tensor(capacity_bytes, dtype=torch.float32, device=dev).expand(n).contiguous()


def capacity_projection(
    owners: torch.Tensor,  # [K, N] bool post-eligibility replica set
    hosts: torch.Tensor,  # [K, N] bool replica set before this sweep
    f: torch.Tensor,  # [K, N] f32 ownership fractions (the score)
    object_bytes: torch.Tensor,  # [K] f32 per-key payload size, >= 0
    capacity_bytes,  # [N] tensor, sequence or scalar per-node byte budget
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(projected, evicted, rejected)``, all ``[K, N]`` bool, as
    ``core.costmodel.project_capacity`` returns them."""
    dev = owners.device
    if dev.type == "cpu":
        return project_capacity_ref(owners, hosts, f, object_bytes, capacity_bytes)
    if dev.type != "cuda":
        raise ValueError(f"capacity_projection: unsupported device {dev}")
    k, n = owners.shape
    _build.check_input("capacity_projection", "owners", owners, torch.bool, (k, n), dev)
    _build.check_input("capacity_projection", "hosts", hosts, torch.bool, (k, n), dev)
    _build.check_input("capacity_projection", "f", f, torch.float32, (k, n), dev)
    _build.check_input("capacity_projection", "object_bytes", object_bytes, torch.float32, (k,), dev)
    budget = _budget(capacity_bytes, n, dev)
    projected = torch.empty((k, n), dtype=torch.bool, device=dev)  # the final pass writes every entry
    evicted, rejected = torch.empty_like(projected), torch.empty_like(projected)
    if k == 0 or n == 0:
        return projected, evicted, rejected
    lib = _lib()
    if n > lib.capacity_projection_max_nodes():
        raise ValueError(f"capacity_projection: {n} nodes; the kernel takes at most "
                         f"{lib.capacity_projection_max_nodes()}")
    scratch = torch.empty(lib.capacity_projection_scratch_bytes(k, n), dtype=torch.uint8, device=dev)
    code = lib.capacity_projection_launch(
        owners.data_ptr(), hosts.data_ptr(), f.data_ptr(), object_bytes.data_ptr(), budget.data_ptr(),
        k, n, projected.data_ptr(), evicted.data_ptr(), rejected.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "capacity_projection", code)
    capacity_projection.launches += 1
    return projected, evicted, rejected


capacity_projection.launches = 0
