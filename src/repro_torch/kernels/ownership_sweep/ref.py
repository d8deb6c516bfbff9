"""Plain PyTorch version of the ownership sweep (counterpart of
``src/repro/kernels/ownership_sweep/ref.py``): Algorithm 3's analysis phase on
arrays — the yardstick the CUDA kernel in ``csrc/ownership_sweep.cu`` is
held to, and what the wrapper runs for tensors on the CPU."""

from __future__ import annotations

import torch

from repro_torch.core.ownership import eligible_hosts, ownership_fraction

__all__ = ["sweep_ref"]


def sweep_ref(counts, hosts, live, last_access, now, *, h: float, expiry: int = 0):
    """Returns ``(owners, add, drop, expired, f)`` — bool ``[K, N]`` ×3,
    bool ``[K]``, f32 ``[K, N]``."""
    counts = counts.to(torch.float32)
    hosts = hosts.to(torch.bool)
    live = live.to(torch.bool)
    elig = eligible_hosts(counts, h)
    touched = counts.sum(dim=-1) > 0
    owners = torch.where(touched[:, None], elig, hosts)
    if expiry > 0:
        expired = live & ((int(now) - last_access.to(torch.int32)) > expiry)
    else:
        expired = torch.zeros_like(live)
    owners = owners & live[:, None] & ~expired[:, None]
    return owners, owners & ~hosts, hosts & ~owners, expired, ownership_fraction(counts)
