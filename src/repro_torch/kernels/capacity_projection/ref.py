"""Plain PyTorch version of the capacity projection: one stable sort of
composite int64 keys and a per-node f64 prefix sum — the yardstick the CUDA
kernel in ``csrc/capacity_projection.cu`` is held to, and what the wrapper
runs for tensors on the CPU. ``core/costmodel.py`` states the admission
rule both follow."""

from __future__ import annotations

import torch

__all__ = ["project_capacity_ref"]


def _descending_rank_bits(f: torch.Tensor) -> torch.Tensor:
    """int64 in ``[0, 2**32)`` that orders like ``-f`` (non-NaN f32), with
    ``-0.0`` equal to ``0.0``."""
    f = torch.where(f == 0, torch.zeros_like(f), f)
    bits = f.view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)  # orders like f
    return (2**31 - 1) - ordered


def project_capacity_ref(
    owners: torch.Tensor,  # [K, N] bool post-eligibility replica set
    hosts: torch.Tensor,  # [K, N] bool replica set before this sweep
    f: torch.Tensor,  # [K, N] f32 ownership fractions (the score)
    object_bytes: torch.Tensor,  # [K] f32 per-key payload size
    capacity_bytes,  # [N] tensor, sequence or scalar per-node byte budget
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(projected, evicted, rejected)``, all ``[K, N]`` bool, as
    ``core.costmodel.project_capacity`` returns them."""
    k, n = owners.shape
    dev = owners.device
    held = owners & hosts
    budget = torch.as_tensor(capacity_bytes, dtype=torch.float32, device=dev)
    budget = budget.expand(n).to(torch.float64)
    # One sort of every node's column, node-major ([N, K] flattened: a 1-D
    # sort, which the card runs as one radix sort). Within a node, most
    # significant first: owned candidates, then f descending, then held
    # before add; the stable sort keeps key ids ascending within a tie.
    node = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    key = (node << 35) | ((~owners.t()).to(torch.int64) << 33) \
        | (_descending_rank_bits(f.t().to(torch.float32)) << 1) | (~held.t()).to(torch.int64)
    perm = torch.sort(key.reshape(-1), stable=True).indices  # [N * K], node-major
    owned_sorted = owners.t().reshape(-1)[perm]
    obj = object_bytes.to(torch.float32).to(torch.float64)
    size_sorted = torch.where(owned_sorted, obj[perm % k],
                              torch.zeros((), dtype=torch.float64, device=dev)).view(n, k)
    # A prefix sum a node, each over one contiguous row: the card scans a
    # 1-D tensor in parallel, but runs a scan along the key axis of a
    # [K, N] tensor one thread a column.
    cum = torch.empty_like(size_sorted)
    for j in range(n):
        torch.cumsum(size_sorted[j], 0, out=cum[j])
    admit_sorted = owned_sorted & (cum <= budget[:, None]).view(-1)
    admit = torch.empty_like(admit_sorted).scatter_(0, perm, admit_sorted).view(n, k).t()
    return owners & admit, held & ~admit, (owners & ~hosts) & ~admit
