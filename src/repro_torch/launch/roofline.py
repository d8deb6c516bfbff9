"""Roofline terms of one step, counted on torch itself (counterpart of
``src/repro/launch/roofline.py``, which parses compiled XLA HLO and prices
it on a TPU v5e; the port has no HLO).

``count_step(fn, *args)`` runs ``fn`` (a rank's step in local view: every
tensor is this rank's block, see ``dist.py``) under three counters and
returns a :class:`StepCount`:

  * FLOPs — ``torch.utils.flop_counter.FlopCounterMode``: matmuls,
    convolutions and attention, on the rank's own operands, so the count is
    per card (a DTensor counts the global op; the port's tensors are local).
    Elementwise FLOPs are left out, as the reference leaves them out.
  * collective bytes — ``torch.distributed.tensor.debug.CommDebugMode``
    counts the collectives by op, and ``dist.COMM`` holds the bytes each
    call of the port's collective helpers moved (an all-reduce counted
    twice, its reduce-scatter and all-gather phases, as the reference
    counts it).
  * HBM bytes — every operator's inputs plus outputs (views and
    collectives excluded; an in-place operator is charged its other
    operands twice, read and written, not the tensor it updates): an
    **unfused upper bound**, each operator reading its inputs from and
    writing its outputs to device memory.

Terms, with the H100 SXM's figures (``HW``):

  compute    = flops / 989e12 (bf16 dense tensor-core peak)
  memory     = hbm_bytes / 3.35e12
  collective = collective_bytes / 900e9 (NVLink 4, the spec sheet's 900 GB/s)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import dist as dist_lib

__all__ = ["StepCount", "count_step", "roofline_terms", "HW"]

HW = {
    "name": "NVIDIA H100 SXM (spec sheet)",
    "peak_flops": 989e12,  # bf16 FLOP/s, dense, per card
    "hbm_bw": 3.35e12,  # bytes/s
    "link_bw": 900e9,  # bytes/s, NVLink 4 per card (the spec sheet's figure)
}

_COLLECTIVE_PREFIXES = ("c10d.", "c10d_functional.", "_c10d_functional.")
_MATMULS = ("mm", "addmm", "bmm", "baddbmm", "matmul", "convolution", "_scaled_dot_product")


@dataclass
class StepCount:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    by_collective: dict = field(default_factory=dict)
    dot_count: int = 0
    collective_count: int = 0
    comm_ops: dict = field(default_factory=dict)


def _nbytes(tree) -> int:
    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return total


class _BytesMode(TorchDispatchMode):
    """Each operator's input plus output bytes, and its matmul count."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.dots = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        if not func.is_view and not name.startswith(_COLLECTIVE_PREFIXES):
            first = func._schema.arguments[0].alias_info if func._schema.arguments else None
            if first is not None and first.is_write:  # in place: the other operands, read and written
                self.bytes += 2 * (_nbytes(args[1:]) + _nbytes(kwargs or {}))
            else:
                self.bytes += _nbytes(args) + _nbytes(kwargs or {}) + _nbytes(out)
        if name.split(".")[-1].startswith(_MATMULS) or name.endswith(_MATMULS):
            self.dots += 1
        return out


def count_step(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), StepCount)``: the step's FLOPs, HBM bytes and
    collectives on this rank."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    dist_lib.reset_comm()
    with FlopCounterMode(display=False) as fc, CommDebugMode() as cm, _BytesMode() as bm:
        out = fn(*args, **kwargs)
    count = StepCount()
    count.flops = float(fc.get_total_flops())
    count.hbm_bytes = float(bm.bytes)
    count.dot_count = bm.dots
    count.comm_ops = {str(k): int(v) for k, v in cm.get_comm_counts().items()}
    count.collective_count = int(cm.get_total_counts())
    for kind, rec in dist_lib.comm_totals().items():
        b = rec["bytes"] * (2.0 if kind == "all-reduce" else 1.0)
        count.by_collective[kind] = b
        count.collective_bytes += b
    return out, count


def roofline_terms(count: StepCount, model_flops_per_chip: float = 0.0) -> dict:
    """Three roofline terms (seconds per step, per card) and the diagnosis,
    with the reference's keys."""
    compute = count.flops / HW["peak_flops"]
    memory = count.hbm_bytes / HW["hbm_bw"]
    collective = count.collective_bytes / HW["link_bw"]
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    dom = max(terms, key=terms.get)
    bound = max(compute, memory, collective)
    out = {
        **terms,
        "dominant": dom.replace("_s", ""),
        "step_time_bound_s": bound,
        "counted_flops": count.flops,
        "counted_bytes": count.hbm_bytes,
        "collective_bytes": count.collective_bytes,
        "by_collective": count.by_collective,
        "hw": HW["name"],
    }
    if model_flops_per_chip:
        out["model_flops"] = model_flops_per_chip
        out["useful_flops_frac"] = model_flops_per_chip / max(count.flops, 1.0)
        out["roofline_frac"] = model_flops_per_chip / HW["peak_flops"] / max(bound, 1e-12)
    return out
