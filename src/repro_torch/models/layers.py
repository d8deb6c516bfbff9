"""The swiglu FFN (counterpart of ``swiglu`` and ``swiglu_specs`` in
``src/repro/models/layers.py``): plain matmuls, left to ``torch.einsum``
as the reference leaves them to XLA."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec, dense_init

__all__ = ["swiglu", "swiglu_specs"]


def swiglu_specs(d_model: int, d_ff: int, prefix: tuple = ()) -> dict:
    """``prefix`` holds ``(size, axis_name)`` pairs, as the reference's does;
    only the sizes are used."""
    ps = tuple(s for s, _ in prefix)
    return {
        "w_gate": ParamSpec(ps + (d_model, d_ff), dense_init(d_model)),
        "w_up": ParamSpec(ps + (d_model, d_ff), dense_init(d_model)),
        "w_down": ParamSpec(ps + (d_ff, d_model), dense_init(d_ff)),
    }


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    gate = torch.einsum("bsd,df->bsf", x, p["w_gate"])
    up = torch.einsum("bsd,df->bsf", x, p["w_up"])
    hidden = F.silu(gate.float()).to(x.dtype) * up
    return torch.einsum("bsf,fd->bsd", hidden, p["w_down"])
