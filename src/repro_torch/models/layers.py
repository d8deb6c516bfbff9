"""Shared layers (counterpart of ``src/repro/models/layers.py``): norms,
RoPE and the swiglu FFN. Norm and rotary math run in f32 and round to the
input's dtype, as the reference's do; the matmuls are left to
``torch.einsum`` as the reference leaves them to XLA. ``gelu_mlp`` waits
for the families that use it."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec, dense_init, ones_init, zeros_init

__all__ = ["rmsnorm", "layernorm", "norm_specs", "apply_norm", "rope", "swiglu", "swiglu_specs"]


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm_specs(d: int, kind: str, prefix: tuple = ()) -> dict:
    """``kind``: 'rmsnorm' | 'layernorm'. ``prefix`` holds ``(size,
    axis_name)`` pairs that stack the params (e.g. layers)."""
    shape = tuple(s for s, _ in prefix) + (d,)
    if kind == "rmsnorm":
        return {"scale": ParamSpec(shape, ones_init, torch.float32)}
    return {
        "scale": ParamSpec(shape, ones_init, torch.float32),
        "bias": ParamSpec(shape, zeros_init, torch.float32),
    }


def apply_norm(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(p["scale"], x)
    return layernorm(p["scale"], p["bias"], x)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding of x ``[B, S, H, D]`` at positions ``[S]`` or
    ``[B, S]``; the angles are built in f32, as the reference builds them."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq  # [S, half] or [B, S, half]
    ang = ang[None, :, None, :] if ang.dim() == 2 else ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


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
