"""Shared layers (counterpart of ``src/repro/models/layers.py``): norms,
RoPE, the swiglu FFN and the GELU MLP (with biases, Whisper's). Norm,
rotary and activation math run in f32 and round to the input's dtype, as
the reference's do; the matmuls are left to ``torch.einsum`` as the
reference leaves them to XLA. ``jax.nn.gelu`` defaults to its tanh form,
so the port's GELU is ``F.gelu(..., approximate="tanh")``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec, dense_init, ones_init, zeros_init

__all__ = ["rmsnorm", "layernorm", "norm_specs", "apply_norm", "rope", "swiglu_specs", "swiglu",
           "gelu_mlp_specs", "gelu_mlp"]


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
    axes = tuple(a for _, a in prefix) + (None,)
    if kind == "rmsnorm":
        return {"scale": ParamSpec(shape, axes, ones_init, torch.float32)}
    return {
        "scale": ParamSpec(shape, axes, ones_init, torch.float32),
        "bias": ParamSpec(shape, axes, zeros_init, torch.float32),
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
    """``prefix`` holds ``(size, axis_name)`` pairs that stack the params."""
    ps = tuple(s for s, _ in prefix)
    pa = tuple(a for _, a in prefix)
    return {
        "w_gate": ParamSpec(ps + (d_model, d_ff), pa + ("embed", "mlp"), dense_init(d_model)),
        "w_up": ParamSpec(ps + (d_model, d_ff), pa + ("embed", "mlp"), dense_init(d_model)),
        "w_down": ParamSpec(ps + (d_ff, d_model), pa + ("mlp", "embed"), dense_init(d_ff)),
    }


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    gate = torch.einsum("bsd,df->bsf", x, p["w_gate"])
    up = torch.einsum("bsd,df->bsf", x, p["w_up"])
    hidden = F.silu(gate.float()).to(x.dtype) * up
    return torch.einsum("bsf,fd->bsd", hidden, p["w_down"])


def gelu_mlp_specs(d_model: int, d_ff: int, prefix: tuple = ()) -> dict:
    ps = tuple(s for s, _ in prefix)
    pa = tuple(a for _, a in prefix)
    return {
        "w_in": ParamSpec(ps + (d_model, d_ff), pa + ("embed", "mlp"), dense_init(d_model)),
        "b_in": ParamSpec(ps + (d_ff,), pa + ("mlp",), zeros_init),
        "w_out": ParamSpec(ps + (d_ff, d_model), pa + ("mlp", "embed"), dense_init(d_ff)),
        "b_out": ParamSpec(ps + (d_model,), pa + ("embed",), zeros_init),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default (tanh) form on f32, rounded to x's dtype."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, p["w_in"]) + p["b_in"].to(x.dtype)
    return torch.einsum("bsf,fd->bsd", gelu(h), p["w_out"]) + p["b_out"].to(x.dtype)
