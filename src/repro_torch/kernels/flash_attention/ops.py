"""``flash_attention``: causal / windowed GQA attention — the wrapper
around the Hopper kernels in ``csrc/flash_attention.cu``.

For CUDA tensors it checks the inputs and launches the kernel (or raises);
for CPU tensors it runs the plain version, ``ref.flash_attention_ref``.
There is no fallback from one to the other. ``flash_attention.launches``
counts the kernel launches. It takes the model layout of the reference's
``ops.flash_attention`` (q ``[B, S, H, D]``, k/v ``[B, T, KH, D]``) and
reads it in place; any S and T, T != S included, with no padding.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention", "HEAD_DIMS", "DTYPES"]

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 8 + [_F, _I, _P]


def _launch(q, k, v, causal: bool, window: int) -> torch.Tensor:
    dev = q.device
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: q has dtype {q.dtype}, expected one of {DTYPES}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} is not one of {HEAD_DIMS}")
    if kh == 0 or h % kh:
        raise ValueError(f"flash_attention: {h} q heads do not group over {kh} kv heads")
    _build.check_input("flash_attention", "q", q, q.dtype, (b, s, h, d), dev)
    _build.check_input("flash_attention", "k", k, q.dtype, (b, t, kh, d), dev)
    _build.check_input("flash_attention", "v", v, q.dtype, (b, t, kh, d), dev)
    if min(b, s, t) == 0:
        raise ValueError("flash_attention: needs at least one batch row, query and key")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned")
    o = torch.empty_like(q)
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, t, h, kh, d,
        int(causal), int(window), float(d**-0.5), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "flash_attention", code)
    flash_attention.launches += 1
    return o


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, KH, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Attention of q over k/v, ``[B, S, H, D]`` in q's dtype (bf16 or f32).
    Query i sees key j where ``j <= i`` (causal) and ``i - j < window``
    (window > 0), as the reference's mask says; q head h reads kv head
    ``h // (H // KH)``."""
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    return _launch(q, k, v, causal, window)


flash_attention.launches = 0
