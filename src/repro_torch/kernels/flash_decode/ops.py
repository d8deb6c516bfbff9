"""``flash_decode``: one query token per sequence against its KV cache —
the wrapper around the Hopper kernels in ``csrc/flash_decode.cu``.

For CUDA tensors it checks the inputs and launches the kernels (a split
pass over 256-position chunks of the cache and a combine pass) or raises;
``flash_decode.launches`` counts calls, each one such pair of launches.
For CPU tensors it runs
the plain version, ``ref.flash_decode_ref``. There is no fallback from one
to the other. It takes the model layout of the reference's
``ops.flash_decode`` (q ``[B, H, D]``, cache ``[B, T, KH, D]``) and reads a
layer's cache slice in place.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

__all__ = ["flash_decode", "HEAD_DIMS", "DTYPES"]

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 7 + [_I] * 5 + [_F, _I, _P]


def _launch(q, k_cache, v_cache, lengths) -> torch.Tensor:
    dev = q.device
    b, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_decode: q has dtype {q.dtype}, expected one of {DTYPES}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {d} is not one of {HEAD_DIMS}")
    if kh == 0 or h % kh:
        raise ValueError(f"flash_decode: {h} q heads do not group over {kh} kv heads")
    _build.check_input("flash_decode", "q", q, q.dtype, (b, h, d), dev)
    _build.check_input("flash_decode", "k_cache", k_cache, q.dtype, (b, t, kh, d), dev)
    _build.check_input("flash_decode", "v_cache", v_cache, q.dtype, (b, t, kh, d), dev)
    _build.check_input("flash_decode", "lengths", lengths, torch.int32, (b,), dev)
    if b == 0 or t == 0:
        raise ValueError("flash_decode: needs at least one sequence and one cache slot")
    if any(x.data_ptr() % 16 for x in (k_cache, v_cache)):
        raise ValueError("flash_decode: the caches must be 16-byte aligned")
    lib = _build.load("flash_decode")
    splits = -(-t // lib.flash_decode_chunk())
    part_acc = torch.empty((b, h, splits, d), dtype=torch.float32, device=dev)
    part_ml = torch.empty((b, h, splits, 2), dtype=torch.float32, device=dev)
    o = torch.empty_like(q)
    fn = lib.flash_decode_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    code = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), o.data_ptr(), b, t, h, kh, d,
        float(d**-0.5), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, "flash_decode", code)
    flash_decode.launches += 1
    return o


def flash_decode(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [B, T, KH, D]
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32
) -> torch.Tensor:
    """Attention of each sequence's one query over its first
    ``min(lengths[b], T)`` cache positions, ``[B, H, D]`` in q's dtype
    (bf16 or f32). A length of 0 masks every position, and then, as in the
    reference, the whole cache is weighed alike (the mean of v)."""
    dev = q.device
    if dev.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, lengths)
    if dev.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {dev}")
    return _launch(q, k_cache, v_cache, lengths)


flash_decode.launches = 0
