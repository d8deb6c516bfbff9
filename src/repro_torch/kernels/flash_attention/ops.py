"""``flash_attention``: causal / windowed GQA attention — the wrapper
around the Hopper kernels in ``csrc/flash_attention.cu``.

For CUDA tensors it checks the inputs and launches a kernel (or raises);
for CPU tensors it runs the plain version, ``ref.flash_attention_ref``.
There is no fallback from one to the other. It takes the model layout of
the reference's ``ops.flash_attention`` (q ``[B, S, H, D]``, k/v
``[B, T, KH, D]``) and reads it in place; any S and T, T != S included,
with no padding.

Which kernel runs is decided by shape alone (``variant``), never by trying
one and then another:

* bf16 with D in {64, 128, 256} → ``"tma_wgmma"``: TMA loads through an
  mbarrier ring and wgmma for both products, warp-specialised. Its q tile
  (``q_rows``) is 128 rows (two consumer warpgroups) unless the grid of
  128-row tiles, ``ceil(S / 128) * H * B`` blocks, is smaller than the
  H100's 132 SMs; then it is 64 rows (one consumer warpgroup), which
  doubles the blocks.
* bf16 with D 32 → ``"mma_sync"``: mma.sync m16n8k16 with synchronous tile
  loads. It takes every D, so ``_launch(..., kind="mma_sync")`` can time
  it beside the TMA kernel.
* f32 → ``"f32_simt"``: the CUDA cores, no TF32.

``flash_attention.launches`` counts the kernel launches and
``flash_attention.launches_by_variant`` the same launches by variant.
"""

from __future__ import annotations

import ctypes
import time

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention", "variant", "q_rows", "has_empty_rows", "HEAD_DIMS", "TMA_HEAD_DIMS", "DTYPES", "VARIANTS"]

HEAD_DIMS = (32, 64, 128, 256)
TMA_HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)
VARIANTS = ("tma_wgmma", "mma_sync", "f32_simt")
NUM_SMS = 132  # H100 SXM

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 5 + [_I] * 8 + [_F, _I, _P]  # both launch functions; the last int: is_bf16 | q_rows
_ENCODE_ARGTYPES = [_P] * 3 + [_I] * 8


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that attention of this dtype and head dim runs on."""
    if dtype == torch.bfloat16:
        return "tma_wgmma" if head_dim in TMA_HEAD_DIMS else "mma_sync"
    return "f32_simt"


def q_rows(s: int, h: int, b: int) -> int:
    """q rows per block of the ``tma_wgmma`` kernel at q ``[b, s, h, D]``."""
    return 64 if -(-s // 128) * h * b < NUM_SMS else 128


def has_empty_rows(s: int, t: int, window: int) -> bool:
    """Whether some query row sees no key: with a window, rows
    ``i >= t + window - 1`` do (causal or not) when ``s`` reaches them.
    Those rows are the mean of v over ``t``, as the reference's uniform
    softmax over all-masked scores gives."""
    return window > 0 and t + window - 1 < s


def _check(q, k, v) -> None:
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


def _launch(q, k, v, causal: bool, window: int, kind: str | None = None,
            rows: int | None = None) -> torch.Tensor:
    """Launch one kernel: ``variant``'s choice, or ``kind`` (and, for
    ``"tma_wgmma"``, ``rows``) where a measurement names it."""
    _check(q, k, v)
    dev = q.device
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    kind = kind or variant(q.dtype, d)
    o = torch.empty_like(q)
    # [B, KH, D] f32, only for shapes with rows that see no key (never at T == S).
    vmean = v.float().mean(dim=1) if has_empty_rows(s, t, window) else None
    lib = _build.load("flash_attention")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if vmean is None else vmean.data_ptr(), b, s, t, h, kh, d,
            int(causal), int(window), float(d**-0.5))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kind == "tma_wgmma":
        if q.dtype != torch.bfloat16 or d not in TMA_HEAD_DIMS:
            raise ValueError(f"flash_attention: tma_wgmma takes bf16 with D in {TMA_HEAD_DIMS}")
        fn = lib.flash_attention_tma_launch
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        code = fn(*args, rows or q_rows(s, h, b), stream)
    else:
        if (kind == "f32_simt") != (q.dtype == torch.float32):
            raise ValueError(f"flash_attention: {kind} does not take {q.dtype}")
        fn = lib.flash_attention_launch
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        code = fn(*args, int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, "flash_attention", code)
    flash_attention.launches += 1
    flash_attention.launches_by_variant[kind] += 1
    return o


def encode_seconds(q, k, v, iters: int = 1000) -> float:
    """Host seconds per call that the ``tma_wgmma`` path spends encoding
    its three tensor maps (mean over ``iters``)."""
    _check(q, k, v)
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_tma_encode
    fn.argtypes, fn.restype = _ENCODE_ARGTYPES, ctypes.c_int
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), b, s, t, h, kh, d, q_rows(s, h, b))
    _build.check(lib, "flash_attention", fn(*args, 1))
    t0 = time.perf_counter()
    _build.check(lib, "flash_attention", fn(*args, iters))
    return (time.perf_counter() - t0) / iters


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
    ``h // (H // KH)``. A query that sees no key gets the mean of v."""
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    return _launch(q, k, v, causal, window)


flash_attention.launches = 0
flash_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)
