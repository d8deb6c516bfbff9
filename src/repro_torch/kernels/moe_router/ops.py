"""``moe_router``: softmax -> top-k -> gates, ids and per-group expert
counts — the wrapper around the Hopper kernel in ``csrc/moe_router.cu``.

For CUDA tensors it checks the inputs and launches the kernel (or raises);
for CPU tensors it runs the plain version, ``ref.router_ref``. There is no
fallback from one to the other. ``moe_router.launches`` counts the kernel
launches.

The gates carry a gradient on both devices through one
``torch.autograd.Function`` (``_MoeRouter``), as the reference's gates are
differentiable through ``jax.nn.softmax`` and ``jax.lax.top_k``; ids and
counts are not differentiable. The backward pass is closed-form torch ops
(``router_vjp``), since the reference has no backward kernel here either.

The counts come out per group of ``group`` consecutive rows (``[G, E]``,
what ``models/moe.py::moe_apply`` emits) rather than summed as the
reference wrapper sums its tiles. The kernel's grid is cut from the rows
(``lanes_per_row``), not from the groups; its count scratch (an int32
``[G, E]`` accumulator and a last-block ticket, both left zero by the
kernel) is kept per device and stream.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_router.ref import router_ref

__all__ = ["moe_router", "router_vjp", "lanes_per_row", "vector_io"]

THREADS = 256  # threads a block (the kernel's kThreads)
MAX_EXPERTS = 256
MAX_K = 32

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _L, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]

# (device index, stream) -> sync [1 + G * E] int32: the ticket, then the
# count accumulator; zero between calls.
_scratch: dict[tuple[int, int], torch.Tensor] = {}


def lanes_per_row(e: int) -> int:
    """Lanes that share a row of ``e`` logits: 4 up to 64 experts (16 a
    lane at 64), 8 up to 256 (32 a lane). A 256-thread block then takes 64
    or 32 rows (the kernel's grid)."""
    return 4 if e <= 64 else 8


def vector_io(ptr: int, e: int) -> bool:
    """Whether every row starts 16-byte aligned, so lanes load float4s."""
    return ptr % 16 == 0 and e % 4 == 0


def _sync_for(dev: torch.device, stream: int, words: int) -> torch.Tensor:
    key = (dev.index, stream)
    got = _scratch.get(key)
    if got is None or got.numel() < 1 + words:
        got = _scratch[key] = torch.zeros(1 + words, dtype=torch.int32, device=dev)
    return got


def _launch(logits: torch.Tensor, k: int, group: int):
    """The kernel on a CUDA tensor (inputs checked, or raises)."""
    t, e = logits.shape
    dev = logits.device
    _build.check_input("moe_router", "logits", logits, torch.float32, (t, e), dev)
    if t == 0:
        raise ValueError("moe_router: needs at least one row")
    if e > MAX_EXPERTS:
        raise ValueError(f"moe_router: E={e} exceeds the kernel's {MAX_EXPERTS}")

    lib = _build.load("moe_router")
    fn = lib.moe_router_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    g = -(-t // group)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sync = _sync_for(dev, stream, g * e)
    gates = torch.empty((t, k), dtype=torch.float32, device=dev)
    ids = torch.empty((t, k), dtype=torch.int32, device=dev)
    counts = torch.empty((g, e), dtype=torch.float32, device=dev)
    code = fn(logits.data_ptr(), t, e, k, group, lanes_per_row(e),
              int(vector_io(logits.data_ptr(), e)), gates.data_ptr(), ids.data_ptr(),
              counts.data_ptr(), sync.data_ptr(), stream)
    _build.check(lib, "moe_router", code)
    moe_router.launches += 1
    return gates, ids, counts


def router_vjp(logits: torch.Tensor, ids: torch.Tensor, d_gates: torch.Tensor) -> torch.Tensor:
    """``d logits [T, E]`` from ``d gates [T, K]``, in closed form.

    With ``p = softmax(logits)`` recomputed and ``Z = sum_j p[ids_j]``, the
    gates are ``p[ids_j] / max(Z, 1e-9)``. So the gradient in ``p[ids_j]``
    is ``u_j = (dg_j - sum_k dg_k g_k) / Z`` (zero off the picks), or
    ``dg_j / 1e-9`` where the clamp holds ``Z`` constant; then ``d logits =
    p * (u - sum_e p_e u_e)``, softmax's own backward."""
    x = logits.to(torch.float32)
    p = torch.exp(x - x.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    idx = ids.long()
    picked = p.gather(-1, idx)
    z = picked.sum(dim=-1, keepdim=True)
    zc = torch.clamp_min(z, 1e-9)
    g = picked / zc
    dg = d_gates.to(torch.float32)
    free = z > 1e-9  # the clamp passes the gradient through Z
    u = torch.where(free, (dg - (dg * g).sum(dim=-1, keepdim=True)) / zc, dg / zc)
    u_full = torch.zeros_like(p).scatter(-1, idx, u)  # the k ids of a row are distinct
    return p * (u_full - (picked * u).sum(dim=-1, keepdim=True))


class _MoeRouter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, k, group):
        dev = logits.device
        if dev.type == "cpu":
            gates, ids, counts = router_ref(logits, k, group)
        elif dev.type == "cuda":
            gates, ids, counts = _launch(logits, k, group)
        else:
            raise ValueError(f"moe_router: unsupported device {dev}")
        ctx.save_for_backward(logits, ids)
        ctx.mark_non_differentiable(ids, counts)
        return gates, ids, counts

    @staticmethod
    def backward(ctx, d_gates, _d_ids, _d_counts):
        logits, ids = ctx.saved_tensors
        return router_vjp(logits, ids, d_gates), None, None


def moe_router(logits: torch.Tensor, *, k: int, group: int):
    """logits ``[T, E]`` f32 -> ``(gates [T, K] f32, ids [T, K] int32,
    counts [ceil(T / group), E] f32)``. Differentiable in ``logits``
    through the gates."""
    if logits.dim() != 2:
        raise ValueError(f"moe_router: logits must be [T, E], got {tuple(logits.shape)}")
    t, e = logits.shape
    if not 1 <= k <= min(e, MAX_K):
        raise ValueError(f"moe_router: need 1 <= k <= min(E, {MAX_K}), got k={k}, E={e}")
    if group < 1:
        raise ValueError(f"moe_router: group={group}; need >= 1")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"moe_router: unsupported device {logits.device}")
    return _MoeRouter.apply(logits, k, group)


moe_router.launches = 0
