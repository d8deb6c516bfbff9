"""Int8 weight quantization for serving (counterpart of ``src/repro/quant.py``).

Decode reads every weight once a step, so int8 weights with per-row scales
halve the bytes a bf16 weight set streams. A quantized leaf is the dict
``{"q": int8[...], "s": f32[..., 1]}`` (the scale broadcast over the last
dim); ``dequant_tree`` maps such leaves back to bf16 and is called on one
layer's params at a time inside the decode step, so that only one layer's
bf16 copy is live. As in the reference, only ``Model.decode_step`` of the
``dense``, ``moe`` and ``vlm`` families takes int8 params.

The bits are the reference's: the f32 row max over 127, clamped at 1e-12,
``w / s`` rounded half to even (``torch.round``, as ``jnp.round``) and
clipped to +-127; dequantization is ``q.float() * s`` rounded to bf16.

Which leaves are quantized is the reference's rule: two or more dims, at
least 65,536 elements, a float dtype. That rule also takes stacked f32 norm
scales whose ``[L, D]`` reaches 65,536 elements (llava-next-34b's 60 x
7,168, mistral-large-123b's 88 x 12,288; not qwen3-1.7b's 28 x 2,048); the
reference then serves them dequantized to bf16, and so does the port.
"""

from __future__ import annotations

import torch

from repro_torch import tree as tree_lib

__all__ = ["quantize_leaf", "quantize_tree", "is_quantized", "dequant_leaf", "dequant_tree",
           "abstract_quantize_tree"]

_MIN_QUANT_SIZE = 1 << 16  # leave small tensors (norms, biases) alone
_FLOATS = (torch.bfloat16, torch.float32, torch.float16)


def _quantize_rows(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    wf = w.float()
    s = torch.clamp_min(wf.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-12)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return q, s


def quantize_leaf(w: torch.Tensor) -> dict:
    """Per-row (last-dim) symmetric int8: ``w ~ q * s``. A leaf of three or
    more dims is quantized one slice of its leading dim at a time (the rows
    are independent, so the bits are the same), so that its f32 copy never
    exists whole: llava-next-34b's ``[60, 7168, 20480]`` leaf would be 35 GB
    in f32."""
    if w.dim() < 3:
        q, s = _quantize_rows(w)
        return {"q": q, "s": s}
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(w.shape[:-1] + (1,), dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        q[i], s[i] = _quantize_rows(w[i])
    return {"q": q, "s": s}


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf.keys()) == {"q", "s"}


def dequant_leaf(leaf, dtype: torch.dtype = torch.bfloat16):
    if is_quantized(leaf):
        return (leaf["q"].float() * leaf["s"]).to(dtype)
    return leaf


def _should_quantize(x) -> bool:
    return (isinstance(x, torch.Tensor) and x.dim() >= 2 and x.numel() >= _MIN_QUANT_SIZE
            and x.dtype in _FLOATS)


def quantize_tree(tree):
    """Quantize every large matrix leaf; keep small and precision leaves."""
    return tree_lib.tree_map(lambda x: quantize_leaf(x) if _should_quantize(x) else x, tree)


def abstract_quantize_tree(tree):
    """What the quantized tree looks like, as tensors on the ``meta`` device
    (shapes and dtypes, no data) in place of each quantized leaf; ``tree``
    may hold meta tensors itself."""

    def f(x):
        if _should_quantize(x):
            return {"q": torch.empty(x.shape, dtype=torch.int8, device="meta"),
                    "s": torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device="meta")}
        return x

    return tree_lib.tree_map(f, tree)


def dequant_tree(tree, dtype: torch.dtype = torch.bfloat16):
    """Dequantize a (sub)tree: every ``{"q", "s"}`` leaf to ``dtype``, every
    other leaf as it is."""
    if is_quantized(tree):
        return dequant_leaf(tree, dtype)
    if isinstance(tree, dict):
        return {key: dequant_tree(val, dtype) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(dequant_tree(val, dtype) for val in tree)
    return tree


def has_quantized(tree) -> bool:
    """Whether any leaf of ``tree`` is a ``{"q", "s"}`` dict."""
    if is_quantized(tree):
        return True
    if isinstance(tree, dict):
        return any(has_quantized(val) for val in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(has_quantized(val) for val in tree)
    return False
