"""Redynis on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

It mirrors the reference package's layout (``kvsim/``, ``core/``,
``kernels/<name>/{ref,ops}.py``) and imports neither JAX nor anything of
``repro``. Entry points run on the card unless the caller passes
``device="cpu"`` (see ``device.resolve_device``); each hand-written CUDA
kernel sits beside its plain PyTorch version (``ref.py``).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
