"""Device resolution for every entry point of the port.

The port runs on an NVIDIA card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and a missing card is an error rather
than a silent fallback. Only an explicit ``device="cpu"`` (what the CPU
tests pass) runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raises when a CUDA device is asked for and
    none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
