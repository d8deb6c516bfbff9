from repro_torch.kernels.flash_decode.ops import flash_decode

__all__ = ["flash_decode"]
