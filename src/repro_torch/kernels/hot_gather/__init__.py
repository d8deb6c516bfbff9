"""The hot-row gather: ``ops.hot_gather`` (CUDA kernel in
``csrc/hot_gather.cu``, with a ``torch.autograd.Function`` for the
gradient) beside ``ref.hot_gather_ref``."""
