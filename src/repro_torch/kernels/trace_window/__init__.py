"""A window of a request trace from its threefry stream: ``ops.trace_window``
(CUDA kernel in ``csrc/trace_window.cu``) beside ``ref.trace_window_ref``.
Not the port of a Pallas kernel: the reference draws its traces with
``jax.random`` in XLA-fused code."""
