"""Log-bin latency histogram: ``ops.latency_histogram`` (CUDA kernel in
``csrc/latency_histogram.cu``) beside ``ref.latency_histogram_ref`` and
the binning helpers."""
