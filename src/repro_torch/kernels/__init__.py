"""Hand-written Hopper kernels, each beside its plain PyTorch version:
``chunk_replay`` (one chunk's request path), ``ownership_sweep``
(Algorithm 3's analysis pass) and ``latency_histogram`` (bucketize and
grouped fold of per-request latencies). ``csrc/log_bins.cuh`` holds the
bin rule the two histogram folds share."""
