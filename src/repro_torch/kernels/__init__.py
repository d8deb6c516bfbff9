"""Hand-written Hopper kernels, each beside its plain PyTorch version:
``chunk_replay`` (one chunk's request path), ``ownership_sweep``
(Algorithm 3's analysis pass), ``latency_histogram`` (bucketize and
grouped fold of per-request latencies), ``moe_router`` (softmax, top-k and
per-group expert counts) and ``hot_gather`` (hot-row embedding cache
lookup). ``csrc/log_bins.cuh`` holds the bin rule the two histogram folds
share."""
