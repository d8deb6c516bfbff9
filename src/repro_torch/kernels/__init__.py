"""Hand-written Hopper kernels, each beside its plain PyTorch version:
``chunk_replay`` (one chunk's request path), ``ownership_sweep``
(Algorithm 3's analysis pass), ``latency_histogram`` (bucketize and
grouped fold of per-request latencies), ``moe_router`` (softmax, top-k and
per-group expert counts), ``hot_gather`` (hot-row embedding cache
lookup), ``flash_attention`` (prefill attention), ``flash_decode``
(one-token attention over a KV cache) and ``trace_window`` (a window of a
request trace from its threefry stream; the one kernel here that ports no
Pallas kernel). ``csrc/log_bins.cuh`` holds the bin
rule the two histogram folds share."""
