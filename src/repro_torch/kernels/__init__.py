"""Hand-written Hopper kernels, each beside its plain PyTorch version:
``chunk_replay`` (one chunk's request path) and ``ownership_sweep``
(Algorithm 3's analysis pass). ``latency_histogram`` holds only the plain
binning helpers so far."""
