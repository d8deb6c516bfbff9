"""Hand-written Hopper kernels, each beside its plain PyTorch version:
``chunk_replay`` (one chunk's request path; ``chunk_latency`` its
per-request latencies and read hits), ``ownership_sweep`` (Algorithm 3's
analysis pass), ``latency_histogram`` (bucketize and grouped fold of
per-request latencies), ``moe_router`` (softmax, top-k and per-group expert
counts), ``hot_gather`` (hot-row embedding cache lookup),
``flash_attention`` (prefill attention), ``flash_decode`` (one-token
attention over a KV cache), ``trace_window`` (a window of a request trace
from its threefry stream) and ``capacity_projection`` (per-node byte
budgets of a replica plan, by a weighted radix select); the last two port
no Pallas kernel. ``csrc/log_bins.cuh`` holds the bin rule the two
histogram folds share.

As in the reference, the package binds each kernel's function under the
kernel's name, so ``repro_torch.kernels.chunk_replay`` is the function, not
the subpackage: reach a kernel's modules by their path (``from
repro_torch.kernels.chunk_replay import ops``), never by attribute."""

from repro_torch.kernels.capacity_projection.ops import capacity_projection
from repro_torch.kernels.chunk_replay.ops import chunk_latency, chunk_replay
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.hot_gather.ops import hot_gather
from repro_torch.kernels.latency_histogram.ops import latency_histogram
from repro_torch.kernels.moe_router.ops import moe_router
from repro_torch.kernels.ownership_sweep.ops import ownership_sweep
from repro_torch.kernels.trace_window.ops import trace_window

__all__ = [
    "capacity_projection",
    "chunk_latency",
    "chunk_replay",
    "flash_attention",
    "flash_decode",
    "hot_gather",
    "latency_histogram",
    "moe_router",
    "ownership_sweep",
    "trace_window",
]
