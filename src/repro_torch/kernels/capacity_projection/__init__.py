"""Per-node byte-budget projection of a replica plan: ``ops.capacity_projection``
(CUDA kernel in ``csrc/capacity_projection.cu``, a weighted radix select)
beside ``ref.project_capacity_ref`` (one stable sort). Not the port of a
Pallas kernel: the reference projects with sorts in XLA."""
