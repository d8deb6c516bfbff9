"""One chunk's fused request path: ``ops.chunk_replay`` (CUDA kernel in
``csrc/chunk_replay.cu``) beside ``ref.chunk_replay_ref``."""
