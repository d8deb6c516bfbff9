"""Algorithm 3's analysis pass: ``ops.ownership_sweep`` (CUDA kernel in
``csrc/ownership_sweep.cu``) beside ``ref.sweep_ref``."""
