"""The MoE router: ``ops.moe_router`` (CUDA kernel in
``csrc/moe_router.cu``) beside ``ref.router_ref``."""
