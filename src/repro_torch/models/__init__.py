"""Model layers of the port (counterpart of ``src/repro/models/``): the
parameter system, norms, RoPE and the swiglu FFN, the MoE layer with the
Redynis hot-expert replica path (einsum and sort dispatch), attention
(``blockwise_attention`` for training, plain versions for the tests), the
decoder-only transformer (training blockwise under autograd, prefill
through ``flash_attention``, decode through ``flash_decode``) and the
``Model`` facade for the dense and MoE families."""

from repro_torch.models.model import Model, build

__all__ = ["Model", "build"]
