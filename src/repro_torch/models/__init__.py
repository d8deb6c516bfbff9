"""Model layers of the port (counterpart of ``src/repro/models/``): the
parameter system, norms, RoPE, the swiglu and GELU FFNs, the MoE layer
with the Redynis hot-expert replica path (einsum and sort dispatch),
attention (``blockwise_attention`` for training, plain versions for the
tests), the decoder-only transformer (training blockwise under autograd,
prefill through ``flash_attention``, decode through ``flash_decode``),
the RWKV-6 stack (``rwkv6``), the RecurrentGemma stack (``rglru``), the
Whisper encoder-decoder (``encdec``) and the ``Model`` facade over all
six families."""

from repro_torch.models.model import Model, build

__all__ = ["Model", "build"]
