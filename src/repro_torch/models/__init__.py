"""Model layers of the port (counterpart of ``src/repro/models/``): the
parameter system, norms, RoPE and the swiglu FFN, the MoE layer with the
Redynis hot-expert replica path, plain attention, the decoder-only
transformer (prefill through ``flash_attention``, decode through
``flash_decode``) and the ``Model`` facade for the dense and MoE
families."""
