"""Model layers of the port (counterpart of ``src/repro/models/``): the
parameter system, the swiglu FFN and the MoE layer with the Redynis
hot-expert replica path."""
