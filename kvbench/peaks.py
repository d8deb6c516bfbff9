"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): what a roofline share is taken
against. The kernels the cells time are bound by memory."""

HBM_BYTES_PER_S = 3.35e12  # 80 GB of HBM3
