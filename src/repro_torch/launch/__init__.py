"""Drivers of the port (counterpart of ``src/repro/launch/``): so far the
serving launcher, ``python -m repro_torch.launch.serve``."""
