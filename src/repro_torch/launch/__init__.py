"""Drivers of the port (counterpart of ``src/repro/launch/``): the serving
launcher, ``python -m repro_torch.launch.serve``, and the training driver,
``python -m repro_torch.launch.train``."""
