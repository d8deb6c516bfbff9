"""Training of the port (counterpart of ``src/repro/train/``): AdamW
(``optim``), gradient compression (``compress``), checkpoints in the
reference's layout (``checkpoint``), the trainer with both Redynis
placement daemons in its loop (``trainer``) and fault tolerance
(``fault``)."""

from repro_torch.train.fault import (
    ElasticRunner,
    HeartbeatMonitor,
    StragglerMonitor,
    StragglerPolicy,
    elastic_data_width,
)
from repro_torch.train.optim import OptConfig, OptState, apply_updates, global_norm, init_opt, lr_at
from repro_torch.train.trainer import TrainConfig, Trainer, TrainState

__all__ = [
    "OptConfig",
    "OptState",
    "init_opt",
    "apply_updates",
    "lr_at",
    "global_norm",
    "TrainConfig",
    "TrainState",
    "Trainer",
    "HeartbeatMonitor",
    "elastic_data_width",
    "StragglerPolicy",
    "StragglerMonitor",
    "ElasticRunner",
]
