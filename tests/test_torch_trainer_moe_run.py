"""The reference's trainer test with both placement daemons and
microbatches (``tests/test_train_substrate.py``) re-stated for the port:
``Trainer.run`` of reduced granite-moe-1b-a400m for 12 steps, the loss
falls, both daemons sweep at least twice and the replica cache serves
assignments. Moved out of ``tests/test_torch_trainer_loop.py`` so that the
files spread over the test workers."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, Pipeline  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.train import OptConfig, TrainConfig, Trainer  # noqa: E402


def _gen():
    return torch.Generator().manual_seed(0)


def test_train_with_daemons_and_microbatches():
    cfg = dataclasses.replace(reduced(get_config("granite-moe-1b-a400m")), sweep_period=4, hot_embed_rows=32)
    tr = Trainer(build(cfg, "cpu"),
                 TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=30), microbatches=2,
                             log_every=100), num_nodes=2)
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, zipf_a=1.3), "cpu")
    st, hist = tr.run(tr.init_state(_gen()), pipe, 12, log=False)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert int(st.expert_placement.sweeps) >= 2
    assert int(st.hot_embed.sweeps) >= 2
    assert hist[-1]["moe_hot_frac"] > 0
