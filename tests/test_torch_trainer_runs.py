"""The reference's own trainer tests (``tests/test_train_substrate.py``)
re-stated for the port, those that run ``Trainer.run`` for many steps: the
loss falls and a resume from the checkpoint equals the uninterrupted run
(rtol 1e-5, the reference test's own bar), and an elastic restart after a
node dies resumes after the last checkpoint. Moved out of
``tests/test_torch_trainer_loop.py`` so that the files spread over the
test workers."""

import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, Pipeline  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.train import ElasticRunner, HeartbeatMonitor, OptConfig, TrainConfig, Trainer  # noqa: E402


def _gen():
    return torch.Generator().manual_seed(0)


def test_train_loss_decreases_and_checkpoint_resume():
    with tempfile.TemporaryDirectory() as d:
        cfg = reduced(get_config("llama3.2-3b"))
        tr = Trainer(build(cfg, "cpu"), TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=40),
                                                    checkpoint_dir=d, checkpoint_every=5, log_every=100))
        pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4), "cpu")
        s1, h1 = tr.run(tr.init_state(_gen()), pipe, 10, log=False)
        assert h1[-1]["loss"] < h1[0]["loss"]
        # resume from the checkpoint == continue uninterrupted
        s_rest = tr.restore(torch.Generator().manual_seed(1))
        assert int(s_rest.opt.step) == 10 and s_rest.data_step == 10
        for a, b in zip(tree_lib.leaves(s_rest.params), tree_lib.leaves(s1.params)):
            assert torch.equal(a, b)
        _, h2 = tr.run(s_rest, pipe, 5, log=False)
        _, h3 = tr.run(s1, pipe, 5, log=False)
        np.testing.assert_allclose([x["loss"] for x in h2], [x["loss"] for x in h3], rtol=1e-5)


def test_elastic_restart_recovers_from_failure(tmp_path):
    """Kill a node mid-run; the runner restores the checkpoint, seeks the
    data stream, and continues at the reduced width."""
    root = str(tmp_path)
    cfg = reduced(get_config("qwen3-1.7b"))
    model = build(cfg, "cpu")

    def make_trainer(width):
        tr = Trainer(model, TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=60),
                                        checkpoint_dir=root, checkpoint_every=5, log_every=1000),
                     num_nodes=max(width, 1))
        pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4), "cpu")
        return tr, tr.init_state(_gen()), pipe

    mon = HeartbeatMonitor(["n0", "n1", "n2", "n3"], timeout=1e9)
    runner = ElasticRunner(make_trainer, mon)
    tr, st, pipe = make_trainer(4)
    st, h1 = tr.run(st, pipe, 10, log=False)  # steps 1-10, a checkpoint at 10
    mon.kill("n3")
    h2 = runner.run(total_steps=10, chunk=5)
    assert runner.restarts == 1
    assert len(h2) == 10
    assert h2[0]["step"] == 11  # resumed after the step-10 checkpoint
