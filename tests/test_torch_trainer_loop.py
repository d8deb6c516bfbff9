"""The port's training loop on the CPU: ``Trainer.run`` with both
placement daemons against the JAX reference's, remat, the reference's own
trainer tests (``tests/test_train_substrate.py``) re-stated for the port,
and the training driver. The re-stated tests that run the loop for many
steps are in ``tests/test_torch_trainer_runs.py`` and
``tests/test_torch_trainer_moe_run.py``, so that the three files spread
over the test workers.

Bars, each with its reason:

* the daemon run — f32 models (the embedding rows kept in f32 by a test
  subclass on both sides, params cast to f32), so the routing is the same:
  losses rtol 1e-5 (f32 sums in another order), daemon states (counts,
  replica sets, slot maps, sweeps, moves) exact;
* remat — the port's ``remat="full"`` gradients equal its ``"none"``
  gradients bit for bit: the recompute runs the same ops on the same
  inputs;
* resume — the resumed losses equal the uninterrupted run's at rtol 1e-5,
  the reference test's own bar (on the CPU they are equal).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.hot_embedding import embed_with_cache as jax_embed_with_cache  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import Pipeline as JaxPipeline  # noqa: E402
from repro.dist import embed_lookup as jax_embed_lookup  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.train.optim import OptConfig as JaxOptConfig  # noqa: E402
from repro.train.trainer import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import ModelConfig, get_config, reduced  # noqa: E402
from repro_torch.core.hot_embedding import embed_with_cache  # noqa: E402
from repro_torch.data import DataConfig, Pipeline  # noqa: E402
from repro_torch.dist import embed_lookup  # noqa: E402
from repro_torch.interop import train_state_from_numpy  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train import (  # noqa: E402
    HeartbeatMonitor,
    OptConfig,
    StragglerMonitor,
    StragglerPolicy,
    TrainConfig,
    Trainer,
    elastic_data_width,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """PyTorch's CPU ``exp`` can be off by ~1e-4 on its first call in a
    process (torch 2.13, about one process in eight); one call first."""
    torch.exp(torch.zeros(1))


class JaxF32(JaxModel):
    """The reference model with its embedding rows left in f32."""

    def embed_tokens(self, params, tokens, dist, hot_embed=None):
        if hot_embed is not None and self.cfg.hot_embed_rows:
            return jax_embed_with_cache(params["embed"], tokens, hot_embed, dist)[0]
        return jax_embed_lookup(params["embed"], tokens, dist)


class PortF32(Model):
    """The port's model with its embedding rows left in f32."""

    def embed_tokens(self, params, tokens, dist=None, hot_embed=None):
        if hot_embed is not None and self.cfg.hot_embed_rows:
            return embed_with_cache(params["embed"], tokens, hot_embed, dist)[0]
        return embed_lookup(params["embed"], tokens, dist)


def _cfgs(arch, **overrides):
    jcfg = jax_reduced(jax_get_config(arch), **overrides)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _jax_trainer_and_port(arch, tcfg_kw, num_nodes, **overrides):
    jcfg, cfg = _cfgs(arch, **overrides)
    jt = JaxTrainer(JaxF32(jcfg), JaxTrainConfig(opt=JaxOptConfig(**tcfg_kw.pop("opt")), **tcfg_kw),
                    num_nodes=num_nodes)
    return jcfg, cfg, jt


def test_trainer_run_daemon_states_match_jax():
    """Four steps of ``Trainer.run`` with both daemons sweeping every 2 steps
    (reduced granite-moe, f32, two nodes, remat "full" on both sides, the
    reference's pipeline tokens): the losses, and the daemon states exactly
    (so the daemons fold the forward pass's counts once, not the
    recompute's)."""
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    over = dict(sweep_period=2, hot_embed_rows=16, remat="full")
    jcfg, cfg, jt = _jax_trainer_and_port("granite-moe-1b-a400m", dict(opt=dict(opt), log_every=100), 2,
                                          **over)
    jst = jt.init_state(jax.random.PRNGKey(0))
    jst = jst._replace(params=jax.tree.map(lambda a: a.astype(jnp.float32), jst.params))
    np_params = jax.tree.map(np.asarray, jst.params)
    dkw = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, zipf_a=1.3)
    jst, jh = jt.run(jst, JaxPipeline(JaxDataConfig(**dkw)), 4, log=False)

    tr = Trainer(PortF32(cfg, "cpu"), TrainConfig(opt=OptConfig(**opt), log_every=100), num_nodes=2)
    fresh = tr.init_state(torch.Generator().manual_seed(0))
    np_opt = jax.tree.map(np.asarray, jt.init_state(jax.random.PRNGKey(0)).opt)
    ts = train_state_from_numpy(np_params, (np_opt.m, np_opt.v, np_opt.step), device="cpu")
    ts = ts._replace(expert_placement=fresh.expert_placement, hot_embed=fresh.hot_embed)
    ts, th = tr.run(ts, Pipeline(DataConfig(**dkw), "cpu"), 4, log=False)
    np.testing.assert_allclose([h["loss"] for h in th], [h["loss"] for h in jh], rtol=1e-5)
    assert [h["step"] for h in th] == [1, 2, 3, 4] and ts.data_step == jst.data_step == 4
    ep, jep = ts.expert_placement, jst.expert_placement
    for name in ("counts", "hot_ids", "step", "sweeps", "moved"):
        np.testing.assert_array_equal(getattr(ep, name).numpy(), np.asarray(getattr(jep, name)), err_msg=name)
    he, jhe = ts.hot_embed, jst.hot_embed
    for name in ("counts", "hot_ids", "slot_map", "sweeps"):
        np.testing.assert_array_equal(getattr(he, name).numpy(), np.asarray(getattr(jhe, name)), err_msg=name)
    assert int(ep.sweeps) == 2 and int(he.sweeps) == 2 and th[-1]["moe_hot_frac"] > 0


@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_remat_full_grads_equal_remat_none_bit_for_bit(impl):
    _, cfg = _cfgs("deepseek-moe-16b", moe_impl=impl)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 65)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:])}
    hid = torch.tensor([[0, 2, 4, -1]] * cfg.num_layers, dtype=torch.int32)
    out = {}
    for remat in ("none", "full"):
        model = Model(dataclasses.replace(cfg, remat=remat), "cpu")
        params = model.init(torch.Generator().manual_seed(0))
        leaves = tree_lib.leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, met = model.loss(params, batch, hot_ids=hid)
        out[remat] = (loss.detach(), met["moe_counts"], torch.autograd.grad(loss, leaves))
    assert torch.equal(out["none"][0], out["full"][0]) and torch.equal(out["none"][1], out["full"][1])
    for a, b in zip(out["none"][2], out["full"][2]):
        assert torch.equal(a, b)


def test_each_stacked_leaf_feeds_one_unbind_in_the_step_graph():
    """The layer loop takes ``torch.unbind`` of each stacked ``[L, ...]``
    leaf once a call: in the loss's autograd graph every block leaf has one
    consumer, an ``UnbindBackward``, so its gradient is one stacked tensor
    (indexing ``val[i]`` a layer would give L consumers, each building a
    full-size zero-filled gradient)."""
    cfg = dataclasses.replace(reduced(get_config("deepseek-moe-16b")), num_layers=3)
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    block_leaves = tree_lib.leaves(params["blocks"])
    for leaf in tree_lib.leaves(params):
        leaf.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=torch.Generator().manual_seed(1))
    loss, _ = model.loss(params, {"tokens": toks[:, :-1].int(), "targets": toks[:, 1:].int()})
    consumers = {id(leaf): [] for leaf in block_leaves}
    seen, stack = set(), [loss.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None and type(nxt).__name__ == "AccumulateGrad" and id(nxt.variable) in consumers:
                consumers[id(nxt.variable)].append(type(node).__name__)
            stack.append(nxt)
    assert all(names == ["UnbindBackward0"] for names in consumers.values()), consumers


# ------------------------------------------------ the reference's tests, re-stated

def test_heartbeat_and_elastic_width():
    mon = HeartbeatMonitor(["n0", "n1", "n2", "n3"], timeout=10.0)
    assert len(mon.alive()) == 4
    mon.kill("n2")
    assert mon.dead() == ["n2"]
    assert elastic_data_width(3, model_parallel=1) == 3
    assert elastic_data_width(7, model_parallel=4) == 1
    assert elastic_data_width(3, model_parallel=4) == 0


def test_straggler_backup_dispatch():
    sm = StragglerMonitor(["a", "b", "c"], StragglerPolicy(deadline_factor=2.0, patience=2))
    assert sm.observe({"a": 1.0, "b": 1.0, "c": 5.0}) == []
    fired = sm.observe({"a": 1.0, "b": 1.0, "c": 5.0})
    assert fired and fired[0][0] == "c"
    assert sm.backup_dispatches == fired


def test_train_driver_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "3", "--batch", "2",
         "--seq", "32", "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "3"],
        capture_output=True, text=True, env=env, timeout=120, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=deepseek-moe-16b family=moe params=") and "devices=1" in lines[0]
    assert any(ln.startswith("done: loss ") and "over 3 steps" in ln for ln in lines)
    assert any(ln.startswith("expert replica hit rate") for ln in lines)
    assert any(ln.startswith("hot-row embedding hit rate") for ln in lines)
    assert os.path.exists(os.path.join(str(tmp_path), "step_00000003", "manifest.json"))
    if not torch.cuda.is_available():  # the card by default: without one it raises
        bad = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--steps", "1"],
                             capture_output=True, text=True, env=env, timeout=120, cwd=str(tmp_path))
        assert bad.returncode != 0 and "device='cpu'" in bad.stderr


@pytest.mark.parametrize("arch", ["llama3.2-3b", "yi-9b", "mistral-large-123b", "granite-moe-1b-a400m",
                                  "deepseek-moe-16b", "qwen3-1.7b"])
def test_port_configs_equal_the_references(arch):
    want = jax_get_config(arch)
    got = get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.padded_vocab == want.padded_vocab and got.resolved_head_dim == want.resolved_head_dim
    assert dataclasses.asdict(reduced(got)) == dataclasses.asdict(jax_reduced(want))
