"""The ``Trainer`` and the training driver on the ``ssm``, ``hybrid``,
``audio`` and ``vlm`` families, on the CPU, against the JAX reference's
(``Model.loss`` itself is in ``tests/test_torch_family_train.py``).

* ``Trainer.step`` with 2 microbatches on a batch that carries ``patches``
  (vlm) or ``frames`` (audio): every leaf of the batch is split by rows, so
  the step equals the reference's jitted step (its ``reshape`` of every
  leaf) from the same state: the loss and grad norm at rtol 1e-5, ``m``
  and ``v`` (the averaged gradient and its square) at relative L2 1e-5,
  the step count exactly, and each param's update at relative L2 1e-3
  (measured 2.9e-4 vlm, 1.2e-4 audio): the first AdamW step divides each
  gradient element by its own magnitude plus ``eps``, so an element whose
  gradient is near ``eps`` carries its f32 difference into the update
  undamped. f32 models (the embedding rows kept in f32 by a test subclass
  on both sides, params cast to f32), as ``tests/test_torch_trainer.py``
  holds the dense and MoE step.
* ``Trainer.run`` of rwkv6 and recurrentgemma with the hot-row embedding
  daemon sweeping every 2 steps, on the reference pipeline's tokens: the
  losses at rtol 1e-5 (f32; the sums run in another order) and the daemon
  state exactly (counts, cached rows, slot map, sweeps), as
  ``tests/test_torch_trainer_loop.py`` holds dense and MoE.

The training driver on these families is in
``tests/test_torch_family_train_driver.py``.
"""

import dataclasses

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
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.train.optim import OptConfig as JaxOptConfig  # noqa: E402
from repro.train.trainer import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.core.hot_embedding import embed_with_cache  # noqa: E402
from repro_torch.data import DataConfig, Pipeline  # noqa: E402
from repro_torch.dist import embed_lookup  # noqa: E402
from repro_torch.interop import train_state_from_numpy  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train import OptConfig, TrainConfig, Trainer  # noqa: E402



@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """PyTorch's CPU ``exp`` can be off by ~1e-4 on its first call in a
    process (torch 2.13, about one process in eight); one call first."""
    torch.exp(torch.zeros(1))


class JaxF32(JaxModel):
    """The reference model with its embedding rows left in f32."""

    def embed_tokens(self, params, tokens, dist, hot_embed=None):
        if hot_embed is not None and self.cfg.hot_embed_rows:
            h = jax_embed_with_cache(params["embed"], tokens, hot_embed, dist)[0]
        else:
            h = jax_embed_lookup(params["embed"], tokens, dist)
        if self.cfg.pos == "sinusoidal":
            h = h + jax_encdec.sinusoid(tokens.shape[-1], self.cfg.d_model)[None]
        return h


class PortF32(Model):
    """The port's model with its embedding rows left in f32."""

    def embed_tokens(self, params, tokens, dist=None, hot_embed=None):
        if hot_embed is not None and self.cfg.hot_embed_rows:
            h = embed_with_cache(params["embed"], tokens, hot_embed, dist)[0]
        else:
            h = embed_lookup(params["embed"], tokens, dist)
        if self.cfg.pos == "sinusoidal":
            h = h + encdec.sinusoid(tokens.shape[-1], self.cfg.d_model, h.device)[None]
        return h


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _setup(arch, tcfg_kw, num_nodes=1, **overrides):
    """The reference trainer on the reduced config, its fresh state with
    f32 params, and the port's config."""
    jcfg = jax_reduced(jax_get_config(arch), **overrides)
    opt = JaxOptConfig(**tcfg_kw["opt"])
    jt = JaxTrainer(JaxF32(jcfg), JaxTrainConfig(opt=opt, **{k: v for k, v in tcfg_kw.items() if k != "opt"}),
                    num_nodes=num_nodes)
    st = jt.init_state(jax.random.PRNGKey(0))
    st = st._replace(params=jax.tree.map(lambda a: a.astype(jnp.float32), st.params))
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), jt, st


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-base"])
def test_trainer_step_with_microbatches_on_patches_and_frames_matches_jax(arch):
    opt = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jcfg, cfg, jt, st = _setup(arch, dict(opt=opt, microbatches=2))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    extra = "patches" if cfg.family == "vlm" else "frames"
    rows = cfg.num_patches if cfg.family == "vlm" else cfg.num_frames
    batch[extra] = np.asarray(jnp.asarray(rng.standard_normal((4, rows, cfg.d_model)), jnp.bfloat16))
    np_params, np_opt = jax.tree.map(np.asarray, st.params), jax.tree.map(np.asarray, st.opt)
    jp, jo, jmet = jt._step_fn(st.params, st.opt, jax.tree.map(jnp.asarray, batch), None, None)

    tr = Trainer(PortF32(cfg, "cpu"), TrainConfig(opt=OptConfig(**opt), microbatches=2))
    ts = train_state_from_numpy(np_params, (np_opt.m, np_opt.v, np_opt.step), device="cpu")
    tb = {"tokens": torch.from_numpy(batch["tokens"]), "targets": torch.from_numpy(batch["targets"]),
          extra: torch.from_numpy(batch[extra].astype(np.float32)).to(torch.bfloat16)}
    # Each microbatch's loss sees its own rows of every leaf of the batch.
    seen = []
    loss_fn = tr.model.loss

    def recording_loss(params, mb, *args, **kw):
        seen.append({k: v.clone() for k, v in mb.items()})
        return loss_fn(params, mb, *args, **kw)

    tr.model.loss = recording_loss
    before = [leaf.detach().clone() for leaf in tree_lib.leaves(ts.params)]
    p2, o2, met = tr.step(ts.params, ts.opt, tb, None, None)
    assert [set(mb) for mb in seen] == [set(tb)] * 2
    for i, mb in enumerate(seen):
        for k, v in mb.items():
            assert torch.equal(v, tb[k][2 * i:2 * i + 2]), (i, k)
    assert p2 is ts.params and int(o2.step) == int(jo.step) == 1
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-5)
    for tree_t, tree_j in ((o2.m, jo.m), (o2.v, jo.v)):
        for got, want in zip(tree_lib.leaves(tree_t), jax.tree.leaves(tree_j)):
            assert _rel(got.numpy(), np.asarray(want)) < 1e-5
    for (path, want), got, old in zip(jax.tree_util.tree_flatten_with_path(jp)[0], tree_lib.leaves(p2), before):
        assert _rel(got.detach().numpy() - old.numpy(), np.asarray(want) - old.numpy()) < 1e-3, path


@pytest.mark.parametrize("arch,seq", [("rwkv6-1.6b", 64), ("recurrentgemma-2b", 96)])
def test_trainer_run_with_the_hot_row_daemon_matches_jax(arch, seq):
    """Four steps, the daemon sweeping at steps 2 and 4 (two nodes, remat
    "full" on both sides); recurrentgemma's 96 tokens pass its reduced
    64-token window."""
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    over = dict(sweep_period=2, hot_embed_rows=16, remat="full")
    jcfg, cfg, jt, jst = _setup(arch, dict(opt=opt, log_every=100), 2, **over)
    np_params = jax.tree.map(np.asarray, jst.params)
    np_opt = jax.tree.map(np.asarray, jst.opt)
    dkw = dict(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=4, zipf_a=1.3)
    jst, jh = jt.run(jst, JaxPipeline(JaxDataConfig(**dkw)), 4, log=False)

    tr = Trainer(PortF32(cfg, "cpu"), TrainConfig(opt=OptConfig(**opt), log_every=100), num_nodes=2)
    assert tr.expert_daemon is None and tr.embed_daemon is not None
    ts = train_state_from_numpy(np_params, (np_opt.m, np_opt.v, np_opt.step), device="cpu")
    ts = ts._replace(hot_embed=tr.embed_daemon.init_state("cpu"))
    ts, th = tr.run(ts, Pipeline(DataConfig(**dkw), "cpu"), 4, log=False)
    np.testing.assert_allclose([h["loss"] for h in th], [h["loss"] for h in jh], rtol=1e-5)
    assert [h["step"] for h in th] == [1, 2, 3, 4] and ts.data_step == jst.data_step == 4
    he, jhe = ts.hot_embed, jst.hot_embed
    for name in ("counts", "hot_ids", "slot_map", "sweeps"):
        np.testing.assert_array_equal(getattr(he, name).numpy(), np.asarray(getattr(jhe, name)), err_msg=name)
    assert int(he.sweeps) == 2 and int((he.hot_ids >= 0).sum()) > 0
