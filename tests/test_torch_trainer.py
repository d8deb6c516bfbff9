"""The assembled training path against the JAX reference on the CPU:
``Model.loss`` and its gradients and one ``Trainer`` step, from params
carried across with ``params_from_numpy`` (``Trainer.run`` with both
daemons, remat and the reference's own trainer tests are in
``tests/test_torch_trainer_loop.py``).

Bars, each with its reason:

* f32 (both models' embedding rows kept in f32 by a test subclass, params
  cast to f32) — loss rtol 1e-5, every leaf's gradient by relative L2 1e-5
  (measured 1.5e-6): f32 sums in another order; the routing is the same.
  A step's update is held the same way (5e-5), and its ``m`` and ``v`` at
  1e-3 (the reason is at the assert).
* bf16 (the models as they are) — loss rtol 5e-3 and relative L2 0.05 a
  leaf for dense, 0.25 for MoE. The bf16 matmuls round in another order
  (XLA's CPU dots against PyTorch's), which moves near-tied router picks
  and capacity drops, and each moved pick moves whole rows of the
  gradient (measured: 0.016 dense, up to 0.12 MoE). The f32 cases are the
  tight check of the same code.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.hot_embedding import HotEmbeddingState as JaxHotState  # noqa: E402
from repro.core.hot_embedding import embed_with_cache as jax_embed_with_cache  # noqa: E402
from repro.dist import embed_lookup as jax_embed_lookup  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.train.optim import OptConfig as JaxOptConfig  # noqa: E402
from repro.train.trainer import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.core.hot_embedding import embed_with_cache  # noqa: E402
from repro_torch.dist import embed_lookup  # noqa: E402
from repro_torch.interop import hot_embedding_state_from_numpy, params_from_numpy, train_state_from_numpy  # noqa: E402,E501
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


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _hot_state(cfg, toks):
    """A hot-row cache holding the batch's 8 most frequent tokens."""
    vals, cnt = np.unique(toks, return_counts=True)
    hot = vals[np.argsort(-cnt, kind="stable")][: min(8, cfg.hot_embed_rows)].astype(np.int32)
    hot_ids = np.full(cfg.hot_embed_rows, -1, np.int32)
    hot_ids[: len(hot)] = hot
    slot_map = np.full(cfg.padded_vocab, -1, np.int32)
    slot_map[hot] = np.arange(len(hot), dtype=np.int32)
    counts = np.zeros((cfg.padded_vocab, 2), np.float32)
    return counts, hot_ids, slot_map, np.zeros((), np.int32)


LOSS_CASES = [  # arch, moe_impl, hot expert ids, hot rows
    ("deepseek-moe-16b", "einsum", False, False),
    ("deepseek-moe-16b", "einsum", True, True),
    ("deepseek-moe-16b", "sort", False, False),
    ("deepseek-moe-16b", "sort", True, True),
    ("qwen3-1.7b", "einsum", False, True),
]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("arch,impl,hot_experts,hot_rows", LOSS_CASES)
def test_model_loss_and_grads_match_jax(arch, impl, hot_experts, hot_rows, precision):
    jcfg, cfg = _cfgs(arch, moe_impl=impl)
    f32 = precision == "f32"
    jm = JaxF32(jcfg) if f32 else JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    if f32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    rng = np.random.default_rng(len(arch) + hot_rows)
    toks = rng.integers(0, 64, (2, 64)).astype(np.int32)  # a narrow range: the hot rows hit
    targets = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    targets[0, :5] = -1  # masked
    batch = {"tokens": toks, "targets": targets}
    hid = np.tile(np.array([1, 3, -1, 5], np.int32), (cfg.num_layers, 1)) if hot_experts else None
    hot = _hot_state(cfg, toks) if hot_rows else None

    def f(p, b, h, he):
        return jm.loss(p, b, None, hot_ids=h, hot_embed=he)

    (jl, jmet), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch), None if hid is None else jnp.asarray(hid),
        None if hot is None else JaxHotState(*map(jnp.asarray, hot)))

    model = (PortF32 if f32 else Model)(cfg, "cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    leaves = tree_lib.leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, met = model.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                           hot_ids=None if hid is None else torch.from_numpy(hid),
                           hot_embed=None if hot is None else hot_embedding_state_from_numpy(*hot, device="cpu"))
    grads = torch.autograd.grad(loss, leaves)
    assert set(met) == set(jmet)
    loss_rtol = 1e-5 if f32 else 5e-3
    np.testing.assert_allclose(float(loss), float(jl), rtol=loss_rtol)
    np.testing.assert_allclose(float(met["xent"]), float(jmet["xent"]), rtol=loss_rtol)
    if cfg.num_experts:
        assert met["moe_counts"].shape == jmet["moe_counts"].shape
        if f32:
            np.testing.assert_array_equal(met["moe_counts"].numpy(), np.asarray(jmet["moe_counts"]))
            for key in ("moe_dropped", "moe_hot_frac"):
                assert float(met[key]) == float(jmet[key]), key
        assert (float(met["moe_hot_frac"]) > 0) == hot_experts
    bar = 1e-5 if f32 else (0.25 if cfg.num_experts else 0.05)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jg)[0], grads):
        assert got.dtype == leaves[0].dtype or got.shape == want.shape
        assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < bar, path


def _jax_trainer_and_port(arch, tcfg_kw, num_nodes, **overrides):
    jcfg, cfg = _cfgs(arch, **overrides)
    jt = JaxTrainer(JaxF32(jcfg), JaxTrainConfig(opt=JaxOptConfig(**tcfg_kw.pop("opt")), **tcfg_kw),
                    num_nodes=num_nodes)
    return jcfg, cfg, jt


def _jax_int8_levels(jt, params, batch, hot_ids, step):
    """The reference step's ``g / scale + u`` of every param leaf before its
    stochastic rounding (``src/repro/train/compress.py``): the step's
    microbatch gradients, averaged, and the uniforms of its keys."""
    model, m = jt.model, jt.cfg.microbatches

    def levels(params, batch, hot_ids, step):
        mbs = jax.tree.map(lambda x: x.reshape(m, x.shape[0] // m, *x.shape[1:]), batch)

        def micro(acc, mb):
            g = jax.grad(lambda p: model.loss(p, mb, None, hot_ids=hot_ids, hot_embed=None)[0])(params)
            return jax.tree.map(lambda a, b: a + b.astype(jnp.float32), acc, g), None

        g0 = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        leaves = jax.tree.leaves(jax.lax.scan(micro, g0, mbs)[0])
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(12), step), len(leaves))
        out = []
        for g, k in zip(leaves, keys):
            g = g / m
            out.append(g / (jnp.maximum(jnp.max(jnp.abs(g)), 1e-12) / 127.0) + jax.random.uniform(k, g.shape))
        return out

    return [np.asarray(x) for x in jax.jit(levels)(params, batch, hot_ids, step)]


# Where the reference's ``g / scale + u`` lies within this many levels of an
# integer, f32 noise decides its floor: the two packages' pre-rounding
# gradients agree to ~1e-6 relative L2, which put the flipped elements of
# this case at most 2.5e-5 of a level from an integer.
NEAR_LEVEL = 1e-4
MAX_FLIPPED_UPDATES = 16


def test_trainer_step_with_microbatches_and_int8_matches_jax():
    """One jitted reference step (two microbatches, int8 compression keyed by
    ``fold_in(PRNGKey(12), step)``) against the port's eager step, from the
    same state: loss, grad norm, the update of every param leaf, ``m``, ``v``
    and the step count.

    The update is held element by element where the int8 level is defined:
    every element whose reference ``g / scale + u`` lies farther than
    ``NEAR_LEVEL`` from an integer meets the leaf's relative L2 bar of 5e-5;
    an element within it may land on the other level, and AdamW's first
    step turns a level of 0 against one of +-1 into an update of 0 against
    +-lr, so it may differ by at most ``lr`` (one Adam sign). Fewer than
    ``MAX_FLIPPED_UPDATES`` elements in the whole tree may do so."""
    opt = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    kw = dict(microbatches=2, grad_compression="int8")
    jcfg, cfg, jt = _jax_trainer_and_port("deepseek-moe-16b", dict(opt=dict(opt), **kw), 2)
    st = jt.init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), st.params)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    hid = np.asarray(st.expert_placement.hot_ids)
    np_params, np_opt = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, st.opt)
    levels = _jax_int8_levels(jt, params, jax.tree.map(jnp.asarray, batch), jnp.asarray(hid), st.opt.step)
    jp, jo, jmet = jt._step_fn(params, st.opt, jax.tree.map(jnp.asarray, batch), jnp.asarray(hid), None)

    tr = Trainer(PortF32(cfg, "cpu"), TrainConfig(opt=OptConfig(**opt), **kw), num_nodes=2)
    ts = train_state_from_numpy(np_params, (np_opt.m, np_opt.v, np_opt.step), device="cpu")
    before = [leaf.detach().clone() for leaf in tree_lib.leaves(ts.params)]
    p2, o2, met = tr.step(ts.params, ts.opt, {k: torch.from_numpy(v) for k, v in batch.items()},
                          torch.from_numpy(hid), None)
    assert p2 is ts.params and int(o2.step) == int(jo.step) == 1
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-5)
    np.testing.assert_array_equal(met["moe_counts"].numpy(), np.asarray(jmet["moe_counts"]))
    flipped = 0
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(leaves) == len(levels)
    for (path, want), got, old, x in zip(leaves, tree_lib.leaves(p2), before, levels):
        d_got, d_want = got.detach().numpy() - old.numpy(), np.asarray(want) - old.numpy()
        near = np.abs(x - np.round(x)) <= NEAR_LEVEL
        far = ~near
        assert _rel(d_got[far], d_want[far]) < 5e-5, path
        gap = np.abs(d_got[near] - d_want[near]).astype(np.float64)
        assert np.all(gap <= opt["lr"] * (1 + 1e-3)), path
        flipped += int(np.sum(gap > 1e-6))
    print(f"elements within {NEAR_LEVEL} of a level whose update moved by one Adam sign: {flipped}")
    assert flipped < MAX_FLIPPED_UPDATES
    # m and v carry the int8 grads' magnitudes: where ``x + u`` of the
    # stochastic rounding sits within f32 noise of an integer, one element
    # moves by one level (a few in 10**5 here), so relative L2 1e-3.
    for tree_t, tree_j in ((o2.m, jo.m), (o2.v, jo.v)):
        for got, want in zip(tree_lib.leaves(tree_t), jax.tree.leaves(tree_j)):
            assert _rel(got.numpy(), np.asarray(want)) < 1e-3
