"""Training of the ``ssm``, ``hybrid``, ``audio`` and ``vlm`` families on
the CPU: the port's ``Model.loss`` and every leaf's gradient against
``jax.value_and_grad`` of the reference's on the same params (carried
across with ``params_from_numpy``) and the same batch, with remat off and
on; remat's gradients against no-remat's; the RG-LRU scan's gradient.
``Trainer`` and the launcher are in ``tests/test_torch_family_trainer.py``;
the card's kernel path against the kernels' plain versions
(``cuda``-marked, in a file that imports no JAX) in
``tests/test_torch_package.py``. The loss cases of the audio and vlm
families run from ``tests/test_torch_family_train_encdec.py`` (this file's
``check_family_loss``), so that the two files spread over the test
workers.

The reduced configs (``reduced``), each cut so that the training paths
that the full configs take are taken: rwkv6 over 64 tokens (two chunks of
the wkv recurrence); recurrentgemma over 160 tokens with a 64-token window
and chunks of 32 (the window masks whole chunks); whisper with 40 frames,
24 tokens and chunks of 16, so that the encoder pads q and kv (40 -> 48,
as 1,500 frames pad to 2,048 at full size), the decoder pads q and kv
(24 -> 32) and the cross attention pads and masks the memory; and whisper
at its reduced defaults too (32 frames, no padding); llava with 16 patch
rows before 48 token rows. rwkv6, recurrentgemma and llava read their
embeddings through the hot-row cache (``embed_with_cache``) holding the
batch's 8 most frequent tokens.

Bars, each with its reason:

* f32 (both models' embedding rows kept in f32 by a test subclass, params
  cast to f32) — loss rtol 1e-5; every leaf's gradient by relative L2
  1e-5 (measured at most 2.8e-6), but 5e-5 for ``ssm`` (measured 1.2e-5):
  the wkv chunk scales keys by ``exp(-cum)`` and queries by ``exp(cum)``
  of a 32-token f32 log-decay sum, which XLA adds in another order
  (``jnp.cumsum``'s blocks of 16), and those factors carry its rounding
  into every gradient;
* bf16 (the models as configured) — loss rtol 5e-3, every leaf's gradient
  by relative L2 0.05 (measured 0.013 vlm, 0.018 audio, 0.034 hybrid); the
  bf16 products round in another order (XLA's CPU dots against
  PyTorch's). ``ssm`` is held to the f32 model instead: the bf16 RWKV
  stack's gradients are far from its f32 gradients in both packages (the
  reference's up to 0.44 relative L2 in a leaf, over five batches), so
  port and reference differ by up to 0.29 between themselves; each leaf of
  the port's bf16 gradient must be no further from the reference's f32
  gradient than twice the reference's bf16 gradient is, plus 0.01
  (measured at most 1.58 times). The f32 cases are the tight check of the
  same code;
* remat — the port's ``remat="full"`` loss and gradients equal its
  ``"none"`` ones bit for bit (the recompute runs the same ops on the same
  inputs), and the remat'd functions run twice a layer;
* the scan — ``associative_scan``'s gradient passes
  ``torch.autograd.gradcheck`` in f64 and equals a sequential scan's.
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
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import ModelConfig, get_config, reduced  # noqa: E402
from repro_torch.core.hot_embedding import embed_with_cache  # noqa: E402
from repro_torch.dist import embed_lookup  # noqa: E402
from repro_torch.interop import hot_embedding_state_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import encdec, rglru, rwkv6  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

# case -> (arch, config overrides, token rows a sequence)
CASES = {
    "ssm": ("rwkv6-1.6b", {}, 64),
    "hybrid": ("recurrentgemma-2b", {"attn_chunk": 32}, 160),
    "audio": ("whisper-base", {}, 24),
    "audio_padded": ("whisper-base", {"num_frames": 40, "attn_chunk": 16}, 24),
    "vlm": ("llava-next-34b", {}, 48),
}
F32_BAR = {"ssm": 5e-5}


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


def _bf16_numpy(rng, shape):
    """Standard normal values rounded to bf16 (as ``ml_dtypes`` arrays)."""
    return np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))


def _to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _batch(cfg, seq, seed=0):
    """tokens from a narrow range (so that the hot rows hit), targets with
    three masked, and bf16 patches or frames: numpy arrays."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 64, (2, seq)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)
    targets[0, :3] = -1
    batch = {"tokens": toks, "targets": targets}
    if cfg.family == "vlm":
        batch["patches"] = _bf16_numpy(rng, (2, cfg.num_patches, cfg.d_model))
    if cfg.family == "audio":
        batch["frames"] = _bf16_numpy(rng, (2, cfg.num_frames, cfg.d_model))
    return batch


def _hot_state(cfg, toks):
    """A hot-row cache holding the batch's 8 most frequent tokens, or
    ``None`` where the config has no cache."""
    if not cfg.hot_embed_rows:
        return None
    vals, cnt = np.unique(toks, return_counts=True)
    hot = vals[np.argsort(-cnt, kind="stable")][:8].astype(np.int32)
    hot_ids = np.full(cfg.hot_embed_rows, -1, np.int32)
    hot_ids[: len(hot)] = hot
    slot_map = np.full(cfg.padded_vocab, -1, np.int32)
    slot_map[hot] = np.arange(len(hot), dtype=np.int32)
    return np.zeros((cfg.padded_vocab, 2), np.float32), hot_ids, slot_map, np.zeros((), np.int32)


def _embed_index(params) -> int:
    """The position of ``embed`` among the leaves in tree order."""
    return [path for path, _ in tree_lib.leaves_with_paths(params)].index((("key", "embed"),))


def _cfgs(case, **extra):
    arch, over, seq = CASES[case]
    jcfg = jax_reduced(jax_get_config(arch), **over, **extra)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg)), seq


PRECISIONS = [("f32", "none"), ("f32", "full"), ("bf16", "full")]
# The cases this file runs; the others' are in tests/test_torch_family_train_encdec.py.
HERE = ("ssm", "hybrid")


@pytest.mark.parametrize("precision,remat", PRECISIONS)
@pytest.mark.parametrize("case", HERE)
def test_family_loss_and_grads_match_jax(case, precision, remat):
    check_family_loss(case, precision, remat)


def check_family_loss(case, precision, remat):
    """One case's loss, xent and every gradient against the reference's."""
    jcfg, cfg, seq = _cfgs(case, remat=remat)
    f32 = precision == "f32"
    jm = JaxF32(jcfg) if f32 else JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    if f32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    batch = _batch(cfg, seq, seed=len(case))
    hot = _hot_state(cfg, batch["tokens"])

    def f(p, b, he):
        return jm.loss(p, b, None, hot_embed=he)

    (jl, jmet), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch), None if hot is None else JaxHotState(*map(jnp.asarray, hot)))

    model = (PortF32 if f32 else Model)(cfg, "cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    leaves = tree_lib.leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, met = model.loss(tp, {k: _to_torch(v) for k, v in batch.items()},
                           hot_embed=None if hot is None else hot_embedding_state_from_numpy(*hot, device="cpu"))
    grads = torch.autograd.grad(loss, leaves)
    assert set(met) == set(jmet) == {"xent", "loss"}
    rtol = 1e-5 if f32 else 5e-3
    np.testing.assert_allclose(float(loss), float(jl), rtol=rtol)
    np.testing.assert_allclose(float(met["xent"]), float(jmet["xent"]), rtol=rtol)
    family = case.split("_")[0]
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(want) == len(grads)
    if family == "ssm" and not f32:  # held to the f32 model (module docstring)
        jf = JaxF32(jcfg)
        _, truth = jax.jit(jax.value_and_grad(lambda p, b, he: jf.loss(p, b, None, hot_embed=he),
                                              has_aux=True))(
            jax.tree.map(lambda a: a.astype(jnp.float32), params), jax.tree.map(jnp.asarray, batch),
            None if hot is None else JaxHotState(*map(jnp.asarray, hot)))
        for (path, w), t, got in zip(want, jax.tree.leaves(truth), grads):
            ref_err = _rel(np.asarray(w, np.float32), t)
            assert _rel(got.float().numpy(), t) <= 2 * ref_err + 0.01, (path, ref_err)
    bar = F32_BAR.get(family, 1e-5) if f32 else 0.05
    for (path, w), got, leaf in zip(want, grads, leaves):
        assert got.shape == leaf.shape == w.shape and got.dtype == leaf.dtype, path
        if f32 or family != "ssm":
            assert _rel(got.float().numpy(), np.asarray(w, np.float32)) < bar, path
    assert float(grads[_embed_index(tp)].float().abs().sum()) > 0


# The functions that run under remat, by family: each must run twice a
# layer with remat "full" (forward, then again in the backward pass) and
# once with "none".
REMAT_FNS = {
    "ssm": [(rwkv6, "time_mix")],
    "hybrid": [(rglru, "rec_block"), (tfm, "attn_full")],
    "audio": [(tfm, "attn_full")],
    "audio_padded": [(tfm, "attn_full")],
    "vlm": [(tfm, "attn_full")],
}


@pytest.mark.parametrize("case", list(CASES))
def test_remat_full_equals_remat_none_bit_for_bit(case, monkeypatch):
    arch, over, seq = CASES[case]
    batch = {k: _to_torch(v) for k, v in _batch(reduced(get_config(arch), **over), seq).items()}
    calls = {}
    for mod, name in REMAT_FNS[case]:
        fn = getattr(mod, name)

        def counting(*args, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kw)

        monkeypatch.setattr(mod, name, counting)
    out = {}
    for remat in ("none", "full"):
        cfg = reduced(get_config(arch), remat=remat, **over)
        model = Model(cfg, "cpu")
        params = model.init(torch.Generator().manual_seed(0))
        leaves = tree_lib.leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        calls.clear()
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        out[remat] = (loss.detach(), grads, dict(calls))
    assert torch.equal(out["none"][0], out["full"][0])
    for a, b in zip(out["none"][1], out["full"][1]):
        assert torch.equal(a, b)
    assert {k: 2 * v for k, v in out["none"][2].items()} == out["full"][2] and out["none"][2]


def test_associative_scan_gradient():
    """The scan's slice writes into ``new_empty`` carry the gradient: f64
    ``gradcheck`` at odd and even lengths, and the gradient equal (to f64
    rounding) to a sequential scan's ``h_t = a_t h_{t-1} + b_t``."""
    gen = torch.Generator().manual_seed(0)
    for s in (1, 2, 7, 16):
        a = torch.rand((2, s, 3), generator=gen, dtype=torch.float64, requires_grad=True)
        b = torch.randn((2, s, 3), generator=gen, dtype=torch.float64, requires_grad=True)
        assert torch.autograd.gradcheck(lambda x, y: rglru.associative_scan((x, y), 1), (a, b))
        va, vb = rglru.associative_scan((a, b), 1)
        hs, h, p = [], torch.zeros_like(b[:, 0]), torch.ones_like(a[:, 0])
        for t in range(s):
            h, p = a[:, t] * h + b[:, t], p * a[:, t]
            hs.append(torch.stack([p, h]))
        want = torch.stack(hs, dim=2)  # [2, B, S, W]
        w = torch.randn((2, 2, s, 3), generator=gen, dtype=torch.float64)
        got_g = torch.autograd.grad((torch.stack([va, vb]) * w).sum(), (a, b))
        want_g = torch.autograd.grad((want * w).sum(), (a, b))
        for g1, g2 in zip(got_g, want_g):
            torch.testing.assert_close(g1, g2, rtol=1e-12, atol=1e-12)


def test_training_forwards_keep_no_serving_state():
    """The audio family's training decoder writes no caches (the loss
    does not read them), and the serving routes are untouched: without
    ``train`` the encoder and decoder attention and the cross attention go
    through ``flash_attention`` (its plain version here) and never
    through ``blockwise_attention``."""
    cfg = reduced(get_config("whisper-base"))
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    frames = torch.randn((1, cfg.num_frames, cfg.d_model)).to(torch.bfloat16)
    h = torch.randn((1, 8, cfg.d_model)).to(torch.bfloat16)
    memory = encdec.encode(params["blocks"], frames, cfg, train=True)
    out, self_kv, cross_kv = encdec.decode_prefill(params["blocks"], h, memory, cfg, train=True)
    assert out.shape == h.shape and self_kv is None and cross_kv is None
    calls = {"flash": 0, "blockwise": 0}
    flash, blockwise = tfm.flash_attention, tfm.blockwise_attention

    def count(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    tfm.flash_attention, tfm.blockwise_attention = count("flash", flash), count("blockwise", blockwise)
    try:
        memory = encdec.encode(params["blocks"], frames, cfg)
        _, (k, _), (ck, _) = encdec.decode_prefill(params["blocks"], h, memory, cfg)
    finally:
        tfm.flash_attention, tfm.blockwise_attention = flash, blockwise
    assert calls == {"flash": cfg.encoder_layers + 2 * cfg.num_layers, "blockwise": 0}
    assert k.shape[:3] == (cfg.num_layers, 1, 8) and ck.shape[2] == cfg.num_frames
