"""The training slice's modules against the JAX reference, module by module,
on the CPU: the sort dispatch, ``blockwise_attention``, ``softmax_xent``,
the gradient through ``moe_router``, AdamW, the data pipeline, gradient
compression and checkpoints.

Inputs are made with numpy from a seed and handed to both packages. Bars,
each with its reason:

* sort indices (``src_tok``, ``dest``), ``keep_gates``, ``expert_in``,
  ``counts``, ``dropped``, ``hot_frac``, pipeline tokens, int8 payloads,
  top-k picks and checkpoint bytes — exact: integer work, copies, or the
  same f32 draws;
* ``sort_combine`` — f32 at rtol 1e-6 (the same adds in the same order;
  the bar leaves room for an ulp), bf16 at ``tests/test_torch_moe.py``'s
  bf16 bar (atol 2e-2);
* f32 layers and their gradients (``moe_apply`` both ways,
  ``blockwise_attention``, ``softmax_xent``, the router's gradient) —
  rtol 1e-5 with a small atol: f32 sums in another order, ``exp`` an ulp
  apart between XLA and PyTorch;
* ``moe_apply(moe_impl="sort")`` in bf16 — atol 2e-2, the reference's own
  bar for bf16 MoE outputs;
* AdamW — rtol 1e-6 on params, ``m`` and ``v`` (``pow``, ``sqrt`` and the
  f32 sums an ulp apart), ``global_norm`` rtol 1e-6.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.dist import softmax_xent as jax_softmax_xent  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train import compress as jax_compress  # noqa: E402
from repro.train import optim as jax_optim  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.dist import softmax_xent  # noqa: E402
from repro_torch.interop import opt_state_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels.moe_router.ops import moe_router  # noqa: E402
from repro_torch.kvsim import prng  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.attention import blockwise_attention  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import compress, optim  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """PyTorch's CPU ``exp`` can be off by ~1e-4 on its first call in a
    process (torch 2.13, about one process in eight); one call first."""
    torch.exp(torch.zeros(1))


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _req(tree):
    if isinstance(tree, dict):
        return {k: _req(v) for k, v in tree.items()}
    return tree.requires_grad_(True)


def _cfg_pair(**overrides):
    jcfg = jax_reduced(jax_get_config("deepseek-moe-16b"), **overrides)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


# ------------------------------------------------------------ sort dispatch

def _assignments(seed, g, s, k, e, *, one_expert_group=True):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, e, (g, s, k)).astype(np.int32)
    for j in range(1, k):  # distinct experts within a token's slots
        idx[..., j] = (idx[..., 0] + 1 + rng.integers(0, e - 1, (g, s))) % e if j == 1 else \
            (idx[..., j - 1] + 1) % e
    if one_expert_group:
        idx[0, :, 0] = 2  # every token of group 0 sends slot 0 to expert 2: drops
    gates = rng.random((g, s, k)).astype(np.float32)
    active = rng.random((g, s, k)) < 0.8  # inactive slots
    return idx, gates, active


SORT_CASES = [(3, 40, 2, 8, 8), (2, 64, 3, 6, 12), (1, 16, 2, 4, 4)]  # g, s, k, e, capacity


@pytest.mark.parametrize("g,s,k,e,cap", SORT_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sort_dispatch_and_combine_match_jax(g, s, k, e, cap, dtype):
    idx, gates, active = _assignments(g * s + e, g, s, k, e)
    x = np.random.default_rng(s).standard_normal((g, s, 16)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    want = jax_moe.sort_dispatch(xj, jnp.asarray(idx), jnp.asarray(gates), jnp.asarray(active), e, cap)
    xt = params_from_numpy(_np(xj), "cpu")
    got = moe.sort_dispatch(xt, _t(idx), _t(gates), _t(active), e, cap)
    names = ("expert_in", "src_tok", "dest", "keep_gates")
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(a.float().numpy() if a.is_floating_point() else a.numpy(),
                                      np.asarray(b, np.float32) if name in ("expert_in", "keep_gates")
                                      else np.asarray(b), err_msg=name)
    assert int((got[2] == e * cap).sum()) > 0  # drops happen
    # combine: gate-scaled expert outputs back to tokens.
    out = np.random.default_rng(g + k).standard_normal((e, g, cap, 16)).astype(np.float32)
    oj = jnp.asarray(out).astype(jdt)
    yw = jax_moe.sort_combine(oj, want[1], want[2], s)
    yg = moe.sort_combine(params_from_numpy(_np(oj), "cpu"), got[1], got[2], s)
    assert yg.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(yg.numpy(), _np(yw), rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(yg.float().numpy(), np.asarray(yw, np.float32), rtol=0, atol=2e-2)


@pytest.mark.parametrize("hot", [False, True], ids=["cold", "hot_ids"])
def test_moe_apply_sort_matches_jax(hot):
    jcfg, cfg = _cfg_pair(moe_impl="sort")
    jp = jax_init_params(jax_moe.moe_specs(jcfg, ()), jax.random.PRNGKey(3))
    x = jnp.asarray(np.random.default_rng(3).standard_normal((2, 128, cfg.d_model)).astype(np.float32))
    x = x.astype(jnp.bfloat16)
    hid = np.array([1, 3, -1, 5], np.int32) if hot else None
    yj, sj = jax.jit(lambda p, xx: jax_moe.moe_apply(p, xx, jcfg, None, None if hid is None else jnp.asarray(hid)))(jp, x)
    yt, st = moe.moe_apply(params_from_numpy(jax.tree.map(_np, jp), "cpu"), params_from_numpy(_np(x), "cpu"),
                           cfg, None, None if hid is None else _t(hid))
    np.testing.assert_array_equal(st["counts"].numpy(), _np(sj["counts"]))
    for key in ("dropped", "hot_frac"):
        assert float(st[key]) == float(sj[key]), key
    assert float(st["dropped"]) > 0
    assert (float(st["hot_frac"]) > 0) == hot
    np.testing.assert_allclose(float(st["aux"]), float(sj["aux"]), rtol=1e-5)
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32), rtol=0, atol=2e-2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("hot", [False, True], ids=["cold", "hot_ids"])
def test_moe_apply_grads_f32_match_jax(impl, hot):
    """The whole layer in f32, forward and ``jax.grad``: y and every
    gradient (router included, through ``moe_router``'s backward) at rel
    L2 1e-5; the routing is the same, so the counts are exact."""
    jcfg, cfg = _cfg_pair(moe_impl=impl)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jax_init_params(jax_moe.moe_specs(jcfg, ()), jax.random.PRNGKey(1)))
    x = np.random.default_rng(0).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    hid = np.array([1, 3, -1, 5], np.int32) if hot else None
    w = np.cos(np.arange(x.size)).reshape(x.shape).astype(np.float32)

    def f(p, xx):
        y, stats = jax_moe.moe_apply(p, xx, jcfg, None, None if hid is None else jnp.asarray(hid))
        return jnp.sum(y * w) + stats["aux"], stats

    (_, sj), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tp = _req(params_from_numpy(jax.tree.map(_np, jp), "cpu"))
    tx = _t(x).requires_grad_(True)
    y, st = moe.moe_apply(tp, tx, cfg, None, None if hid is None else _t(hid))
    ((y * _t(w)).sum() + st["aux"]).backward()
    np.testing.assert_array_equal(st["counts"].numpy(), _np(sj["counts"]))
    assert _rel(tx.grad, gx) < 1e-5
    for key in ("router", "w_gate", "w_up", "w_down"):
        assert _rel(tp[key].grad, gp[key]) < 1e-5, key
    for key in ("w_gate", "w_up", "w_down"):
        assert _rel(tp["shared"][key].grad, gp["shared"][key]) < 1e-5, key


# ------------------------------------------------------------ moe_router grad

ROUTER_GRAD_CASES = [("random", 64, 8, 2), ("random", 40, 16, 6), ("ties", 16, 8, 3),
                     ("k_equals_e", 24, 4, 4)]


@pytest.mark.parametrize("kind,t,e,k", ROUTER_GRAD_CASES)
def test_router_gradient_matches_jax_grad(kind, t, e, k):
    """The gates' ``autograd.Function`` on the CPU (the code the card runs,
    with ``router_ref`` for the forward) against ``jax.grad`` of the
    reference's ``_top_k_gates``: ties (equal logits: the lower id first,
    the same gradient routing) and ``k == E`` (the gates are the softmax)."""
    rng = np.random.default_rng(t * e + k)
    x = rng.standard_normal((t, e)).astype(np.float32)
    if kind == "ties":
        x[::2, 1:4] = 0.5
        x[1::2] = 0.0
    dg = rng.standard_normal((t, k)).astype(np.float32)

    def f(lg):
        gates, _ = jax_moe._top_k_gates(lg[None], k)
        return jnp.sum(gates[0] * dg)

    want = jax.jit(jax.grad(f))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    gates, ids, counts = moe_router(xt, k=k, group=t)
    assert not ids.requires_grad and not counts.requires_grad
    (gates * _t(dg)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), _np(want), rtol=1e-5, atol=1e-6)
    _, jids = jax_moe._top_k_gates(jnp.asarray(x)[None], k)
    np.testing.assert_array_equal(ids.numpy(), _np(jids[0]))


# ------------------------------------------------------------ attention

ATTN_CASES = [  # b, s, t, h, kh, d, causal, window, chunk
    (2, 64, 64, 4, 2, 16, True, 0, 16),  # causal, GQA
    (1, 48, 48, 4, 4, 8, True, 20, 16),  # window
    (1, 50, 50, 6, 2, 8, True, 0, 16),  # q and kv lengths that need padding
    (2, 24, 37, 4, 1, 8, False, 0, 16),  # cross-shaped, kv padding
]


@pytest.mark.parametrize("b,s,t,h,kh,d,causal,window,chunk", ATTN_CASES)
def test_blockwise_attention_matches_jax_forward_and_grad(b, s, t, h, kh, d, causal, window, chunk):
    rng = np.random.default_rng(s + t + h)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((b, s, h, d), (b, t, kh, d), (b, t, kh, d)))
    w = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, chunk=chunk)

    def f(qq, kk, vv):
        o = jax_attention.blockwise_attention(qq, kk, vv, **kw)
        return jnp.sum(o * w), o

    (_, oj), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
    o = blockwise_attention(qt, kt, vt, **kw)
    (o * _t(w)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), _np(oj), rtol=1e-5, atol=1e-5)
    for name, got, want in zip("qkv", (qt.grad, kt.grad, vt.grad), grads):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5, err_msg=name)


# ------------------------------------------------------------ xent

def test_softmax_xent_matches_jax_loss_and_grad():
    """A padded vocabulary (rows past ``vocab_size`` masked) and masked
    targets, 3 chunks; loss and both gradients."""
    rng = np.random.default_rng(11)
    b, s, d, v, vocab = 2, 12, 16, 40, 33
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    table = rng.standard_normal((v, d)).astype(np.float32) * 0.5
    targets = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = rng.random((b, s)) < 0.8

    def f(xx, tt):
        return jax_softmax_xent(xx, tt, jnp.asarray(np.where(mask, targets, 0)), None,
                                mask=jnp.asarray(mask), num_chunks=3, vocab_size=vocab)

    lj, (gx, gt) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(table))
    xt, tt = _t(x).requires_grad_(True), _t(table).requires_grad_(True)
    loss = softmax_xent(xt, tt, _t(np.where(mask, targets, 0)), None, mask=_t(mask), num_chunks=3,
                        vocab_size=vocab)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(lj), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), _np(gx), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tt.grad.numpy(), _np(gt), rtol=1e-5, atol=1e-7)
    assert float(tt.grad[vocab:].abs().max()) == 0.0  # padded rows take no gradient


# ------------------------------------------------------------ optimizer

def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": {"bias": rng.standard_normal(5).astype(np.float32),
                    "emb": rng.standard_normal((4, 3)).astype(np.float32)}}
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 3, params)
    return params, grads


@pytest.mark.parametrize("steps", [1, 4])
def test_apply_updates_matches_jax(steps):
    cfg = dict(lr=0.05, warmup_steps=2, total_steps=10, weight_decay=0.1, clip_norm=1.0)
    params, grads = _opt_tree(steps)
    jp, jst = jax.tree.map(jnp.asarray, params), jax_optim.init_opt(jax.tree.map(jnp.asarray, params))
    tp = params_from_numpy(params, "cpu")
    tst = optim.init_opt(tp)
    for _ in range(steps):
        jp, jst, jm = jax_optim.apply_updates(jax_optim.OptConfig(**cfg), jp, jax.tree.map(jnp.asarray, grads),
                                              jst)
        tp, tst, tm = optim.apply_updates(optim.OptConfig(**cfg), tp, params_from_numpy(grads, "cpu"), tst)
    assert int(tst.step) == int(jst.step) == steps
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    for a, b in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v)):
        for x, y in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), a)), jax.tree.leaves(b)):
            np.testing.assert_allclose(x, _np(y), rtol=1e-6, atol=1e-7)


def test_lr_schedule_and_global_norm_match_jax():
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = float(jax_optim.lr_at(jax_optim.OptConfig(**cfg), jnp.asarray(step)))
        got = float(optim.lr_at(optim.OptConfig(**cfg), torch.tensor(step)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    params, _ = _opt_tree(0)
    np.testing.assert_allclose(float(optim.global_norm(params_from_numpy(params, "cpu"))),
                               float(jax_optim.global_norm(params)), rtol=1e-6)
    # bf16 leaves are summed in f32.
    bf = {"a": jnp.ones((3, 3), jnp.bfloat16) * 1.5, "b": jnp.arange(4.0)}
    np.testing.assert_allclose(float(optim.global_norm(params_from_numpy(jax.tree.map(_np, bf), "cpu"))),
                               float(jax_optim.global_norm(bf)), rtol=1e-6)


def test_opt_state_carries_across():
    params, _ = _opt_tree(2)
    jst = jax_optim.init_opt(jax.tree.map(jnp.asarray, params))
    st = opt_state_from_numpy(*jax.tree.map(_np, tuple(jst)), device="cpu")
    assert st.step.dtype == torch.int32 and st.m["w"].dtype == torch.float32


# ------------------------------------------------------------ data

@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("vocab", [97, 102_400])
def test_pipeline_tokens_match_jax(seed, vocab):
    """Three steps of tokens and targets, exact (the same threefry draws,
    and ``jnp.cumsum``'s blocked f32 order for the Zipf table)."""
    jcfg = jax_pipeline.DataConfig(vocab_size=vocab, seq_len=16, global_batch=4, seed=seed)
    jp = jax_pipeline.Pipeline(jcfg)
    tp = pipeline.Pipeline(pipeline.DataConfig(**jcfg._asdict()), "cpu")
    js, ts = jp.init_state(), tp.init_state()
    for _ in range(3):
        jb, js = jp.next(js)
        tb, ts = tp.next(ts)
        for key in ("tokens", "targets"):
            np.testing.assert_array_equal(tb[key].numpy(), _np(jb[key]), err_msg=key)
            assert tb[key].dtype == torch.int32
    assert ts.step == int(js.step) == 3
    b3, _ = tp.next(tp.seek(2))
    np.testing.assert_array_equal(b3["tokens"].numpy(), tb["tokens"].numpy())


def test_xla_cumsum_is_jnp_cumsum():
    for n in (5, 16, 17, 300, 4097):
        p = np.random.default_rng(n).random(n).astype(np.float32)
        np.testing.assert_array_equal(prng.xla_cumsum(p), _np(jnp.cumsum(jnp.asarray(p))))


def test_memmap_source_matches_jax(tmp_path):
    path = str(tmp_path / "tokens.bin")
    pipeline.write_token_file(path, np.arange(10_000) % 31)
    raw = np.fromfile(path, dtype=np.int32)
    path_j = str(tmp_path / "tokens_j.bin")
    jax_pipeline.write_token_file(path_j, np.arange(10_000) % 31)
    assert raw.tobytes() == np.fromfile(path_j, dtype=np.int32).tobytes()
    kw = dict(vocab_size=31, seq_len=8, global_batch=2, source="memmap", path=path)
    tp = pipeline.Pipeline(pipeline.DataConfig(**kw), "cpu")
    jp = jax_pipeline.Pipeline(jax_pipeline.DataConfig(**kw))
    ts, js = tp.init_state(), jp.init_state()
    for _ in range(3):
        tb, ts = tp.next(ts)
        jb, js = jp.next(js)
        np.testing.assert_array_equal(tb["tokens"].numpy(), _np(jb["tokens"]))
        np.testing.assert_array_equal(tb["targets"].numpy(), _np(jb["targets"]))


# ------------------------------------------------------------ compression

@pytest.mark.parametrize("shape", [(33, 17), (1000,), (4, 5, 6)])
def test_quantize_int8_matches_jax(shape):
    g = (np.random.default_rng(len(shape)).standard_normal(shape) * 0.01).astype(np.float32)
    for key in (None, 5, 12):
        jq = jax_compress.quantize_int8(jnp.asarray(g), None if key is None else jax.random.PRNGKey(key))
        tq = compress.quantize_int8(_t(g), None if key is None else prng.prng_key(key))
        np.testing.assert_array_equal(tq.q.numpy(), _np(jq.q))
        assert float(tq.scale) == float(jq.scale) and tq.nbytes == jq.nbytes
        np.testing.assert_array_equal(compress.dequantize_int8(tq).numpy(),
                                      _np(jax_compress.dequantize_int8(jq)))


def test_topk_and_error_feedback_match_jax():
    g = np.random.default_rng(5).standard_normal((64, 32)).astype(np.float32)
    g[0, :4] = 3.0  # ties among the largest: the lower index first
    jsparse, jres = jax_compress.topk_encode(jnp.asarray(g), 100)
    tsparse, tres = compress.topk_encode(_t(g), 100)
    np.testing.assert_array_equal(tsparse.idx.numpy(), _np(jsparse.idx))
    np.testing.assert_array_equal(tsparse.val.numpy(), _np(jsparse.val))
    np.testing.assert_array_equal(tres.numpy(), _np(jres))
    assert tsparse.nbytes == jsparse.nbytes and tsparse.shape == tuple(jsparse.shape)
    np.testing.assert_array_equal(compress.topk_decode(tsparse).numpy(), _np(jax_compress.topk_decode(jsparse)))
    grads = {"w": g, "b": {"c": g[:3, :5].copy()}}
    jef = jax_compress.ErrorFeedback.init(jax.tree.map(jnp.asarray, grads))
    tef = compress.ErrorFeedback.init(params_from_numpy(grads, "cpu"))
    carried = np.zeros_like(g)
    for _ in range(2):
        js, jef = jef.compress_step(jax.tree.map(jnp.asarray, grads), k=50)
        ts, tef = tef.compress_step(params_from_numpy(grads, "cpu"), k=50)
        np.testing.assert_array_equal(ts["w"].idx.numpy(), _np(js["w"].idx))
        np.testing.assert_array_equal(ts["b"]["c"].val.numpy(), _np(js["b"]["c"].val))
        np.testing.assert_array_equal(tef.residual["w"].numpy(), _np(jef.residual["w"]))
        # The decomposition: what is sent plus what is kept is the grad
        # plus what was kept before.
        np.testing.assert_allclose((compress.topk_decode(ts["w"]) + tef.residual["w"]).numpy(),
                                   g + carried, atol=1e-6)
        carried = tef.residual["w"].numpy()


# ------------------------------------------------------------ checkpoints

def _ckpt_trees():
    """A reference tree and the same tree in the port: bf16, f32 and int32
    leaves, nested dicts and an ``OptState`` (NamedTuple field names)."""
    rng = np.random.default_rng(9)
    jparams = {"embed": jnp.asarray(rng.standard_normal((5, 3)), jnp.bfloat16),
               "blocks": {"w": jnp.asarray(rng.standard_normal((2, 3, 4)), jnp.float32),
                          "ids": jnp.arange(7, dtype=jnp.int32)}}
    jopt = jax_optim.init_opt(jparams)._replace(step=jnp.asarray(4, jnp.int32))
    jtree = {"params": jparams, "opt": jopt}
    ttree = {"params": params_from_numpy(jax.tree.map(_np, jparams), "cpu"),
             "opt": opt_state_from_numpy(*jax.tree.map(_np, tuple(jopt)), device="cpu")}
    return jtree, ttree


def _dir_bytes(d):
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


def test_checkpoint_written_by_the_port_equals_jaxs_byte_for_byte(tmp_path):
    jtree, ttree = _ckpt_trees()
    dj = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 4, jtree, metadata={"data_step": 4})
    dt = ckpt.save_checkpoint(str(tmp_path / "port"), 4, ttree, metadata={"data_step": 4})
    assert os.path.basename(dt) == "step_00000004"
    assert _dir_bytes(dt) == _dir_bytes(dj)
    assert [n for n, _ in ckpt._leaf_paths(ttree)] == [n for n, _ in jax_ckpt._leaf_paths(jtree)]
    assert "opt__.m__embed" in json.load(open(os.path.join(dt, "manifest.json")))["leaves"]
    assert ckpt.latest_step(str(tmp_path / "port")) == 4


def test_checkpoints_restore_both_ways(tmp_path):
    jtree, ttree = _ckpt_trees()
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 3, jtree, metadata={"data_step": 9})
    ckpt.save_checkpoint(str(tmp_path / "port"), 3, ttree, metadata={"data_step": 9})
    # JAX saves, the port restores.
    got, manifest = ckpt.restore_checkpoint(str(tmp_path / "jax"), template=ttree)
    assert manifest["metadata"]["data_step"] == 9
    for (pa, a), (pb, b) in zip(ckpt._leaf_paths(got), jax_ckpt._leaf_paths(jtree)):
        assert pa == pb and a.dtype == ttree_dtype(ttree, pa)
        np.testing.assert_array_equal(a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy(),
                                      _np(b).view(np.int16) if _np(b).dtype.name == "bfloat16" else _np(b))
    # The port saves, JAX restores (ml_dtypes on its side only).
    back, _ = jax_ckpt.restore_checkpoint(str(tmp_path / "port"), template=jtree)
    for (pa, a), (pb, b) in zip(jax_ckpt._leaf_paths(back), jax_ckpt._leaf_paths(jtree)):
        assert pa == pb and a.dtype == _np(b).dtype and a.shape == _np(b).shape
        assert a.tobytes() == _np(b).tobytes(), pa
    flat, _ = ckpt.restore_checkpoint(str(tmp_path / "port"))
    assert sorted(flat) == sorted(n for n, _ in ckpt._leaf_paths(ttree))


def ttree_dtype(tree, name):
    return dict(ckpt._leaf_paths(tree))[name].dtype


def test_checkpoint_atomicity_gc_and_shard_filter(tmp_path):
    root = str(tmp_path / "c")
    tree = {"a": torch.ones((4, 4), dtype=torch.bfloat16), "b": {"c": torch.arange(3)}}
    for step in (1, 2, 3, 4):
        ckpt.save_checkpoint(root, step, tree, metadata={"x": step})
    os.makedirs(os.path.join(root, "step_00000005.tmp-123"))  # a save cut short
    ckpt.gc_checkpoints(root, keep=2)
    steps = sorted(n for n in os.listdir(root) if n.startswith("step_") and "tmp" not in n)
    assert steps == ["step_00000003", "step_00000004"]
    assert ckpt.latest_step(root) == 4
    restored, manifest = ckpt.restore_checkpoint(root, template=tree)
    assert torch.equal(restored["b"]["c"], torch.arange(3)) and restored["a"].dtype == torch.bfloat16
    assert manifest["metadata"]["x"] == 4
    assert not any(n.startswith(".LATEST.tmp") for n in os.listdir(root))
    ckpt.save_checkpoint(root, 4, tree, metadata={"x": 44})  # an idempotent re-save
    assert ckpt.restore_checkpoint(root)[1]["metadata"]["x"] == 44
    ckpt.save_checkpoint(str(tmp_path / "s"), 1, {"a": torch.ones(2), "b": torch.zeros(2)},
                         shard_filter=lambda name: name == "a")
    d = os.path.join(str(tmp_path / "s"), "step_00000001")
    assert os.path.exists(os.path.join(d, "a.npy")) and not os.path.exists(os.path.join(d, "b.npy"))
    assert set(json.load(open(os.path.join(d, "manifest.json")))["leaves"]) == {"a", "b"}
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"))


def test_save_async_snapshots_before_the_params_change(tmp_path):
    p = {"w": torch.ones(3)}
    pending = ckpt.save_async(str(tmp_path), 1, p)
    p["w"].add_(5.0)  # the next step updates the params in place
    pending.wait()
    got, _ = ckpt.restore_checkpoint(str(tmp_path), template=p)
    assert torch.equal(got["w"], torch.ones(3))
