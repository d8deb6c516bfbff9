"""The port's int8 serving path (``repro_torch.quant``) against the JAX
reference's ``repro/quant.py`` on the CPU, and int8 ``decode_step``.

Bars, each with its reason:

* ``quantize_leaf``, ``dequant_leaf`` and ``quantize_tree`` — bit for bit:
  the same f32 operations (the row max over 127, the 1e-12 clamp, a
  division, round half to even, the clip), each rounded once;
* which leaves a tree quantizes — exactly the reference's (the rule of two
  dims, 65,536 elements and a float dtype, stacked norm scales included);
* int8 ``decode_step`` logits — 2e-2 (atol and rtol), the bf16 bar of
  ``tests/test_torch_serving.py``: the dequantized weights are the same
  bits on both sides, and the bf16 products round in another order
  (XLA's CPU dots against PyTorch's; the reference runs jitted).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import quant as jq  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import ModelConfig, get_config  # noqa: E402
from repro_torch.interop import kv_cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models.model import Model, build  # noqa: E402
from repro_torch.models.params import ParamSpec  # noqa: E402

TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """PyTorch's CPU ``exp`` can be off by ~1e-4 on its first call in a
    process (torch 2.13, about one process in eight); one call first."""
    torch.exp(torch.zeros(1))


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    ja = jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32)))
    return ja, ta.to(torch.bfloat16) if dtype == "bf16" else ta


def _bits(x) -> np.ndarray:
    a = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
    return a.view(np.uint32)


def _weights(shape, seed):
    """Rows of mixed scales, an all-zero row, and a row of half-way ties:
    its max is 127, so its scale is exactly 1 and ``w / s`` is ``k + 0.5``."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * rng.random(shape[:-1] + (1,)).astype(np.float32)
    w[..., 0, :] = 0.0
    n = shape[-1]
    w[..., 1, :] = (np.arange(n) % 254 - 127 + 0.5).astype(np.float32)
    w[..., 1, -1] = 127.0
    return w


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("shape", [(64, 300), (3, 40, 256), (2, 2, 16, 130)])
def test_quantize_and_dequant_leaf_bits_match_jax(dtype, shape):
    jw, tw = _pair(_weights(shape, len(shape)), dtype)
    got, want = quant.quantize_leaf(tw), jq.quantize_leaf(jw)
    assert quant.is_quantized(got) and got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(_bits(got["s"]), _bits(want["s"]))
    assert not got["q"][..., 0, :].any() and (got["s"][..., 0, :] == 1e-12).all()
    ties = got["q"][..., 1, :-1].numpy().astype(np.int64)
    assert (ties % 2 == 0).all()  # half way rounds to even
    back = quant.dequant_leaf(got)
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(back), _bits(jq.dequant_leaf(want)))
    np.testing.assert_array_equal(_bits(quant.dequant_leaf(got, torch.float32)),
                                  _bits(jq.dequant_leaf(want, jnp.float32)))


def _quantized_paths(tree, is_q) -> set:
    paths = set()

    def walk(node, path):
        if is_q(node):
            paths.add(path)
        elif isinstance(node, dict):
            for key, val in node.items():
                walk(val, path + (key,))
        elif isinstance(node, (list, tuple)):
            for i, val in enumerate(node):
                walk(val, path + (i,))

    walk(tree, ())
    return paths


def test_quantize_tree_rule_and_bits_match_jax():
    """The rule on both sides of 65,536 elements: a stacked f32 norm scale
    of ``[32, 2048]`` is quantized, ``[31, 2048]`` and a 1-D leaf of 70,000
    are not, nor an int leaf; the quantized tree's bits equal the
    reference's."""
    rng = np.random.default_rng(5)
    arrays = {
        "norm_at": (rng.random((32, 2048)) + 0.5).astype(np.float32),
        "norm_below": (rng.random((31, 2048)) + 0.5).astype(np.float32),
        "vector": rng.standard_normal(70_000).astype(np.float32),
        "blocks": [{"w": rng.standard_normal((2, 256, 256)).astype(np.float32)},
                   {"w": rng.standard_normal((300, 256)).astype(np.float32)}],
        "ids": rng.integers(0, 9, (300, 256)).astype(np.int32),
    }
    jtree = jax.tree.map(jnp.asarray, arrays)
    ttree = params_from_numpy(arrays, device="cpu")
    got, want = quant.quantize_tree(ttree), jq.quantize_tree(jtree)
    paths = _quantized_paths(got, quant.is_quantized)
    assert paths == _quantized_paths(want, jq.is_quantized)
    assert paths == {("norm_at",), ("blocks", 0, "w"), ("blocks", 1, "w")}
    for (gp, g), (_, w) in zip(tree_lib.leaves_with_paths(got),
                               tree_lib.leaves_with_paths(jax.tree.map(np.asarray, want)), strict=True):
        if g.dtype == torch.int8 or g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(gp))
        else:
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(gp))
    back, jback = quant.dequant_tree(got), jq.dequant_tree(want)
    np.testing.assert_array_equal(_bits(back["norm_at"]), _bits(jback["norm_at"]))
    assert back["norm_at"].dtype == torch.bfloat16  # the reference serves it in bf16
    assert back["norm_below"] is ttree["norm_below"]


@pytest.mark.parametrize("arch", ["llava-next-34b", "mistral-large-123b", "qwen3-1.7b"])
def test_abstract_quantize_tree_of_full_configs_matches_jax(arch):
    """On the full configs' params as shapes only (no memory): the same
    leaves quantized with the same shapes and dtypes. llava-next-34b's and
    mistral-large-123b's stacked norm scales reach 65,536 elements and are
    quantized, as in the reference; qwen3-1.7b's do not."""
    def meta(spec):
        if isinstance(spec, ParamSpec):
            return torch.empty(spec.shape, dtype=spec.dtype, device="meta")
        return {key: meta(val) for key, val in spec.items()}

    meta = meta(Model(get_config(arch), "cpu").param_specs())
    got = quant.abstract_quantize_tree(meta)
    want = jq.abstract_quantize_tree(jax_build(jax_get_config(arch)).abstract_params())
    paths = _quantized_paths(got, quant.is_quantized)
    assert paths == _quantized_paths(want, jq.is_quantized)
    assert (("blocks", "attn", "ln", "scale") in paths) == (arch != "qwen3-1.7b")
    for path in paths:
        g, w = got, want
        for key in path:
            g, w = g[key], w[key]
        assert g["q"].device.type == "meta"
        assert tuple(g["q"].shape) == w["q"].shape and g["q"].dtype == torch.int8
        assert tuple(g["s"].shape) == w["s"].shape and g["s"].dtype == torch.float32


def _models(arch):
    # d_model 256: the attention projections reach 65,536 elements and are
    # quantized too (at the reduced 128 only the MLP's are).
    jcfg = jax_reduced(jax_get_config(arch), d_model=256)
    if jcfg.num_experts:  # no capacity drops: the decode batch's routing is then the same
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=16.0, moe_cold_capacity=1.0,
                                   moe_hot_capacity=16.0)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build(ModelConfig(**dataclasses.asdict(jcfg)), "cpu")
    return jm, jp, m, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(cfg, toks, lib):
    if lib == "jax":
        b = {"tokens": jnp.asarray(toks)}
        if cfg.family == "vlm":
            b["patches"] = jnp.zeros((toks.shape[0], cfg.num_patches, cfg.d_model), jnp.bfloat16)
        return b
    b = {"tokens": torch.from_numpy(toks)}
    if cfg.family == "vlm":
        b["patches"] = torch.zeros((toks.shape[0], cfg.num_patches, cfg.d_model), dtype=torch.bfloat16)
    return b


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b", "llava-next-34b"])
def test_int8_decode_step_matches_jax(arch):
    """From the reference's bf16 prefill state, three decode steps with the
    int8 tree on both sides: the port's ``quantize_tree`` equals the
    reference's bit for bit, and the logits agree at the bf16 bar. The int8
    step's greedy token equals the bf16 step's (the reference's own check,
    ``tests/test_beyond_paper.py``), and its logits stay within 0.2 of the
    largest."""
    jm, jp, m, p = _models(arch)
    toks = np.random.default_rng(1).integers(0, m.cfg.vocab_size, (2, 10)).astype(np.int32)
    # The reference jitted: one compile a shape (eager JAX compiles each op).
    jl, jstate = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=40))(jp, _batch(jm.cfg, toks, "jax"))
    jdecode = jax.jit(lambda p, s, t: jm.decode_step(p, s, t))
    jq_params = jq.quantize_tree(jp)
    qp = quant.quantize_tree(p)
    for (gp, g), (_, w) in zip(tree_lib.leaves_with_paths(qp),
                               tree_lib.leaves_with_paths(jax.tree.map(np.asarray, jq_params)), strict=True):
        assert g.dtype != torch.int8 or np.array_equal(g.numpy(), w), gp
    assert quant.is_quantized(qp["embed"]) and quant.is_quantized(qp["blocks"]["attn"]["wq"])
    assert quant.has_quantized(qp["blocks"]["mlp"])
    state = kv_cache_from_numpy(*(np.asarray(a) for a in jstate), device="cpu")
    bf16_state = kv_cache_from_numpy(*(np.asarray(a) for a in jstate), device="cpu")
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    lb, _ = m.decode_step(p, bf16_state, torch.from_numpy(np.array(tok)))
    for i in range(3):
        jl, jstate = jdecode(jq_params, jstate, tok)
        logits, state = m.decode_step(qp, state, torch.from_numpy(np.array(tok)))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        if i == 0:
            assert torch.equal(logits.argmax(-1), lb.argmax(-1))
            assert float((logits - lb).abs().max() / lb.abs().max()) < 0.2
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
    np.testing.assert_array_equal(state.length.numpy(), np.asarray(jstate.length))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b", "whisper-base"])
def test_int8_params_raise_where_the_reference_fails(arch):
    """Prefill and loss raise on int8 params for every family; the decode
    step of the ssm, hybrid and audio families too (the reference
    dequantizes only the decoder stack of dense, moe and vlm)."""
    model = Model(dataclasses.replace(get_config(arch), num_layers=1, encoder_layers=1, d_model=256,
                                      num_heads=4, num_kv_heads=1, head_dim=64, lru_width=256,
                                      d_ff=512, vocab_size=512, num_frames=4), "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    qp = quant.quantize_tree(params)
    assert quant.has_quantized(qp["blocks"])
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    batch = {"tokens": tokens, "targets": tokens,
             "frames": torch.zeros((1, 4, 256), dtype=torch.bfloat16)}
    with pytest.raises(NotImplementedError, match="quantized params"):
        model.prefill(qp, batch)
    _, state = model.prefill(params, batch, cache_len=8)
    with pytest.raises(NotImplementedError, match="dense, moe and vlm families only"):
        model.decode_step(qp, state, tokens[:, 0])
    dense = Model(dataclasses.replace(get_config("qwen3-1.7b"), num_layers=1, d_model=256, num_heads=4,
                                      num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512), "cpu")
    dparams = quant.quantize_tree(dense.init(torch.Generator().manual_seed(0)))
    with pytest.raises(NotImplementedError, match="quantized params are not taken by Model.loss"):
        dense.loss(dparams, batch)
    with pytest.raises(NotImplementedError, match="quantized params are not taken by Model.prefill"):
        dense.prefill(dparams, batch)
