"""The port's ``Model`` for the four families of this slice — ``ssm``
(rwkv6-1.6b), ``hybrid`` (recurrentgemma-2b), ``audio`` (whisper-base) and
``vlm`` (llava-next-34b) — against the JAX reference's on the CPU: prefill
and decode steps of the reduced configs from params carried across with
``params_from_numpy``, the port of ``tests/test_arch_smoke.py``'s
``test_decode_matches_prefill``, and ``num_params`` of every full config.

Bars, each with its reason:

* logits — atol 0.05 (measured at most 0.021, on logits of about 0.8):
  the models run in bf16 as served, and XLA's CPU dots and PyTorch's
  round their bf16 results after summing in another order, so the
  activations differ by bf16 ulps from layer 1 on, and the recurrences
  (RWKV's state, the RG-LRU's) carry such differences from token to token
  (the blocks themselves are held in f32 at 2e-5 to 1e-4 in
  ``tests/test_torch_rwkv6.py``, ``test_torch_rglru.py`` and
  ``test_torch_encdec.py``); the serving bar on the card is 0.125;
* decode state — each tensor's relative L2 difference at most 0.05
  (measured at most 0.02: the RG-LRU's f32 state after 32 bf16 tokens),
  its shape and dtype the reference's, lengths exact;
* greedy tokens — equal wherever the reference's top-2 margin is wider
  than twice the largest logit difference (which forces the same argmax);
* decode against re-prefill (the port alone) and ``num_params`` — exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import ARCH_IDS, ModelConfig, get_config, reduced  # noqa: E402
from repro_torch.interop import (encdec_state_from_numpy, params_from_numpy,  # noqa: E402
                                 rglru_state_from_numpy, rwkv_state_from_numpy, kv_cache_from_numpy)
from repro_torch.models.model import Model, build  # noqa: E402

LOGIT_ATOL = 0.05
STATE_REL_L2 = 0.05
ARCHS = ["rwkv6-1.6b", "recurrentgemma-2b", "whisper-base", "llava-next-34b"]
# The reference's parameter counts of the full configs.
FULL_PARAMS = {"rwkv6-1.6b": 1_599_868_928, "recurrentgemma-2b": 3_337_597_440,
               "whisper-base": 97_581_056, "llava-next-34b": 34_388_917_248}


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """PyTorch's CPU ``exp`` can be off by ~1e-4 on its first call in a
    process (torch 2.13, about one process in eight); one call first."""
    torch.exp(torch.zeros(1))


def _models(arch: str):
    jcfg = jax_reduced(jax_get_config(arch))
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build(ModelConfig(**dataclasses.asdict(jcfg)), "cpu")
    return jm, jp, m, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(cfg, toks: np.ndarray, lib: str) -> dict:
    b = toks.shape[0]
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = (b, cfg.num_patches, cfg.d_model)
    if cfg.family == "audio":
        extra["frames"] = (b, cfg.num_frames, cfg.d_model)
    rng = np.random.default_rng(11)
    if lib == "jax":
        out = {"tokens": jnp.asarray(toks)}
        out.update({k: jnp.asarray(rng.standard_normal(s), jnp.bfloat16) for k, s in extra.items()})
        return out
    out = {"tokens": torch.from_numpy(toks)}
    for k, s in extra.items():  # the same bf16 values as the reference's
        out[k] = torch.from_numpy(np.asarray(jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
                                             .astype(jnp.float32))).to(torch.bfloat16)
    return out


def _state_from_jax(family, jstate):
    arrays = jax.tree.map(np.asarray, jstate)
    if family == "ssm":
        return rwkv_state_from_numpy(*arrays, device="cpu")
    if family == "hybrid":
        return rglru_state_from_numpy(*arrays, device="cpu")
    if family == "audio":
        return encdec_state_from_numpy(*arrays, device="cpu")
    return kv_cache_from_numpy(*arrays, device="cpu")


def _assert_logits(logits, jl):
    jl = np.asarray(jl, np.float32)
    got = logits.float().numpy()
    np.testing.assert_allclose(got, jl, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(jl, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * np.abs(got - jl).max()
    np.testing.assert_array_equal(got.argmax(-1)[clear], jl.argmax(-1)[clear])


def _assert_state(state, jstate):
    got, want = tree_lib.leaves(state), jax.tree.leaves(jstate)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            a, b = g.float().numpy().astype(np.float64), w.astype(np.float64)
            assert np.linalg.norm(a - b) <= STATE_REL_L2 * np.linalg.norm(b)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    """Prefill of a 2 x 32 batch (a whole RWKV chunk; past no window), then
    four decode steps from the reference's own state, fed the reference's
    tokens; the state after the last step against the reference's."""
    jm, jp, m, p = _models(arch)
    cfg = m.cfg
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    cache_len = 32 + (cfg.num_patches if cfg.family == "vlm" else 0) + 8
    jprefill = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=cache_len))
    jdecode = jax.jit(lambda p, s, t: jm.decode_step(p, s, t))
    jl, jstate = jprefill(jp, _batch(cfg, toks, "jax"))
    logits, state = m.prefill(p, _batch(cfg, toks, "torch"), cache_len=cache_len)
    assert logits.dtype == torch.float32 and logits.shape == (2, cfg.vocab_size)
    _assert_logits(logits, jl)
    _assert_state(state, jstate)
    state = _state_from_jax(cfg.family, jstate)
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    for _ in range(4):
        jl, jstate = jdecode(jp, jstate, tok)
        logits, state = m.decode_step(p, state, torch.from_numpy(np.array(tok)))
        _assert_logits(logits, jl)
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
    _assert_state(state, jstate)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """``tests/test_arch_smoke.py::test_decode_matches_prefill`` on the port:
    greedy continuation by ``decode_step`` equals greedy by re-prefill."""
    cfg = reduced(get_config(arch))
    model = build(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prompt = list(np.arange(9) % cfg.vocab_size)

    def full_batch(seq):
        b = {"tokens": torch.tensor(seq, dtype=torch.int32)[None]}
        if cfg.family == "audio":
            b["frames"] = torch.zeros((1, cfg.num_frames, cfg.d_model), dtype=torch.bfloat16)
        if cfg.family == "vlm":
            b["patches"] = torch.zeros((1, cfg.num_patches, cfg.d_model), dtype=torch.bfloat16)
        return b

    logits, state = model.prefill(params, full_batch(prompt), cache_len=24 + cfg.num_patches)
    toks = [int(logits.argmax(-1)[0])]
    for _ in range(3):
        logits, state = model.decode_step(params, state, torch.tensor([toks[-1]], dtype=torch.int32))
        toks.append(int(logits.argmax(-1)[0]))
    seq, ref = list(prompt), []
    for _ in range(4):
        logits, _ = model.prefill(params, full_batch(seq))
        t = int(logits.argmax(-1)[0])
        ref.append(t)
        seq.append(t)
    assert toks == ref, (arch, toks, ref)


def test_registry_and_num_params_match_jax():
    """The reference's ten ids in its order; every full config the
    reference's field for field, and its parameter count the reference's
    (counted from the specs: nothing is allocated)."""
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert cfg == ModelConfig(**dataclasses.asdict(jcfg)), arch
        n = Model(cfg, "cpu").num_params()
        assert n == jax_build(jcfg).num_params(), arch
        if arch in FULL_PARAMS:
            assert n == FULL_PARAMS[arch], arch
