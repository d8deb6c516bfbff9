"""The port's RWKV-6 blocks (``repro_torch.models.rwkv6``) against the JAX
reference's on the CPU: the wkv6 chunk, TimeMix, ChannelMix, the layer
stack over a full sequence (below a chunk, one chunk, three chunks) and
the decode step, on f32 params and activations drawn with numpy from a
seed (every leaf random, the adapters the init leaves at zero included).

Bars, each with its reason:

* f32 — rtol 2e-5 and atol 2e-5 of the output's scale: the same f32
  expressions, with sums in another order. XLA's CPU ``cumsum`` over a
  32-token chunk is a blocked sum (blocks of 16) where PyTorch's is a
  running one, so ``cum`` differs by an ulp of its size; ``exp(-cum)``
  carries that ulp into ``k_i`` and the state, relatively: the same
  1e-6-level noise as a reordered dot. ``prng.xla_cumsum`` (the blocked
  order) would not give bits either, as the exps and dots differ too,
  so the chunk is held at this bar;
* the ``s % 32`` rule raises as the reference's assertion does.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import rwkv6 as jr  # noqa: E402
from repro.models.params import abstract_params  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.interop import params_from_numpy, rwkv_state_from_numpy  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402

RTOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """PyTorch's CPU ``exp`` can be off by ~1e-4 on its first call in a
    process (torch 2.13, about one process in eight); one call first."""
    torch.exp(torch.zeros(1))


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(jax_get_config("rwkv6-1.6b"))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(0)

    def draw(path, sds):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(sds.shape)).astype(np.float32)
        # The decay's exponent near [-1.5, 0.5], so that exp(-cum) over a
        # chunk stays finite in f32 (the reference does not rescale it).
        if "decay_base" in name:
            return (-0.5 + 0.3 * rng.standard_normal(sds.shape)).astype(np.float32)
        if "decay_b" in name:
            return (0.05 * rng.standard_normal(sds.shape)).astype(np.float32)
        if sds.ndim >= 3:  # [L, fan_in, ...]
            return (rng.standard_normal(sds.shape) / np.sqrt(sds.shape[-2])).astype(np.float32)
        return (0.3 * rng.standard_normal(sds.shape)).astype(np.float32)

    arrays = jax.tree_util.tree_map_with_path(draw, abstract_params(jr.rwkv_block_specs(jcfg)))
    jblocks = jax.tree.map(jnp.asarray, arrays)
    blocks = params_from_numpy(arrays, device="cpu")
    return jcfg, cfg, jblocks, blocks, rng


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, rtol=RTOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("c", [1, 9, 32])
def test_wkv_chunk_matches_jax(c):
    rng = np.random.default_rng(c)
    b, h, dh = 2, 3, 16
    r, k, v = (rng.standard_normal((b, c, h, dh)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.uniform(-3.0, 0.5, (b, c, h, dh))).astype(np.float32)
    u = rng.standard_normal((h, dh)).astype(np.float32)
    s0 = rng.standard_normal((b, h, dh, dh)).astype(np.float32)
    jo, js = jr._wkv_chunk(*(jnp.asarray(a) for a in (r, k, v, logw, u, s0)))
    o, s1 = rwkv6._wkv_chunk(*(_t(a) for a in (r, k, v, logw, u, s0)))
    _close(o, jo)
    _close(s1, js)


def test_time_mix_and_channel_mix_match_jax(setup):
    jcfg, cfg, jblocks, blocks, rng = setup
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    x_prev = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    h = cfg.d_model // cfg.rwkv_head_dim
    s0 = (0.1 * rng.standard_normal((2, h, cfg.rwkv_head_dim, cfg.rwkv_head_dim))).astype(np.float32)
    jp, p = _layer(jblocks, 0), rwkv6._unstack(blocks, cfg.num_layers)[0]
    want = jr.time_mix(jp["tm"], jnp.asarray(x), jcfg, jnp.asarray(x_prev), jnp.asarray(s0))
    got = rwkv6.time_mix(p["tm"], _t(x), cfg, _t(x_prev), _t(s0))
    for g, w in zip(got, want):
        _close(g, w)
    want = jr.channel_mix(jp["cm"], jnp.asarray(x), jnp.asarray(x_prev))
    got = rwkv6.channel_mix(p["cm"], _t(x), _t(x_prev))
    for g, w in zip(got, want):
        _close(g, w)


def _state(cfg, rng, b):
    h = cfg.d_model // cfg.rwkv_head_dim
    return (rng.standard_normal((cfg.num_layers, b, cfg.d_model)).astype(np.float32),
            rng.standard_normal((cfg.num_layers, b, cfg.d_model)).astype(np.float32),
            (0.1 * rng.standard_normal((cfg.num_layers, b, h, cfg.rwkv_head_dim, cfg.rwkv_head_dim)))
            .astype(np.float32))


@pytest.mark.parametrize("s", [9, 32, 96])
def test_rwkv_forward_matches_jax(setup, s):
    """Below a chunk (one ``_wkv_chunk`` of 9), one chunk, and three chunks
    (the chunk loop carrying the state), from a state carried in."""
    jcfg, cfg, jblocks, blocks, rng = setup
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    arrays = _state(cfg, rng, 2)
    jh, jst = jr.rwkv_forward(jblocks, jnp.asarray(x), jcfg, state=jr.RWKVState(*map(jnp.asarray, arrays)))
    st = rwkv6.RWKVState(*map(_t, arrays))
    h, new = rwkv6.rwkv_forward(blocks, _t(x), cfg, state=st)
    _close(h, jh)
    for name in ("x_tm", "x_cm", "wkv"):
        _close(getattr(new, name), getattr(jst, name))


def test_rwkv_decode_steps_match_jax(setup):
    """Three literal recurrence steps from the reference's own state after
    a 32-token prefill, carried across with ``rwkv_state_from_numpy``."""
    jcfg, cfg, jblocks, blocks, rng = setup
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    _, jst = jr.rwkv_forward(jblocks, jnp.asarray(x), jcfg)
    st = rwkv_state_from_numpy(*(np.asarray(a) for a in jst), device="cpu")
    assert st.x_tm.dtype == torch.float32 and st.wkv.dtype == torch.float32
    for _ in range(3):
        xt = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
        jy, jst = jr.rwkv_decode_step(jblocks, jnp.asarray(xt), jcfg, jst)
        y, st = rwkv6.rwkv_decode_step(blocks, _t(xt), cfg, st)
        _close(y, jy)
    for name in ("x_tm", "x_cm", "wkv"):
        _close(getattr(st, name), getattr(jst, name))


def test_sequence_not_a_multiple_of_the_chunk_raises(setup):
    jcfg, cfg, jblocks, blocks, _ = setup
    x = torch.zeros((1, 40, cfg.d_model))
    with pytest.raises(ValueError, match="multiple of 32"):
        rwkv6.rwkv_forward(blocks, x, cfg)
    with pytest.raises(AssertionError):
        jr.rwkv_forward(jblocks, jnp.zeros((1, 40, jcfg.d_model)), jcfg)
    state = rwkv6.init_rwkv_state(cfg, 3, device="cpu")
    assert state.x_tm.shape == (cfg.num_layers, 3, cfg.d_model) and state.wkv.dtype == torch.float32
    meta = rwkv6.init_rwkv_state(cfg, 3, abstract=True)
    assert meta.wkv.device.type == "meta"
