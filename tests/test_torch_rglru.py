"""The port's RecurrentGemma blocks (``repro_torch.models.rglru``) against
the JAX reference's on the CPU: the written-out associative scan, the
recurrent block, a prefill longer than the attention window (the ring
buffer's slots) and decode steps past the window's edge, on f32 params
and activations drawn with numpy from a seed.

Bars, each with its reason:

* the scan — bit for bit against ``jax.lax.associative_scan`` (the same
  products in the same order), with PyTorch flushing subnormal results to
  zero as XLA's CPU code does (a product of 97 decays in [0, 1) reaches
  the subnormal range);
* f32 blocks — rtol 2e-5 and atol 2e-5 of the output's scale: the same
  f32 expressions, with dot sums in another order (the reference jitted,
  so XLA may fuse products into FMAs);
* f32 stacks — rtol and atol 1e-4 of the output's scale: four layers on
  random params grow the residual stream to about 50 times its input's
  scale, and the attention's sums run in another order too (the
  reference's prefill attention is its blockwise pass, the port's the
  ``flash_attention`` kernel's plain version, and its decode attention
  over the ring the ``flash_decode`` kernel's; the reference runs jitted,
  so XLA may fuse products into FMAs): measured 2.1e-5 of the scale;
* the ring's slots, the lengths and the layer pattern — exact.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import rglru as jr  # noqa: E402
from repro.models.params import abstract_params  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.interop import params_from_numpy, rglru_state_from_numpy  # noqa: E402
from repro_torch.models import rglru  # noqa: E402

RTOL = 2e-5
STACK_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """PyTorch's CPU ``exp`` can be off by ~1e-4 on its first call in a
    process (torch 2.13, about one process in eight); one call first."""
    torch.exp(torch.zeros(1))


@contextlib.contextmanager
def _flush_subnormals():
    """PyTorch's CPU ops flushing subnormal results to zero, as XLA's do."""
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, bl * ar + br


@pytest.mark.parametrize("s", [1, 2, 7, 64, 97])
def test_associative_scan_equals_jax_bit_for_bit(s):
    rng = np.random.default_rng(s)
    a = rng.random((2, s, 6)).astype(np.float32)
    b = rng.standard_normal((2, s, 6)).astype(np.float32)
    ja, jb = jax.lax.associative_scan(_combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    with _flush_subnormals():
        ta, tb = rglru.associative_scan((torch.from_numpy(a), torch.from_numpy(b)), 1)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(jax_get_config("recurrentgemma-2b"))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    assert rglru.layer_kinds(cfg) == jr.layer_kinds(jcfg) == ["rec", "rec", "attn", "rec"]
    rng = np.random.default_rng(0)

    def draw(path, sds):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(sds.shape)).astype(np.float32)
        if len(sds.shape) >= 2:
            return (rng.standard_normal(sds.shape) / np.sqrt(sds.shape[-2])).astype(np.float32)
        return (0.3 * rng.standard_normal(sds.shape)).astype(np.float32)

    arrays = jax.tree_util.tree_map_with_path(draw, abstract_params(jr.rglru_block_specs(jcfg)))
    jblocks = jax.tree.map(jnp.asarray, arrays)
    blocks = params_from_numpy(arrays, device="cpu")
    assert isinstance(blocks["rec"], list) and len(blocks["rec"]) == 3 and len(blocks["attn"]) == 1
    return jcfg, cfg, jblocks, blocks, None


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, rtol=RTOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("carry", [False, True])
def test_rec_block_matches_jax(setup, carry):
    """The recurrent block over 33 tokens, fresh or from a conv carry and
    a recurrent state."""
    jcfg, cfg, jblocks, blocks, _ = setup
    rng = np.random.default_rng(2)
    w = cfg.lru_width
    x = rng.standard_normal((2, 33, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, 3, w)).astype(np.float32) if carry else None
    h0 = rng.standard_normal((2, w)).astype(np.float32) if carry else None
    jrec = jax.jit(lambda p, x, c, h: jr.rec_block(p, x, jcfg, c, h))
    want = jrec(jblocks["rec"][0], jnp.asarray(x), None if conv is None else jnp.asarray(conv),
                None if h0 is None else jnp.asarray(h0))
    with _flush_subnormals():
        got = rglru.rec_block(blocks["rec"][0], _t(x), cfg, None if conv is None else _t(conv),
                              None if h0 is None else _t(h0))
    for g, wv in zip(got, want):
        _close(g, wv)


def test_prefill_past_the_window_and_decode_past_its_edge_match_jax(setup):
    """A 100-token prefill over a 64-slot window fills the ring from slot
    100 % 64; then, from a 60-token prefill, eight decode steps cross the
    window's edge (position 64 wraps to slot 0) — each step's output and
    the final ring, recurrent states and lengths against the reference's."""
    jcfg, cfg, jblocks, blocks, _ = setup
    rng = np.random.default_rng(1)
    assert cfg.window == 64
    # The reference jitted: one compile a shape (eager JAX compiles each op).
    jforward = jax.jit(lambda b, x: jr.rglru_forward(b, x, jcfg, collect_cache=True))
    jdecode = jax.jit(lambda b, x, st: jr.rglru_decode_step(b, x, jcfg, st))
    x = rng.standard_normal((2, 100, cfg.d_model)).astype(np.float32)
    jh, jst = jforward(jblocks, jnp.asarray(x))
    with _flush_subnormals():
        h, st = rglru.rglru_forward(blocks, _t(x), cfg, collect_cache=True)
    _close(h, jh, STACK_RTOL)
    for (k, v), (jk, jv) in zip(st.caches, jst.caches, strict=True):
        _close(k, jk, STACK_RTOL)
        _close(v, jv, STACK_RTOL)
    for got, want in zip(st.conv + st.h, list(jst.conv) + list(jst.h), strict=True):
        _close(got, want, STACK_RTOL)
    np.testing.assert_array_equal(st.length.numpy(), np.asarray(jst.length))

    x = rng.standard_normal((2, 60, cfg.d_model)).astype(np.float32)
    _, jst = jforward(jblocks, jnp.asarray(x))
    st = rglru_state_from_numpy([np.asarray(c) for c in jst.conv], [np.asarray(a) for a in jst.h],
                                [(np.asarray(k), np.asarray(v)) for k, v in jst.caches],
                                np.asarray(jst.length), device="cpu")
    with _flush_subnormals():
        for _ in range(8):
            xt = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
            jy, jst = jdecode(jblocks, jnp.asarray(xt), jst)
            y, st = rglru.rglru_decode_step(blocks, _t(xt), cfg, st)
            _close(y, jy, STACK_RTOL)
    assert int(st.length[0]) == 68
    for (k, v), (jk, jv) in zip(st.caches, jst.caches, strict=True):
        _close(k, jk, STACK_RTOL)
        _close(v, jv, STACK_RTOL)
    for got, want in zip(st.conv + st.h, list(jst.conv) + list(jst.h), strict=True):
        _close(got, want, STACK_RTOL)


def test_init_state_matches_jax_shapes(setup):
    jcfg, cfg, *_ = setup
    st = rglru.init_rglru_state(cfg, 3, device="cpu")
    jst = jr.init_rglru_state(jcfg, 3)
    got = [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in
           st.conv + st.h + [c for kv in st.caches for c in kv] + [st.length]]
    want = [(a.shape, str(a.dtype)) for a in
            list(jst.conv) + list(jst.h) + [c for kv in jst.caches for c in kv] + [jst.length]]
    assert got == want
    assert rglru.init_rglru_state(cfg, 3, abstract=True).length.device.type == "meta"
