"""The port's Whisper encoder-decoder (``repro_torch.models.encdec``) and
its GELU MLP against the JAX reference's on the CPU: ``gelu_mlp``, the
sinusoidal tables, ``encode`` over frames the reference's attention block
does not divide, ``decode_prefill`` with its cross attention, and
``encdec_decode_step``, on f32 params and activations drawn with numpy
from a seed.

Bars, each with its reason:

* ``gelu_mlp`` — f32: rtol 2e-5 and atol 2e-5 of the output's scale (dot
  sums in another order; both take GELU's tanh form); bf16: 2e-2, the bf16
  bar of ``tests/test_kernels.py`` (bf16 roundings after dots summed in
  another order);
* the sinusoidal tables — atol 2e-4: each library's own f32 ``exp``
  may give the inverse frequency another last bit, and a position of up to
  1,500 times it moves the angle by up to an f32 ulp of 1,499 (1.2e-4,
  measured), which ``sin`` and ``cos`` pass on; the model adds the table
  in bf16, whose ulp at 1 is 2**-7;
* the encoder and decoder — rtol and atol 1e-4 of the output's scale: the
  reference's attention is its blockwise pass (an 11-frame block over 37
  frames: padded queries and masked keys), the port's the
  ``flash_attention`` and ``flash_decode`` kernels' plain versions, with
  the softmax sums in another order, over four layers; the reference
  runs jitted (XLA may fuse products into FMAs).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import encdec as je  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.params import abstract_params  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.interop import encdec_state_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import encdec, layers  # noqa: E402

RTOL = 2e-5
STACK_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """PyTorch's CPU ``exp`` can be off by ~1e-4 on its first call in a
    process (torch 2.13, about one process in eight); one call first."""
    torch.exp(torch.zeros(1))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, rtol=RTOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def _draw(rng):
    def draw(path, sds):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(sds.shape)).astype(np.float32)
        if len(sds.shape) >= 3 or (len(sds.shape) == 2 and "b_" not in name):
            fan_in = sds.shape[-3] * sds.shape[-2] if "wo" in name else sds.shape[-2]
            return (rng.standard_normal(sds.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.1 * rng.standard_normal(sds.shape)).astype(np.float32)

    return draw


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gelu_mlp_matches_jax(dtype):
    rng = np.random.default_rng(3)
    specs = jax_layers.gelu_mlp_specs(64, 160)
    arrays = jax.tree_util.tree_map_with_path(_draw(rng), abstract_params(specs))
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), arrays)
    p = {k: _t(np.asarray(v.astype(jnp.float32))).to(tdt) for k, v in jp.items()}
    want = jax_layers.gelu_mlp(jp, jnp.asarray(x).astype(jdt))
    got = layers.gelu_mlp(p, _t(np.asarray(jnp.asarray(x).astype(jdt).astype(jnp.float32))).to(tdt))
    assert got.dtype == tdt
    if dtype == "f32":
        _close(got, want)
    else:
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)


def test_sinusoids_match_jax():
    np.testing.assert_allclose(encdec.sinusoid(1500, 512).numpy(), np.asarray(je.sinusoid(1500, 512)),
                               atol=2e-4, rtol=0)
    pos = np.array([0, 7, 448, 1499], np.int32)
    np.testing.assert_allclose(encdec.sinusoid_at(torch.from_numpy(pos), 64).numpy(),
                               np.asarray(je.sinusoid_at(jnp.asarray(pos), 64)), atol=2e-4, rtol=0)


@pytest.fixture(scope="module")
def setup():
    # 37 frames over blocks of 11: the reference pads the queries to 44 and
    # masks 7 padded keys (tests/test_attention_properties.py's case).
    jcfg = jax_reduced(jax_get_config("whisper-base"), num_frames=37, attn_chunk=11)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(0)
    arrays = jax.tree_util.tree_map_with_path(_draw(rng), abstract_params(je.encdec_specs(jcfg)))
    jp = jax.tree.map(jnp.asarray, arrays)
    p = params_from_numpy(arrays, device="cpu")
    frames = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    memory = jax.jit(lambda p, f: je.encode(p, f, jcfg))(jp, jnp.asarray(frames))
    return jcfg, cfg, jp, p, frames, memory


def test_encode_matches_jax(setup):
    jcfg, cfg, jp, p, frames, memory = setup
    _close(encdec.encode(p, _t(frames), cfg), memory, STACK_RTOL)


def test_decode_prefill_and_steps_match_jax(setup):
    """The decoder over 9 tokens (cross attention over 37 frames: T != S),
    then three decode steps from the reference's own state."""
    jcfg, cfg, jp, p, _, memory = setup
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    jh, (jk, jv), (jck, jcv) = jax.jit(lambda p, x, m: je.decode_prefill(p, x, m, jcfg))(
        jp, jnp.asarray(x), memory)
    h, (k, v), (ck, cv) = encdec.decode_prefill(p, _t(x), _t(np.asarray(memory)), cfg)
    for got, want in ((h, jh), (k, jk), (v, jv), (ck, jck), (cv, jcv)):
        _close(got, want, STACK_RTOL)
    pad = ((0, 0), (0, 0), (0, 7), (0, 0), (0, 0))
    jst = je.EncDecState(self_k=jnp.pad(jk, pad), self_v=jnp.pad(jv, pad), cross_k=jck, cross_v=jcv,
                         length=jnp.full((2,), 9, jnp.int32))
    st = encdec_state_from_numpy(*(np.asarray(a) for a in jst), device="cpu")
    jstep = jax.jit(lambda p, x, st: je.encdec_decode_step(p, x, st, jcfg))
    for _ in range(3):
        xt = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
        jy, jst = jstep(jp, jnp.asarray(xt), jst)
        y, st = encdec.encdec_decode_step(p, _t(xt), st, cfg)
        _close(y, jy, STACK_RTOL)
    _close(st.self_k, jst.self_k, STACK_RTOL)
    np.testing.assert_array_equal(st.length.numpy(), np.asarray(jst.length))
    assert not st.self_k[:, :, 12:].any()


def test_init_state_matches_jax_shapes(setup):
    jcfg, cfg, *_ = setup
    st = encdec.init_encdec_state(cfg, 3, 20, device="cpu")
    jst = je.init_encdec_state(jcfg, 3, 20)
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in st] == \
        [(a.shape, str(a.dtype)) for a in jst]
    assert encdec.init_encdec_state(cfg, 3, 20, abstract=True).self_k.device.type == "meta"
