"""The port's attention against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
port's ``flash_attention`` and ``flash_decode`` run their plain versions
here (CPU tensors); the card-only kernel tests are in
``tests/test_torch_package.py``.

Tolerances, each with its reason:

* f32 — 2e-5 (atol and rtol), the reference's own bar for its kernels
  (``tests/test_kernels.py``): exp and f32 sums in another order;
* bf16 — 2e-2, the same file's bar: ``p`` is rounded to bf16 against
  another running max when the kv blocks differ, and the output is rounded
  to bf16;
* against ``blockwise_attention`` in bf16 — one bf16 ulp of the output
  (2**-7 relative) more: it rounds each block's PV product to bf16 as
  well, where the Pallas kernel and the port keep it in f32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.flash_decode.ops import flash_decode as jax_flash_decode  # noqa: E402
from repro.kernels.flash_decode.ref import decode_ref  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_decode.ops import flash_decode  # noqa: E402
from repro_torch.models import attention  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """PyTorch's CPU ``exp`` can return values off by ~1e-4 on its first
    call in a process (seen with torch 2.13 on AVX-512 hosts, about one
    process in eight); one call on a single element first avoids it."""
    torch.exp(torch.zeros(1))


DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, 2e-2)}


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(a, dtype):
    """One array as a JAX and a torch tensor of ``dtype``, the same values
    (bf16 rounded once, in JAX, and carried across bit for bit)."""
    _, jdt, tdt, _ = DTYPES[dtype]
    j = jnp.asarray(a).astype(jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


# tests/test_kernels.py's shapes: (b, s, t, h, kh, dh, causal, window).
ATTN_CASES = [
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 128, 8, 1, 128, True, 0),  # MQA
    (2, 256, 256, 4, 4, 32, True, 64),  # MHA + sliding window
    (1, 128, 384, 4, 2, 64, False, 0),  # cross attention, T > S
    (1, 192, 192, 6, 2, 64, True, 0),  # 192 rows: three 64-row tiles
    (1, 256, 256, 10, 1, 256, True, 64),  # recurrentgemma-2b's heads: 10 q, 1 kv of 256, a window
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "b{}s{}t{}h{}kh{}d{}c{}w{}".format(*c))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_plain_matches_jax(case, dtype):
    b, s, t, h, kh, dh, causal, window = case
    rng = np.random.default_rng(s * 7 + t + h)
    (jq, q), (jk, k), (jv, v) = (_both(_normal(rng, sh), dtype) for sh in
                                 ((b, s, h, dh), (b, t, kh, dh), (b, t, kh, dh)))
    tol = DTYPES[dtype][3]
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == (b, s, h, dh)
    qf = jq.transpose(0, 2, 1, 3).reshape(b * h, s, dh)
    kf = jk.transpose(0, 2, 1, 3).reshape(b * kh, t, dh)
    vf = jv.transpose(0, 2, 1, 3).reshape(b * kh, t, dh)
    ref = attention_ref(qf, kf, vf, group=h // kh, heads=h, kv_heads=kh, causal=causal,
                        window=window).reshape(b, h, s, dh).transpose(0, 2, 1, 3)
    _close(got, ref, tol)
    # The reference's interpret-mode Pallas kernel at the port's 64-row tiles.
    pallas = jax_flash_attention(jq, jk, jv, causal=causal, window=window, bq=64, bk=64)
    _close(got, pallas, tol)


@pytest.mark.parametrize(
    "s,t,causal,window",
    [(100, 100, True, 0), (77, 77, True, 24), (50, 173, False, 0)],
)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_ragged_matches_blockwise(s, t, causal, window, dtype):
    """Any S and T: the port masks the ragged edge where the reference's
    ``blockwise_attention`` pads (here with 32-row chunks)."""
    rng = np.random.default_rng(s + t)
    (jq, q), (jk, k), (jv, v) = (_both(_normal(rng, sh), dtype) for sh in
                                 ((2, s, 4, 32), (2, t, 2, 32), (2, t, 2, 32)))
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = jax_attention.blockwise_attention(jq, jk, jv, causal=causal, window=window, chunk=32)
    tol = DTYPES[dtype][3] + (2**-7 if dtype == "bf16" else 0.0)
    _close(got, want, tol)


# Rows with no allowed key: window > 0 and T + window <= S leave rows
# i >= T + window - 1 with every score masked; (b, s, t, h, kh, dh, causal, window).
EMPTY_ROW_CASES = [
    (1, 256, 64, 4, 2, 64, True, 16),  # 177 empty rows, q tiles with no kv tile
    (2, 192, 128, 4, 2, 32, False, 24),  # empty rows from 151 on, mid-tile
]


@pytest.mark.parametrize("case", EMPTY_ROW_CASES, ids=lambda c: "b{}s{}t{}h{}kh{}d{}c{}w{}".format(*c))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_rows_without_keys_are_the_mean_of_v(case, dtype):
    """A query that sees no key: the reference's softmax over all-masked
    scores is uniform, so the row is the mean of v over its kv head's T
    keys. The plain version gives it, as ``attention_ref`` and the Pallas
    kernel (interpret mode) do."""
    b, s, t, h, kh, dh, causal, window = case
    rng = np.random.default_rng(s + t + window)
    (jq, q), (jk, k), (jv, v) = (_both(_normal(rng, sh), dtype) for sh in
                                 ((b, s, h, dh), (b, t, kh, dh), (b, t, kh, dh)))
    tol = DTYPES[dtype][3]
    got = flash_attention(q, k, v, causal=causal, window=window)
    qf = jq.transpose(0, 2, 1, 3).reshape(b * h, s, dh)
    kf = jk.transpose(0, 2, 1, 3).reshape(b * kh, t, dh)
    vf = jv.transpose(0, 2, 1, 3).reshape(b * kh, t, dh)
    ref = attention_ref(qf, kf, vf, group=h // kh, heads=h, kv_heads=kh, causal=causal,
                        window=window).reshape(b, h, s, dh).transpose(0, 2, 1, 3)
    _close(got, ref, tol)
    pallas = jax_flash_attention(jq, jk, jv, causal=causal, window=window, bq=64, bk=64)
    _close(got, pallas, tol)
    first = t + window - 1
    assert fa_ops.has_empty_rows(s, t, window) and first < s
    mean_v = v.float().mean(dim=1).repeat_interleave(h // kh, dim=1)  # [b, h, dh]
    _close(got[:, first:], mean_v[:, None].expand(b, s - first, h, dh).numpy(), tol)
    # The row before the first empty one sees exactly one key: v of key t - 1.
    _close(got[:, first - 1], v[:, t - 1].float().repeat_interleave(h // kh, dim=1).numpy(), tol)


def test_flash_attention_window_skips_only_empty_tiles():
    """With a window far below the tile size most kv tiles are empty for
    most rows; the result equals the exact masked softmax (f32)."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(_normal(rng, (1, 300, 2, 32))) for _ in range(3))
    got = flash_attention(q, k, v, causal=True, window=5)
    want = attention.dense_attention(q, k, v, causal=True, window=5)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# tests/test_kernels.py's shapes, then recurrentgemma-2b's heads (10 q, 1 kv
# of 256) at a short ring: (b, t, h, kh, dh).
DECODE_CASES = [(2, 1024, 8, 2, 64), (4, 512, 4, 1, 128), (2, 768, 16, 16, 32), (2, 512, 10, 1, 256)]


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "b{}t{}h{}kh{}d{}".format(*c))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_decode_plain_matches_jax(case, dtype):
    b, t, h, kh, dh = case
    rng = np.random.default_rng(t + h)
    (jq, q), (jk, k), (jv, v) = (_both(_normal(rng, sh), dtype) for sh in
                                 ((b, h, dh), (b, t, kh, dh), (b, t, kh, dh)))
    lengths = rng.integers(1, t, b).astype(np.int32)
    lengths[0] = t + 3  # past the cache: the whole cache is valid
    tol = DTYPES[dtype][3]
    got = flash_decode(q, k, v, torch.from_numpy(lengths))
    assert got.dtype == q.dtype and got.shape == (b, h, dh)
    _close(got, decode_ref(jq, jk, jv, jnp.asarray(lengths)), tol)
    _close(got, jax_flash_decode(jq, jk, jv, jnp.asarray(lengths), bk=256), tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_decode_plain_matches_jax_at_length_zero(dtype):
    """A length of 0 masks every position: the reference's softmax then
    weighs the whole cache alike, and the plain version must do the same."""
    b, t, h, kh, dh = 3, 768, 4, 2, 64
    rng = np.random.default_rng(5)
    (jq, q), (jk, k), (jv, v) = (_both(_normal(rng, sh), dtype) for sh in
                                 ((b, h, dh), (b, t, kh, dh), (b, t, kh, dh)))
    lengths = np.array([0, 1, t + 1], np.int32)
    tol = DTYPES[dtype][3]
    got = flash_decode(q, k, v, torch.from_numpy(lengths))
    _close(got, decode_ref(jq, jk, jv, jnp.asarray(lengths)), tol)
    _close(got, jax_flash_decode(jq, jk, jv, jnp.asarray(lengths), bk=256), tol)
    mean_v = v[0].float().mean(dim=0).repeat_interleave(h // kh, dim=0)
    _close(got[0], mean_v.numpy(), tol)


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0), (True, 16, 0), (False, 0, 0), (True, 0, 8)])
def test_dense_attention_matches_jax(causal, window, q_offset):
    rng = np.random.default_rng(window + q_offset)
    (jq, q), (jk, k), (jv, v) = (_both(_normal(rng, sh), "bf16") for sh in
                                 ((2, 40, 4, 32), (2, 48, 2, 32), (2, 48, 2, 32)))
    got = attention.dense_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    want = jax_attention.dense_attention(jq, jk, jv, causal=causal, window=window, q_offset=q_offset)
    _close(got, want, 2e-2)


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(11)
    (jq, q), (jk, k), (jv, v) = (_both(_normal(rng, sh), "bf16") for sh in
                                 ((3, 8, 64), (3, 96, 4, 64), (3, 96, 4, 64)))
    length = np.asarray([1, 50, 200], np.int32)  # the last is past T = 96
    got = attention.decode_attention(q, k, v, torch.from_numpy(length))
    want = jax_attention.decode_attention(jq, jk, jv, jnp.asarray(length))
    _close(got, want, 2e-2)
    # The plain flash_decode computes the same function.
    _close(flash_decode(q, k, v, torch.from_numpy(length)), want, 2e-2)
