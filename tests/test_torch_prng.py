"""The port's copy of ``jax.random``'s threefry2x32 stream
(``kvsim/prng.py``) against ``jax.random`` on the CPU.

Bars, each with its reason:

* ``threefry2x32``, ``prng_key``, ``split``, ``fold_in``, ``bits``,
  ``randint``, ``uniform``, ``bernoulli`` and ``choice`` — exact: integer
  ops, one exact f32 subtract, and an f32 prefix sum of a handful of terms
  added left to right as XLA adds them;
* ``normal`` — within 3 ulps, about one value in a hundred off: the port
  takes a correctly rounded ``log1p`` where XLA's CPU ``log1p`` is up to two
  ulps off (the ``erf_inv`` polynomial is XLA's, its Horner steps fused as
  XLA fuses them).

The module follows the partitionable threefry layout, which this jax runs
with; the test asserts the setting, since under the classic layout the
draws would differ.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src.prng import threefry2x32_p  # noqa: E402

from repro_torch.kvsim import prng  # noqa: E402


def _warm_exp():
    """PyTorch's CPU ``exp`` can return values off by ~1e-4 on its first
    call in a process (about one process in eight); one call first avoids it."""
    torch.exp(torch.zeros(1))


_warm_exp()

SEEDS = [0, 1, 42, 2**31 + 5, 2**40 + 7]
N = 10_001


def _key(seed):
    return jax.random.PRNGKey(seed), prng.prng_key(seed)


def _ints(a):
    return np.asarray(a).astype(np.int64)


def test_jax_runs_the_partitionable_layout():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry2x32_matches_the_primitive(seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (4, 4_096), dtype=np.uint64).astype(np.uint32)
    words[:, :4] = [[0, 0xFFFFFFFF, 0, 0xFFFFFFFF]] * 4  # extremes
    want = threefry2x32_p.bind(*(jnp.asarray(w) for w in words))
    got = prng.threefry2x32(*(torch.from_numpy(w.astype(np.int64)) for w in words))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _ints(w))
    scalar = prng.threefry2x32(*(int(w[5]) for w in words))  # Python ints, one block
    assert scalar == (int(want[0][5]), int(want[1][5]))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_and_bits_match_jax(seed):
    jkey, tkey = _key(seed)
    assert tuple(int(x) for x in jkey) == tkey
    assert [tuple(int(x) for x in k) for k in jax.random.split(jkey, 7)] == prng.split(tkey, 7)
    for data in (0, 1, 2, 0x9E37, 2**32 - 1):
        assert tuple(int(x) for x in jax.random.fold_in(jkey, data)) == prng.fold_in(tkey, data)
    data = torch.arange(5, dtype=torch.int64)
    k0, k1 = prng.fold_in(tkey, data)  # a key a value
    for i in range(5):
        assert (int(k0[i]), int(k1[i])) == prng.fold_in(tkey, i)
    pos = torch.arange(N)
    np.testing.assert_array_equal(prng.bits(tkey, pos).numpy(), _ints(jax.random.bits(jkey, (N,))))
    window = torch.arange(4_000, 4_100)  # a window is the counters of its positions
    np.testing.assert_array_equal(prng.bits(tkey, window).numpy(),
                                  _ints(jax.random.bits(jkey, (N,)))[4_000:4_100])


BOUNDS = [(0, 7), (3, 1000), (1, 5), (1, 1), (5, 2), (0, 1 << 16), (0, 1_000_000), (100, 1_000_000),
          (-50, 50), (0, 2**31 - 1)]


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_randint_matches_jax(seed):
    jkey, tkey = _key(seed)
    pos = torch.arange(N)
    for lo, hi in BOUNDS:
        got = prng.randint(tkey, pos, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.randint(jkey, (N,), lo, hi)),
                                      err_msg=f"{lo} {hi}")


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uniform_and_bernoulli_match_jax(seed):
    jkey, tkey = _key(seed)
    pos = torch.arange(N)
    np.testing.assert_array_equal(prng.uniform(tkey, pos).numpy(), np.asarray(jax.random.uniform(jkey, (N,))))
    np.testing.assert_array_equal(prng.uniform(tkey, pos, -3.0, 7.5).numpy(),
                                  np.asarray(jax.random.uniform(jkey, (N,), jnp.float32, -3.0, 7.5)))
    for p in (0.9, 0.7, 1.0, 0.0, 0.5, 0.333, 0.1):
        np.testing.assert_array_equal(prng.bernoulli(tkey, p, pos).numpy(),
                                      np.asarray(jax.random.bernoulli(jkey, p, (N,))), err_msg=str(p))


WEIGHTS = [(0.35, 0.25, 0.20, 0.12, 0.08), (0.60, 0.10, 0.10, 0.10, 0.10), (1.0, 2.0, 3.0),
           (0.1,) * 7, (0.5,)]


@pytest.mark.parametrize("w", WEIGHTS, ids=[f"n{len(w)}" for w in WEIGHTS])
def test_choice_with_p_matches_jax(w):
    """``choice(n, p=w / sum(w))`` as the reference's natural nodes draw it;
    the normalised weights themselves are equal too."""
    for seed in SEEDS[:3]:
        jkey, tkey = _key(seed)
        wj = jnp.asarray(w, jnp.float32)
        pj = wj / jnp.sum(wj)
        wt = torch.tensor(w, dtype=torch.float32)
        total = wt[0]
        for x in wt[1:]:
            total = total + x
        pt = wt / total
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        got = prng.choice(tkey, len(w), torch.arange(N), pt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax.random.choice(jkey, len(w), (N,), p=pj)))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_normal_within_three_ulps_of_jax(seed):
    jkey, tkey = _key(seed)
    got = prng.normal(tkey, torch.arange(N)).numpy()
    want = np.asarray(jax.random.normal(jkey, (N,)))
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 3 and (ulps > 0).mean() < 0.02, (ulps.max(), (ulps > 0).mean())
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    np.testing.assert_array_equal(prng.uniform(tkey, torch.arange(N), lo, 1.0).numpy(),
                                  np.asarray(jax.random.uniform(jkey, (N,), jnp.float32, lo, 1.0)))


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    got = prng.erf_inv_f32(x).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert np.isneginf(got[0]) and np.isposinf(got[1]) and got[2] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6)
