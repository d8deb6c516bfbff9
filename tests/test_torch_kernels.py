"""The port's plain kernel versions against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages, so the
comparison is of the functions, not of their random number generators.

Tolerances, each with its reason:

* per-request latency and read-hit flags — exact: the port keeps
  ``chunk_latency_ref``'s f32 op sequence;
* hits, reads, count, histogram counts, owners/add/drop/expired and ``f``
  — exact: integers, or the same single IEEE division;
* busy and lat_sum — exact when the latencies are whole milliseconds and a
  chunk's sum stays below 2**24 (every f32 sum of such integers is exact,
  whatever its order); otherwise, with a fractional ``extra_ms``, rtol 1e-5
  (the sums are taken in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.metadata import create_store as jax_create_store  # noqa: E402
from repro.core.metadata import record_accesses as jax_record_accesses  # noqa: E402
from repro.core.placement import redynis_candidates as jax_redynis_candidates  # noqa: E402
from repro.core.placement import sweep as jax_sweep  # noqa: E402
from repro.kernels.chunk_replay.ops import chunk_replay as jax_chunk_replay  # noqa: E402
from repro.kernels.chunk_replay.ref import chunk_latency_ref as jax_chunk_latency_ref  # noqa: E402
from repro.kernels.chunk_replay.ref import chunk_replay_ref as jax_chunk_replay_ref  # noqa: E402
from repro.kernels.latency_histogram.ref import bin_index as jax_bin_index  # noqa: E402
from repro.kernels.ownership_sweep.kernel import ownership_sweep_call  # noqa: E402
from repro_torch.core.metadata import record_accesses  # noqa: E402
from repro_torch.core.placement import redynis_candidates  # noqa: E402
from repro_torch.interop import store_from_numpy  # noqa: E402
from repro_torch.kernels.chunk_replay.ops import chunk_replay  # noqa: E402
from repro_torch.kernels.chunk_replay.ref import READ_MODES, chunk_latency_ref  # noqa: E402
from repro_torch.kernels.latency_histogram.ref import bin_index  # noqa: E402
from repro_torch.kernels.ownership_sweep.ops import ownership_sweep  # noqa: E402
from repro_torch.kvsim.cluster import WAN5_RTT_MS, flat_rtt  # noqa: E402

TOPOLOGIES = {"flat": np.float32(flat_rtt()), "wan5": np.float32(WAN5_RTT_MS)}


def _random_chunk(seed, b, k, n, read_fraction, empty_rows=0.1):
    """The same generator as tests/test_chunk_replay.py::_random_chunk."""
    rng = np.random.default_rng(seed)
    hosts = rng.random((k, n)) < 0.4
    if empty_rows:
        hosts[rng.random(k) < empty_rows] = False
    return (
        hosts,
        rng.integers(0, k, b).astype(np.int32),
        rng.integers(0, n, b).astype(np.int32),
        rng.random(b) < read_fraction,
        rng.random(b) < 0.9,
    )


def _to_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


CHUNK_GRID = [
    (topo, mode, bins, extra)
    for topo in TOPOLOGIES
    for mode in READ_MODES
    for bins in (0, 64)
    for extra in (False, True)
]


@pytest.mark.parametrize(
    "topo,mode,bins,extra", CHUNK_GRID,
    ids=[f"{t}-{m}-bins{b}-{'extra' if e else 'plain'}" for t, m, b, e in CHUNK_GRID],
)
def test_chunk_replay_ref_matches_jax(topo, mode, bins, extra):
    rtt = TOPOLOGIES[topo]
    n = rtt.shape[0]
    master = n - 1  # a non-zero master exercises the relay leg
    b, k = 777, 333
    hosts, keys, nodes, is_read, valid = _random_chunk(
        hash((topo, mode, bins, extra)) % 2**32, b, k, n, 0.75
    )
    extra_ms = (
        np.random.default_rng(5).uniform(0.0, 30.0, b).astype(np.float32)
        if extra else None
    )
    kw = dict(
        service_ms=10.0, master=master, xfer_read_ms=2.0, xfer_write_ms=3.0,
        read_mode=mode, num_bins=bins, lo=1.0, hi=5_000.0,
    )
    jargs = [jnp.asarray(a) for a in (hosts, keys, nodes, is_read, valid, rtt)]
    jextra = None if extra_ms is None else jnp.asarray(extra_ms)
    ref = jax_chunk_replay_ref(*jargs, extra_ms=jextra, **kw)
    pal = jax_chunk_replay(
        *jargs, backend="pallas", tr=256, tkey=128, interpret=True,
        extra_ms=jextra, **kw,
    )
    targs = _to_torch(hosts, keys, nodes, is_read, valid, rtt)
    textra = None if extra_ms is None else torch.from_numpy(extra_ms)
    out = chunk_replay(*targs, extra_ms=textra, **kw)

    # Per-request latency and hit flags: exact.
    lkw = {key: kw[key] for key in ("service_ms", "master", "xfer_read_ms", "xfer_write_ms", "read_mode")}
    jlat, jhit = jax_chunk_latency_ref(*jargs[:4], jargs[5], **lkw)
    tlat, thit = chunk_latency_ref(*targs[:4], targs[5], **lkw)
    np.testing.assert_array_equal(tlat.numpy(), np.asarray(jlat))
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))

    for other, name in ((ref, "ref"), (pal, "pallas")):
        if extra:
            np.testing.assert_allclose(out[0].numpy(), np.asarray(other[0]), rtol=1e-5, err_msg=name)
            np.testing.assert_allclose(float(out[1]), float(other[1]), rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(out[0].numpy(), np.asarray(other[0]), err_msg=name)
            assert float(out[1]) == float(other[1]), name
        for i in (2, 3, 4):  # hits, reads, count
            assert int(out[i]) == float(other[i]), (name, i)
        if bins:
            np.testing.assert_array_equal(out[5].numpy(), np.asarray(other[5]), err_msg=name)
        else:
            assert out[5] is None and other[5] is None


def test_decade_edge_latencies_land_in_reference_bins():
    """1, 10, 100 and 1000 ms sit exactly on bin edges at lo=1, hi=1e4,
    B=128 (t*126 = 0, 31.5, 63.0, 94.5): bins 1, 32, 64 and 95."""
    lat = np.asarray([1.0, 10.0, 100.0, 1000.0, 0.5, 1e4, 9999.0], np.float32)
    want = np.asarray(jax_bin_index(jnp.asarray(lat), 1.0, 10_000.0, 128))
    np.testing.assert_array_equal(want[:4], [1, 32, 64, 95])
    got = bin_index(torch.from_numpy(lat), 1.0, 10_000.0, 128).numpy()
    np.testing.assert_array_equal(got, want)


def test_bin_index_matches_jax_on_random_latencies():
    lat = np.random.default_rng(0).uniform(0.0, 12_000.0, 20_000).astype(np.float32)
    for lo, hi, bins in ((1.0, 10_000.0, 128), (1.0, 5_000.0, 64), (0.5, 2_000.0, 33)):
        want = np.asarray(jax_bin_index(jnp.asarray(lat), lo, hi, bins))
        got = bin_index(torch.from_numpy(lat), lo, hi, bins).numpy()
        np.testing.assert_array_equal(got, want)


def _random_store(seed, k, n):
    """The same generator as tests/test_ownership_parity.py::_random_store."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 100, size=(k, n)).astype(np.int32)
    counts[rng.random(k) < 0.25] = 0
    hosts = rng.random((k, n)) < 0.4
    live = rng.random(k) < 0.85
    last = rng.integers(0, 120, size=k).astype(np.int32)
    return counts, hosts, live, last


def _tie_store():
    """Rows whose fractions equal H exactly (equal counts), argmax ties,
    a zero-traffic row and a dead key."""
    counts = np.asarray(
        [[7, 7, 7, 7], [2, 2, 0, 0], [5, 5, 1, 0], [0, 0, 0, 0], [3, 3, 3, 3], [1, 1, 1, 1]],
        np.int32,
    )
    hosts = np.asarray(
        [[0, 0, 0, 1], [1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 1], [1, 1, 0, 0], [0, 0, 0, 1]],
        bool,
    )
    live = np.asarray([1, 1, 1, 1, 0, 1], bool)
    last = np.asarray([100, 99, 10, 0, 100, 96], np.int32)
    return counts, hosts, live, last


SWEEP_GRID = [
    ("random", 0, 3, 64, 0, 1 / 3),
    ("random", 1, 4, 57, 3, 0.5),  # H > 1/n: the starvation guard fires
    ("random", 2, 8, 80, 25, 0.125),
    ("random", 3, 2, 1, 0, 0.9),
    ("random", 4, 5, 33, 3, 0.05),
    ("ties", 0, 4, 6, 0, 0.25),  # f == H on the equal-count rows
    ("ties", 0, 4, 6, 3, 0.25),
    ("ties", 0, 4, 6, 0, 0.5),  # [2, 2, 0, 0] sits exactly on H = 0.5
]


@pytest.mark.parametrize("params", SWEEP_GRID, ids=[f"{p[0]}-{i}" for i, p in enumerate(SWEEP_GRID)])
def test_sweep_ref_matches_jax(params):
    kind, seed, n, k, expiry, h = params
    counts, hosts, live, last = _random_store(seed, k, n) if kind == "random" else _tie_store()
    now = 100
    jstore = jax_create_store(k, n)._replace(
        access_counts=jnp.asarray(counts), hosts=jnp.asarray(hosts),
        live=jnp.asarray(live), last_access=jnp.asarray(last),
    )
    plan, _ = jax_sweep(jstore, h, now, expiry if expiry else None, backend="jax")
    pal = ownership_sweep_call(
        jnp.asarray(counts, jnp.float32), jnp.asarray(hosts), jnp.asarray(live),
        jnp.asarray(last), now, h=h, expiry=expiry, tk=k, interpret=True,
    )
    owners, add, drop, expired, f = ownership_sweep(
        *_to_torch(counts, hosts, live, last), now, h=h, expiry=expiry
    )
    got = [owners, add, drop, expired, f]
    want_plan = [plan.owners, plan.to_add, plan.to_drop, plan.expired, plan.f]
    want_pal = [np.asarray(a) for a in pal]
    want_pal[:3] = [a.astype(bool) for a in want_pal[:3]]
    want_pal[3] = want_pal[3][:, 0].astype(bool)
    for name, g, wp, wk in zip(("owners", "add", "drop", "expired", "f"), got, want_plan, want_pal):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wp), err_msg=f"{name} vs sweep")
        np.testing.assert_array_equal(g.numpy(), wk, err_msg=f"{name} vs pallas")
    # The decide stage alone (no expiry), from the same fractions.
    store = store_from_numpy(counts, hosts, last, live, np.zeros(k, np.int32), device="cpu")
    np.testing.assert_array_equal(
        redynis_candidates(store, f, h).numpy(),
        np.asarray(jax_redynis_candidates(jstore, plan.f, h)),
    )


def test_record_accesses_matches_jax_with_valid_mask():
    rng = np.random.default_rng(7)
    k, n, b = 50, 4, 600
    counts, hosts, live, last = _random_store(7, k, n)
    home = rng.integers(0, n, k).astype(np.int32)
    keys = rng.integers(0, k, b).astype(np.int32)
    nodes = rng.integers(0, n, b).astype(np.int32)
    valid = rng.random(b) < 0.7
    jstore = jax_create_store(k, n)._replace(
        access_counts=jnp.asarray(counts), hosts=jnp.asarray(hosts),
        live=jnp.asarray(live), last_access=jnp.asarray(last), home=jnp.asarray(home),
    )
    want = jax_record_accesses(
        jstore, jnp.asarray(keys), jnp.asarray(nodes), now=130, valid=jnp.asarray(valid)
    )
    store = store_from_numpy(counts, hosts, last, live, home, device="cpu")
    got = record_accesses(store, *_to_torch(keys, nodes), now=130, valid=torch.from_numpy(valid))
    for name in ("access_counts", "hosts", "last_access", "live", "home"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
        )


def test_wrappers_check_inputs():
    hosts, keys, nodes, is_read, valid = _to_torch(*_random_chunk(0, 8, 8, 3, 1.0))
    rtt = torch.from_numpy(TOPOLOGIES["flat"])
    kw = dict(service_ms=1.0, master=0, xfer_read_ms=0.0, xfer_write_ms=0.0)
    with pytest.raises(ValueError, match="read_mode"):
        chunk_replay(hosts, keys, nodes, is_read, valid, rtt, read_mode="bogus", **kw)
