"""The port's capacity projection, capacity-aware sweep and the small
metadata and latency helpers, on the CPU against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages. Bars,
each with its reason:

* every boolean output (projected owners, evictions, rejections, plans,
  hits, owners of keys) — exact: the same lexicographic order (owned, f
  descending, held before add, key id) and the same admission test;
* equal object sizes, and sizes that are small integers — exact: every
  prefix sum is an exact f32 integer, so the reference's f32 prefix sum
  and the port's f64 one agree;
* lognormal sizes — the port's f64 prefix sum is exact, the reference's
  f32 one rounds. Where a budget lies off the line the two admit the same
  keys; where it is set on a key's exact prefix sum the reference's
  rounding can move that key across it. The test pins those differences:
  36 cells over 20 seeded trials of 500 keys x 5 nodes, each within
  2**-23 of its budget (one f32 ulp), and none elsewhere;
* latencies and ``replication_gain`` — exact: the same f32 expressions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import costmodel as jc  # noqa: E402
from repro.core import metadata as jmeta  # noqa: E402
from repro.core import placement as jplace  # noqa: E402
import repro.kvsim.cluster as jcl  # noqa: E402
from repro_torch.core import costmodel as tc  # noqa: E402
from repro_torch.core import metadata as tmeta  # noqa: E402
from repro_torch.core import placement as tplace  # noqa: E402
import repro_torch.kvsim.cluster as tcl  # noqa: E402
from repro_torch.interop import cluster_from_fields, store_from_numpy  # noqa: E402


def _warm_exp():
    """PyTorch's CPU ``exp`` can return values off by ~1e-4 on its first
    call in a process (about one process in eight); one call first avoids it."""
    torch.exp(torch.zeros(1))


_warm_exp()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, k=400, n=5, sizes="equal"):
    """Owners, hosts, f with many ties (counts 0..3), object sizes."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 4, (k, n))
    total = counts.sum(1, keepdims=True)
    f = np.where(total > 0, counts / np.maximum(total, 1), 0).astype(np.float32)
    owners = rng.random((k, n)) < 0.6
    hosts = rng.random((k, n)) < 0.5
    if sizes == "equal":
        obj = np.full(k, 1024.0, np.float32)
    elif sizes == "integer":
        obj = rng.choice([256.0, 1024.0, 3000.0, 4096.0], k).astype(np.float32)
    else:
        obj = (1024 * np.exp(0.5 * rng.standard_normal(k))).astype(np.float32)
    return owners, hosts, f, obj


def _both(owners, hosts, f, obj, budget):
    ref = jc.project_capacity(jnp.asarray(owners), jnp.asarray(hosts), jnp.asarray(f),
                              jnp.asarray(obj), jnp.asarray(budget, jnp.float32))
    ours = tc.project_capacity(_t(owners), _t(hosts), _t(f), _t(obj),
                               budget if np.isscalar(budget) else _t(np.float32(budget)))
    return [np.asarray(x) for x in ref], [x.numpy() for x in ours]


@pytest.mark.parametrize("sizes", ["equal", "integer"])
@pytest.mark.parametrize("budget_kind", ["scalar", "per_node", "tight"])
@pytest.mark.parametrize("seed", [0, 1])
def test_project_capacity_matches_jax(seed, budget_kind, sizes):
    owners, hosts, f, obj = _inputs(seed, sizes=sizes)
    n = owners.shape[1]
    total = float(obj.sum())
    budget = {
        "scalar": 0.3 * total,
        "per_node": np.linspace(0.05, 0.5, n) * total,
        "tight": np.array([0.0, 1024.0, 4096.0, 0.01 * total, 0.1 * total]),
    }[budget_kind]
    ref, ours = _both(owners, hosts, f, obj, budget)
    for name, a, b in zip(("projected", "evicted", "rejected"), ref, ours):
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert ours[1].any() and ours[2].any()  # the budget bites on held and added


def test_project_capacity_breaks_f_ties_held_first_then_by_key():
    """Four owned keys at equal f on one node, room for two: the held
    replicas win, and between two held ones the lower key id."""
    owners = np.ones((4, 1), bool)
    hosts = np.array([[False], [True], [False], [True]])
    f = np.full((4, 1), 0.5, np.float32)
    f[2, 0] = -0.0  # -0.0 ties 0.0 and sorts below 0.5
    obj = np.full(4, 1.0, np.float32)
    ref, ours = _both(owners, hosts, f, obj, 2.0)
    np.testing.assert_array_equal(ours[0][:, 0], [False, True, False, True])
    for a, b in zip(ref, ours):
        np.testing.assert_array_equal(b, a)
    f2 = np.zeros((4, 1), np.float32)
    f2[1, 0] = -0.0
    ref, ours = _both(owners, np.zeros((4, 1), bool), f2, obj, 2.0)
    np.testing.assert_array_equal(ours[0][:, 0], [True, True, False, False])
    np.testing.assert_array_equal(ours[0], ref[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_infinite_budget_is_the_identity(seed):
    owners, hosts, f, obj = _inputs(seed, sizes="lognormal")
    ref, ours = _both(owners, hosts, f, obj, float("inf"))
    np.testing.assert_array_equal(ours[0], owners)
    assert not ours[1].any() and not ours[2].any()
    for a, b in zip(ref, ours):
        np.testing.assert_array_equal(b, a)


def test_lognormal_sizes_off_the_budget_line_match_jax():
    rng = np.random.default_rng(7)
    for seed in range(10):
        owners, hosts, f, obj = _inputs(seed, k=500, sizes="lognormal")
        budget = rng.uniform(0.2, 0.6, 5).astype(np.float32) * obj.sum()
        ref, ours = _both(owners, hosts, f, obj, budget)
        for a, b in zip(ref, ours):
            np.testing.assert_array_equal(b, a)


def test_lognormal_sizes_differ_from_jax_only_at_the_budget_line():
    """Budgets set on a key's exact prefix sum: the port admits exactly the
    keys whose exact sum fits; JAX's f32 prefix sum moves some of the keys
    at the line (pinned count), and no other."""
    rng = np.random.default_rng(0)
    k, n = 500, 5
    differing = 0
    for _ in range(20):
        counts = rng.integers(0, 4, (k, n))
        total = counts.sum(1, keepdims=True)
        f = np.where(total > 0, counts / np.maximum(total, 1), 0).astype(np.float32)
        owners = rng.random((k, n)) < 0.6
        hosts = rng.random((k, n)) < 0.5
        obj = (1024 * np.exp(0.5 * rng.standard_normal(k))).astype(np.float32)
        held = owners & hosts
        exact = np.zeros((k, n))
        budget = np.zeros(n, np.float32)
        for j in range(n):
            order = np.lexsort((np.arange(k), ~held[:, j], -f[:, j], ~owners[:, j]))
            prefix = np.cumsum(np.where(owners[order, j], obj[order].astype(np.float64), 0.0))
            exact[order, j] = prefix
            budget[j] = np.float32(prefix[rng.integers(k // 4, k // 2)])
        ref, ours = _both(owners, hosts, f, obj, budget)
        np.testing.assert_array_equal(ours[0], owners & (exact <= budget.astype(np.float64)))
        diff = ref[0] != ours[0]
        rel = np.abs(exact - budget.astype(np.float64)) / budget.astype(np.float64)
        assert (rel[diff] <= 2.0**-23).all()
        differing += int(diff.sum())
    assert differing == 36


def test_budget_plan_matches_jax():
    rng = np.random.default_rng(3)
    k, n = 300, 4
    counts = rng.integers(0, 5, (k, n)).astype(np.int32)
    hosts = rng.random((k, n)) < 0.4
    owners = rng.random((k, n)) < 0.5
    expired = rng.random(k) < 0.05
    obj = np.full(k, 1024.0, np.float32)
    jplan = jplace.PlacementPlan(jnp.asarray(owners), jnp.asarray(owners & ~hosts),
                                 jnp.asarray(hosts & ~owners), jnp.asarray(expired))
    tplan = tplace.PlacementPlan(_t(owners), _t(owners & ~hosts), _t(hosts & ~owners), _t(expired))
    for budget in (40 * 1024.0, [10240.0, 20480.0, 51200.0, 1e9]):
        a = jc.budget_plan(jplan, jnp.asarray(counts), jnp.asarray(obj), jnp.asarray(budget, jnp.float32))
        b = tc.budget_plan(tplan, _t(counts), _t(obj), budget)
        for name in ("owners", "to_add", "to_drop", "capacity_evicted"):
            np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)),
                                          err_msg=name)
    assert tc.budget_plan(tplan, _t(counts), _t(obj), float("inf")) is tplan


def test_replication_gain_and_hardware_model():
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 100, (50, 3)).astype(np.int32)
    obj = rng.uniform(100, 5000, 50).astype(np.float32)
    hw = jc.TPU_V5E
    a = jc.replication_gain(jnp.asarray(counts), 4096.0, 8.0, jnp.asarray(obj), hw)
    b = tc.replication_gain(_t(counts), 4096.0, 8.0, _t(obj), tc.HardwareModel(*hw))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert tc.HardwareModel() == tc.H100_SXM == (989e12, 3.35e12, 450e9, 80e9)
    assert tc.HardwareModel._fields == jc.HardwareModel._fields


def _store(seed, k=300, n=5):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 4, (k, n)).astype(np.int32)
    counts[rng.random(k) < 0.2] = 0
    hosts = rng.random((k, n)) < 0.4
    last = rng.integers(0, 10, k).astype(np.int32)
    live = rng.random(k) < 0.95
    home = rng.integers(0, n, k).astype(np.int32)
    arrays = (counts, hosts, last, live, home)
    jstore = jmeta.MetadataStore(*(jnp.asarray(a) for a in arrays))
    return jstore, store_from_numpy(*arrays, device="cpu")


@pytest.mark.parametrize("budget", [None, float("inf"), 30 * 1024.0, (8192.0, 1e9, 20480.0, 4096.0, 0.0)])
@pytest.mark.parametrize("expiry", [0, 4])
def test_sweep_with_capacity_matches_jax(budget, expiry):
    jstore, tstore = _store(5)
    obj = np.random.default_rng(6).choice([512.0, 1024.0, 2048.0], 300).astype(np.float32)
    kw_j = {} if budget is None else dict(object_bytes=jnp.asarray(obj),
                                          capacity_bytes=jnp.asarray(budget, jnp.float32))
    kw_t = {} if budget is None else dict(object_bytes=_t(obj), capacity_bytes=budget)
    jplan, jnew = jplace.sweep(jstore, 0.2, 9, expiry, **kw_j)
    tplan, tnew = tplace.sweep(tstore, 0.2, 9, expiry, **kw_t)
    for name in ("owners", "to_add", "to_drop", "expired", "f"):
        np.testing.assert_array_equal(getattr(tplan, name).numpy(), np.asarray(getattr(jplan, name)),
                                      err_msg=name)
    if budget is not None:
        np.testing.assert_array_equal(tplan.capacity_evicted.numpy(), np.asarray(jplan.capacity_evicted))
    for name in ("access_counts", "hosts", "live"):
        np.testing.assert_array_equal(getattr(tnew, name).numpy(), np.asarray(getattr(jnew, name)))


@pytest.mark.parametrize("due", [True, False])
def test_masked_step_and_daemon_match_jax(due):
    jstore, tstore = _store(8)
    obj = np.full(300, 1024.0, np.float32)
    budget = 40 * 1024.0
    jd = jplace.PlacementDaemon(5, h=0.2, expiry=3, decay=0.5)
    td = tplace.PlacementDaemon(5, h=0.2, expiry=3, decay=0.5)
    jstats, jnew = jd.masked_step(jstore, 9, jnp.asarray(due), object_bytes=jnp.asarray(obj),
                                  capacity_bytes=jnp.asarray(budget, jnp.float32))
    tstats, tnew = td.masked_step(tstore, 9, due, object_bytes=_t(obj), capacity_bytes=budget)
    for a, b in zip(jstats, tstats):
        assert float(a) == float(b)
    if due:
        assert float(tstats.capacity_evictions) > 0
    for name in ("access_counts", "hosts", "live"):
        np.testing.assert_array_equal(getattr(tnew, name).numpy(), np.asarray(getattr(jnew, name)))
    stats, new = tplace.masked_step(tstore, 9, due, h=0.2, expiry=3, decay=0.5,
                                    object_bytes=_t(obj), capacity_bytes=budget)
    assert [float(x) for x in stats] == [float(x) for x in tstats]


def test_local_hit_and_owner_of_match_jax():
    jstore, tstore = _store(9, k=120, n=4)
    rng = np.random.default_rng(10)
    keys = rng.integers(0, 120, 500).astype(np.int32)
    nodes = rng.integers(0, 4, 500).astype(np.int32)
    np.testing.assert_array_equal(
        tmeta.local_hit(tstore, _t(keys), _t(nodes)).numpy(),
        np.asarray(jmeta.local_hit(jstore, jnp.asarray(keys), jnp.asarray(nodes))))
    got = tmeta.owner_of(tstore, _t(keys))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmeta.owner_of(jstore, jnp.asarray(keys))))


@pytest.mark.parametrize("topo", ["flat", "wan5"])
def test_latency_helpers_match_jax(topo):
    jcfg = jcl.ClusterConfig(transfer_ms_per_kb=0.5) if topo == "flat" else \
        jcl.wan5_cluster(transfer_ms_per_kb=0.5, master=2)
    tcfg = cluster_from_fields(**jcfg._asdict())
    rng = np.random.default_rng(11)
    b, n = 400, jcfg.num_nodes
    replicas = rng.random((b, n)) < 0.4
    replicas[:20] = False  # empty rows: the worst-RTT fetch
    nodes = rng.integers(0, n, b).astype(np.int32)
    sole = rng.random(b) < 0.3
    rtt_j, rtt_t = jcfg.rtt_matrix(), tcfg.rtt_matrix("cpu")
    cases = [
        (jcl.nearest_replica_rtt(rtt_j, jnp.asarray(replicas), jnp.asarray(nodes)),
         tcl.nearest_replica_rtt(rtt_t, _t(replicas), _t(nodes))),
        (jcl.read_latency_geo(jcfg, rtt_j, jnp.asarray(replicas), jnp.asarray(nodes)),
         tcl.read_latency_geo(tcfg, rtt_t, _t(replicas), _t(nodes))),
        (jcl.write_latency_geo(jcfg, rtt_j, jnp.asarray(replicas), jnp.asarray(nodes), jnp.asarray(sole)),
         tcl.write_latency_geo(tcfg, rtt_t, _t(replicas), _t(nodes), _t(sole))),
        (jcl.read_latency(jcfg, jnp.asarray(sole)), tcl.read_latency(tcfg, _t(sole))),
        (jcl.write_latency(jcfg, jnp.asarray(nodes), jnp.asarray(sole), jnp.asarray(replicas[:, 0])),
         tcl.write_latency(tcfg, _t(nodes), _t(sole), _t(replicas[:, 0]))),
    ]
    for i, (a, got) in enumerate(cases):
        assert got.dtype == torch.float32, i
        np.testing.assert_array_equal(got.numpy(), np.asarray(a), err_msg=str(i))


def test_wan5_edge_cluster_and_capacity_vector_match_jax():
    for kw in ({}, dict(edge_capacity_bytes=16384.0, edge_node=1, service_ms=5.0)):
        a, b = jcl.wan5_edge_cluster(**kw), tcl.wan5_edge_cluster(**kw)
        assert a.capacity_bytes == b.capacity_bytes and a.rtt == b.rtt and a.service_ms == b.service_ms
        assert b.has_finite_capacity
        np.testing.assert_array_equal(b.capacity_vector("cpu").numpy(), np.asarray(a.capacity_vector()))
