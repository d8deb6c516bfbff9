"""The port's routing tier (``kvsim/routing.py``, the routing pre-pass of
``kernels/chunk_replay/ref.py`` and the engines with ``RoutingConfig``) on
the CPU against the JAX reference.

Unit cases draw router states and chunks with numpy from a seed and hand
both packages the same arrays. Engine cases replay JAX's trace
(``generate_trace``) through both packages' ``run_scenario`` and
``run_scenario_reference``; the JAX side runs its materialized scan on the
jax backend.

Bars, each with its reason:

* ``consult_probe``, ``published_view``, ``publish_commit``,
  ``stale_age_fold``, ``router_of`` and the routing pre-pass (all three read
  modes) — exact: integer and boolean state, and f32 surcharges formed in
  the reference's op order;
* ``router_cache_update`` — exact against the jitted JAX function, the
  form its engine runs: XLA contracts ``score * decay + counts`` into one
  fused multiply-add, which the port writes out (an f64 product and sum
  rounded once). The eager JAX function rounds twice; at decay 0.9 its
  scores differ from the port's in some entries, pinned below;
* engine runs: moves, routing counters, hits, histograms and every
  per-chunk routing series exact; the f32 aggregates (throughput, mean
  latency, busy, peak occupancy) to rtol 1e-6;
* the off path (``routing=None`` and ``RoutingConfig(enabled=False)``) —
  every output bit for bit.
"""

from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.kvsim as jk  # noqa: E402
import repro.kvsim.routing as jr  # noqa: E402
import repro_torch.kvsim as tk  # noqa: E402
import repro_torch.kvsim.routing as tr  # noqa: E402
from repro.kernels.chunk_replay import ref as jref  # noqa: E402
from repro_torch.kernels.chunk_replay import ref as tref  # noqa: E402
from repro_torch.interop import cluster_from_fields, telemetry_from_fields, trace_from_numpy  # noqa: E402


def _warm_exp():
    """PyTorch's CPU ``exp`` can return values off by ~1e-4 on its first
    call in a process (about one process in eight); one call first avoids it."""
    torch.exp(torch.zeros(1))


_warm_exp()

R, K, N = 5, 300, 5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _state(seed, *, bounded, active, ring_slots=0):
    """One router state as numpy arrays (``None`` where the reference's is)."""
    rng = np.random.default_rng(seed)
    ver = rng.integers(0, 6, K).astype(np.int32) if active else None
    return dict(
        cached=(rng.random((R, K)) < 0.6) if bounded else None,
        cached_ver=rng.integers(0, 6, (R, K)).astype(np.int32),
        score=rng.integers(0, 6, (R, K)).astype(np.float32) if bounded else None,
        ver=ver,
        ring_hosts=(rng.random((ring_slots, K, N)) < 0.4) if ring_slots else None,
        ring_ver=rng.integers(0, 6, (ring_slots, K)).astype(np.int32) if ring_slots else None,
    )


def _both(state):
    j = jr.RouterState(**{k: None if v is None else jnp.asarray(v) for k, v in state.items()})
    t = tr.RouterState(**{k: None if v is None else _t(v) for k, v in state.items()})
    return j, t


def _assert_state_equal(t, j, ctx=""):
    for name in tr.RouterState._fields:
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), (ctx, name)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{ctx} {name}")


def _chunk(seed, b=2_000):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, R, b).astype(np.int32), rng.integers(0, K, b).astype(np.int32),
            rng.random(b) < 0.6)


@pytest.mark.parametrize("bounded", [False, True], ids=["unbounded", "bounded"])
@pytest.mark.parametrize("active", [False, True], ids=["inactive", "active"])
def test_consult_probe_matches_jax(bounded, active):
    j, t = _both(_state(0, bounded=bounded, active=active))
    rb, ck, _ = _chunk(1)
    got = tr.consult_probe(t, _t(rb), _t(ck))
    want = jr.consult_probe(j, jnp.asarray(rb), jnp.asarray(ck))
    for name, g, w in zip(("cached", "fresh", "age"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[2].dtype == torch.int32


@pytest.mark.parametrize("daemon_up", [None, True, False], ids=["no_faults", "up", "down"])
@pytest.mark.parametrize("lag", [0, 1, 5])
def test_published_view_and_publish_commit_match_jax(lag, daemon_up):
    """Eight chunks of commits through the ring (forced at lag 0): the view
    read each chunk and the state after each commit, exact."""
    rng = np.random.default_rng(lag)
    hosts0 = rng.random((K, N)) < 0.4
    kw = dict(num_routers=R, cache_entries=0, publish_lag_chunks=lag, active=True,
              force_ring=daemon_up is not None)
    j = jr.init_router_state(jnp.asarray(hosts0), **kw)
    t = tr.init_router_state(_t(hosts0), **kw)
    _assert_state_equal(t, j, "init")
    hosts = hosts0
    for c in range(8):
        jv = jr.published_view(j, jnp.asarray(hosts), jnp.int32(c), publish_lag_chunks=lag)
        tv = tr.published_view(t, _t(hosts), c, publish_lag_chunks=lag)
        for g, w in zip(tv, jv):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"view chunk {c}")
        new = hosts ^ (rng.random((K, N)) < 0.05)
        changed = (new != hosts).any(axis=1)
        up = None if daemon_up is None else (daemon_up or c % 3 == 0)  # "down": down 2 of 3 chunks
        j = jr.publish_commit(j, jnp.asarray(changed), jnp.asarray(new), jnp.int32(c),
                              publish_lag_chunks=lag,
                              daemon_up=None if up is None else jnp.asarray(up))
        t = tr.publish_commit(t, _t(changed), _t(new), c, publish_lag_chunks=lag, daemon_up=up)
        _assert_state_equal(t, j, f"commit chunk {c}")
        hosts = new


def test_inactive_policy_never_publishes():
    hosts = np.random.default_rng(0).random((K, N)) < 0.4
    t = tr.init_router_state(_t(hosts), num_routers=R, cache_entries=0, publish_lag_chunks=3,
                             active=False)
    assert t.ver is None and t.ring_hosts is None
    view, ver = tr.published_view(t, _t(hosts), 7, publish_lag_chunks=3)
    assert torch.equal(view, _t(hosts)) and not ver.any() and ver.dtype == torch.int32
    assert tr.publish_commit(t, torch.ones(K, dtype=torch.bool), _t(hosts), 7,
                             publish_lag_chunks=3) is t


def test_stale_age_fold_and_router_of_match_jax():
    rng = np.random.default_rng(4)
    age = rng.integers(0, 40, 3_000).astype(np.int32)
    stale = rng.random(3_000) < 0.5
    np.testing.assert_array_equal(tr.stale_age_fold(_t(age), _t(stale)).numpy(),
                                  np.asarray(jr.stale_age_fold(jnp.asarray(age), jnp.asarray(stale))))
    nodes = rng.integers(0, N, 100).astype(np.int32)
    for r in (1, 2, 5):
        np.testing.assert_array_equal(tr.router_of(_t(nodes), r).numpy(),
                                      np.asarray(jr.router_of(jnp.asarray(nodes), r)))


def _cache_update_both(state, rb, ck, consult, pub_ver, *, cache_entries, decay, jit):
    j, t = _both(state)
    fn = jr.router_cache_update
    if jit:
        fn = jax.jit(fn, static_argnames=("cache_entries", "decay", "axis_name"))
    want = fn(j, jnp.asarray(rb), jnp.asarray(ck), jnp.asarray(consult), jnp.asarray(pub_ver),
              cache_entries=cache_entries, decay=decay)
    got = tr.router_cache_update(t, _t(rb), _t(ck), _t(consult), _t(pub_ver),
                                 cache_entries=cache_entries, decay=decay)
    return got, want


@pytest.mark.parametrize("decay", [1.0, 0.9])
@pytest.mark.parametrize("cache_entries", [0, 40], ids=["unbounded", "bounded"])
def test_router_cache_update_matches_jitted_jax(cache_entries, decay):
    """Several chunks of consults from scores of six values, so that the
    admission threshold falls on ties."""
    rng = np.random.default_rng(5)
    state = _state(6, bounded=cache_entries > 0, active=True)
    ties = 0
    for c in range(6):
        rb, ck, consult = _chunk(10 + c)
        pub_ver = rng.integers(0, 8, K).astype(np.int32)
        got, want = _cache_update_both(state, rb, ck, consult, pub_ver, cache_entries=cache_entries,
                                       decay=decay, jit=True)
        _assert_state_equal(got, want, f"chunk {c}")
        if cache_entries:
            score = got.score
            kth = torch.sort(score, dim=1, descending=True).values[:, cache_entries - 1]
            ties += int(((score == kth[:, None]).sum(dim=1) > 1).sum())
        state = {k: None if v is None else v.numpy() for k, v in got._asdict().items()}
    assert ties > 0 or not cache_entries, "no router had a tie at its threshold"


def test_router_cache_update_rounding_against_eager_jax():
    """The eager reference rounds ``score * decay`` and ``+ counts`` apart:
    at decay 0.9 its scores differ from the jitted form (and the port) in
    some entries; at decay 1.0 (an exact product) they agree."""
    state = _state(7, bounded=True, active=True)
    state["score"] = np.random.default_rng(8).random((R, K)).astype(np.float32) * 50
    rb, ck, consult = _chunk(9)
    pub_ver = np.zeros(K, np.int32)
    for decay, differ in ((1.0, False), (0.9, True)):
        kw = dict(cache_entries=40, decay=decay)
        got, eager = _cache_update_both(state, rb, ck, consult, pub_ver, jit=False, **kw)
        _, jitted = _cache_update_both(state, rb, ck, consult, pub_ver, jit=True, **kw)
        np.testing.assert_array_equal(got.score.numpy(), np.asarray(jitted.score))
        n_diff = int((got.score.numpy() != np.asarray(eager.score)).sum())
        assert (n_diff > 0) == differ, (decay, n_diff)
        if differ:  # each by one ulp, and a two-rounding result
            a, b = got.score.numpy(), np.asarray(eager.score)
            ulps = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
            assert ulps.max() == 1
            counts = np.zeros((R, K), np.float32)
            np.add.at(counts, (rb, ck), consult.astype(np.float32))
            two = (state["score"] * np.float32(decay)).astype(np.float32) + counts
            np.testing.assert_array_equal(b, two)


@pytest.mark.parametrize("read_mode", ["map", "no_local", "ideal"])
def test_routing_prepass_matches_jax(read_mode):
    rng = np.random.default_rng({"map": 1, "no_local": 2, "ideal": 3}[read_mode])
    b, k = 4_000, 500
    hosts = rng.random((k, N)) < 0.4
    hosts[rng.random(k) < 0.1] = False
    pub = hosts ^ (rng.random((k, N)) < 0.2)
    cached, fresh = rng.random(b) < 0.7, rng.random(b) < 0.5
    keys = rng.integers(0, k, b).astype(np.int32)
    nodes = rng.integers(0, N, b).astype(np.int32)
    is_read, valid = rng.random(b) < 0.7, rng.random(b) < 0.9
    rtt = np.asarray(jk.wan5_cluster().rtt_matrix())
    args = (hosts, pub, cached, fresh, keys, nodes, is_read, valid, rtt)
    kw = dict(read_mode=read_mode, home_node=3)
    want = jref.routing_extra_split_ref(*(jnp.asarray(a) for a in args), **kw)
    got = tref.routing_extra_split_ref(*(_t(a) for a in args), **kw)
    for name, g, w in zip(("detour", "fetch", "consult", "fetches", "stale", "mis"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{read_mode} {name}")
        assert g.dtype == (torch.float32 if name in ("detour", "fetch") else torch.bool)
    combined = tref.routing_extra_ms_ref(*(_t(a) for a in args), **kw)
    jcombined = jref.routing_extra_ms_ref(*(jnp.asarray(a) for a in args), **kw)
    for g, w in zip(combined, jcombined):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if read_mode != "ideal":
        assert got[5].any() and got[3].any() and got[4].any()


def test_routing_config_validation_matches_jax():
    assert tk.normalize_routing(None) is None
    assert tk.normalize_routing(tk.RoutingConfig(enabled=False)) is None
    assert tk.normalize_routing(tk.RoutingConfig()) == tk.RoutingConfig()
    for bad in (dict(num_routers=-1), dict(cache_entries=-1), dict(publish_lag_chunks=-1),
                dict(home_node=-1), dict(decay=0.0), dict(decay=1.5)):
        with pytest.raises(ValueError) as want:
            jk.RoutingConfig(**bad).validate()
        with pytest.raises(ValueError) as got:
            tk.RoutingConfig(**bad).validate()
        assert str(got.value) == str(want.value)
    wl = tk.WorkloadConfig(num_requests=100)
    for bad, what in ((dict(home_node=7), "home_node"), (dict(num_routers=9), "num_routers")):
        with pytest.raises(ValueError, match=what):
            tk.run_scenario(wl, tk.ClusterConfig(routing=tk.RoutingConfig(**bad)), tk.RedynisPolicy(),
                            device="cpu")


# ---------------------------------------------------------------------------
# Engines: the diurnal wan5 staleness scenario of tests/test_routing.py.
# ---------------------------------------------------------------------------

INTERVAL = 100
WORKLOAD = dict(num_requests=20_000, num_keys=400, affinity=0.8, read_fraction=0.7)
# (lag, cache entries, decay, home node, policy)
ENGINE_CASES = {
    "lag8_bounded": (8, 50, 0.9, 2, "redynis"),
    "lag0_unbounded": (0, 0, 1.0, 0, "redynis"),
    "bounded_static": (8, 50, 0.9, 2, "remote"),
}
EXACT = ("replication_moves", "deletion_moves", "evictions", "capacity_evictions", "hit_rate",
         "router_consults", "directory_fetches", "mis_routes", "stale_consults",
         "unavailable_reads", "unavailable_writes", "failovers", "repair_moves")
CLOSE = ("throughput_ops_s", "mean_latency_ms", "node_busy_ms", "peak_occupancy_bytes")
SERIES = ("hist_group", "chunk_hist", "hit_rate", "requests", "moves", "router_consults",
          "directory_fetches", "mis_routes", "stale_consults", "stale_age_hist", "mis_route_rate")


def _jax_cluster(case):
    lag, entries, decay, home, _ = ENGINE_CASES[case]
    return jk.wan5_cluster()._replace(routing=jk.RoutingConfig(
        publish_lag_chunks=lag, cache_entries=entries, decay=decay, home_node=home))


@lru_cache(maxsize=None)
def _jax_run(case, engine):
    jwl = jk.diurnal_workload(**WORKLOAD)
    run = jk.run_scenario if engine == "scan" else jk.run_scenario_reference
    return run(jwl, _jax_cluster(case), jk.parse_policy(ENGINE_CASES[case][4]), seed=0,
               daemon_interval=INTERVAL, telemetry=jk.TelemetryConfig())


def _port_run(case, engine, cluster=None):
    jwl = jk.diurnal_workload(**WORKLOAD)
    trace = trace_from_numpy(*(np.asarray(a) for a in jk.generate_trace(jwl, 0)), device="cpu")
    cluster = cluster_from_fields(**_jax_cluster(case)._asdict()) if cluster is None else cluster
    run = tk.run_scenario if engine == "scan" else tk.run_scenario_reference
    return run(tk.WorkloadConfig(**jwl._asdict()), cluster, tk.parse_policy(ENGINE_CASES[case][4]),
               daemon_interval=INTERVAL, device="cpu", trace=trace,
               telemetry=telemetry_from_fields(**jk.TelemetryConfig()._asdict()))


def assert_runs_match(ours, ref, ctx, series=SERIES):
    (a, ta), (b, tb) = ours, ref
    for name in EXACT:
        assert getattr(a, name) == getattr(b, name), (ctx, name, getattr(a, name), getattr(b, name))
    for name in CLOSE:
        np.testing.assert_allclose(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
                                   rtol=1e-6, err_msg=f"{ctx} {name}")
    for name in series:
        np.testing.assert_array_equal(np.asarray(getattr(ta, name)), np.asarray(getattr(tb, name)),
                                      err_msg=f"{ctx} {name}")


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_run_scenario_matches_jax_with_routing(case):
    ours = _port_run(case, "scan")
    assert_runs_match(ours, _jax_run(case, "scan"), case)
    res = ours[0]
    assert res.router_consults > 0 and res.directory_fetches >= 0
    if case == "lag8_bounded":
        assert res.mis_routes > 0 and res.directory_fetches > 0 and res.stale_consults > 0
    if case == "lag0_unbounded":  # a warm cache never misses; an unlagged view never detours
        assert res.mis_routes == 0 and res.directory_fetches == 0 and res.stale_consults > 0


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_run_scenario_reference_matches_jax_with_routing(case):
    """The reference engines: the history of chunk-start snapshots, a
    float64 oracle on both sides."""
    ours = _port_run(case, "reference")
    assert_runs_match(ours, _jax_run(case, "reference"), case)
    np.testing.assert_array_equal(ours[1].raw_latency_ms, _jax_run(case, "reference")[1].raw_latency_ms)
    scan = _port_run(case, "scan")
    for name in EXACT[:4] + EXACT[5:]:
        assert getattr(ours[0], name) == getattr(scan[0], name), name


def test_routing_off_is_the_engine_without_the_tier():
    """``routing=None`` and ``RoutingConfig(enabled=False)``: every output
    bit for bit, both engines, and the routing series zero; a lag-0 warm
    cache prices every consult at +0.0, so only its counters differ."""
    off = tk.wan5_cluster()
    for engine in ("scan", "reference"):
        a, ta = _port_run("lag8_bounded", engine, cluster=off)
        b, tb = _port_run("lag8_bounded", engine, cluster=off._replace(
            routing=tk.RoutingConfig(enabled=False)))
        for name in tk.SimResult._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
                                          err_msg=f"{engine} {name}")
        for name in ta._fields:
            x, y = getattr(ta, name), getattr(tb, name)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
        assert a.router_consults == 0 and not ta.router_consults.any()
        warm, tw = _port_run("lag0_unbounded", engine)
        for name in ("throughput_ops_s", "mean_latency_ms", "hit_rate", "replication_moves"):
            assert getattr(warm, name) == getattr(a, name), (engine, name)
        np.testing.assert_array_equal(tw.hist_group, ta.hist_group)
        assert warm.router_consults > 0
