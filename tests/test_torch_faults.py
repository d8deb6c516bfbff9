"""The port's failure injection (``kvsim/faults.py``, the fault pre-pass of
``kernels/chunk_replay/ref.py``, the sweep's availability stage and the
engines with ``FaultConfig``) on the CPU against the JAX reference.

Unit cases draw chunks, stores and schedules with numpy from a seed and
hand both packages the same arrays. Engine cases replay JAX's trace
(``generate_trace``) of the region-outage scenario of ``tests/test_faults.py``
(wan5, 20,000 requests, 400 keys, interval 100, region 0 down over chunks
[60, 100)) through both packages' ``run_scenario`` and
``run_scenario_reference``; the JAX side runs its materialized scan on the
jax backend.

Bars, each with its reason:

* ``compile_schedule``, ``event_windows``, ``blast_radius_rows``,
  ``normalize_faults`` and their errors — equal arrays, rows and messages
  (the same numpy code);
* ``fault_extra_ms_ref`` in all three read modes, with the master down or
  up and with wiped keys — exact: booleans, and the failover delta formed
  in the reference's op order (``+0.0`` bit for bit with every node up);
* the sweep's availability stage, with and without a budget — exact;
* engine runs: moves, fault and routing counters, hits, histograms and
  every per-chunk fault series exact; the f32 aggregates (throughput, mean
  latency, busy, peak occupancy) to rtol 1e-6;
* the off paths (``faults=None``, ``FaultConfig(enabled=False)``, an empty
  event list) and an all-up schedule — every output bit for bit.
"""

from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.metadata as jmeta  # noqa: E402
import repro.core.policy as jp  # noqa: E402
import repro.kvsim as jk  # noqa: E402
import repro.kvsim.faults as jf  # noqa: E402
import repro_torch.core.policy as tp  # noqa: E402
import repro_torch.kvsim as tk  # noqa: E402
import repro_torch.kvsim.faults as tf  # noqa: E402
from repro.kernels.chunk_replay import ref as jref  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    cluster_from_fields,
    store_from_numpy,
    telemetry_from_fields,
    trace_from_numpy,
)
from repro_torch.kernels.chunk_replay import ref as tref  # noqa: E402


def _warm_exp():
    """PyTorch's CPU ``exp`` can return values off by ~1e-4 on its first
    call in a process (about one process in eight); one call first avoids it."""
    torch.exp(torch.zeros(1))


_warm_exp()


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _result_or_error(fn):
    """``fn()``, or the type and text of the error it raises."""
    try:
        return fn()
    except (ValueError, TypeError) as err:
        return type(err), str(err)


SCHEDULES = [
    # two nodes crash and partition, one until the end
    dict(events=(("node", 1, 3, 4, "crash"), ("node", 2, 8, 0, "partition")), num_nodes=4,
         num_chunks=12),
    # a region by labels, a zone without (the flat fallback), one past the end
    dict(events=(("region", 1, 0, 2, "crash"), ("zone", 4, 5, 3, "partition"),
                 ("node", 0, 50, 1, "crash")), num_nodes=5, num_chunks=10,
         region_of=(0, 0, 1, 1, 2)),
    # overlapping windows on one node: re-crashing is idempotent
    dict(events=(("node", 0, 1, 5, "crash"), ("node", 0, 3, 5, "crash")), num_nodes=3,
         num_chunks=9),
    # every node down at chunk 4
    dict(events=(("node", 0, 2, 3, "crash"), ("node", 1, 4, 3, "crash")), num_nodes=2,
         num_chunks=10),
    # a label that names no node; a labelling of the wrong length
    dict(events=(("zone", 9, 0, 1, "crash"),), num_nodes=3, num_chunks=4, zone_of=(0, 0, 1)),
    dict(events=(("zone", 0, 0, 1, "crash"),), num_nodes=3, num_chunks=4, zone_of=(0, 0)),
    # bad events
    dict(events=(("rack", 0, 0, 1, "crash"),), num_nodes=3, num_chunks=4),
    dict(events=(("node", 0, 0, 1, "flaky"),), num_nodes=3, num_chunks=4),
    dict(events=(("node", -1, 0, 1, "crash"),), num_nodes=3, num_chunks=4),
    dict(events=(("node", 0, -3, 1, "crash"),), num_nodes=3, num_chunks=4),
]


@pytest.mark.parametrize("case", range(len(SCHEDULES)))
def test_compile_schedule_matches_jax(case):
    spec = dict(SCHEDULES[case])
    events = spec.pop("events")
    cfgs = [mod.FaultConfig(events=tuple(mod.FaultEvent(*e) for e in events)) for mod in (jf, tf)]
    want, got = (_result_or_error(lambda c=c, m=m: m.compile_schedule(c, **spec))
                 for c, m in zip(cfgs, (jf, tf)))
    if isinstance(want[0], type):  # the same error
        assert got == want
        return
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == bool
        np.testing.assert_array_equal(g, w)
    nc = spec["num_chunks"]
    assert [(tuple(e), s, t) for e, s, t in tf.event_windows(cfgs[1], nc)] == [
        (tuple(e), s, t) for e, s, t in jf.event_windows(cfgs[0], nc)]
    rng = np.random.default_rng(case)
    unreach, wiped = rng.random(nc), rng.random(nc)
    assert tf.blast_radius_rows(cfgs[1], num_chunks=nc, unreachable_frac=unreach,
                                wiped_frac=wiped) == jf.blast_radius_rows(
        cfgs[0], num_chunks=nc, unreachable_frac=unreach, wiped_frac=wiped)


def test_fault_config_helpers_match_jax():
    assert tk.normalize_faults(None) is None
    assert tk.normalize_faults(tk.FaultConfig(enabled=False)) is None
    assert tk.normalize_faults(tk.FaultConfig(events=())) is None
    on = tk.FaultConfig(events=(tk.FaultEvent(target=1),))
    assert tk.normalize_faults(on) is on
    assert tuple(tk.region_outage(2, 5, 7, mode="partition")) == (
        True, (tk.FaultEvent("region", 2, 5, 7, "partition"),))
    assert tuple(tuple(e) for e in jk.region_outage(2, 5, 7, mode="partition").events) == tuple(
        tuple(e) for e in tk.region_outage(2, 5, 7, mode="partition").events)
    assert (tk.FAULT_KINDS, tk.FAULT_MODES) == (jk.FAULT_KINDS, jk.FAULT_MODES)
    assert tf.default_labels(4) == jf.default_labels(4)
    with pytest.raises(TypeError, match="FaultEvent"):
        tk.FaultConfig(events=("node-0-down",)).validate()
    with pytest.raises(ValueError, match="zone_of labels 2 nodes"):
        tk.run_scenario(tk.WorkloadConfig(num_requests=100), tk.ClusterConfig(zone_of=(0, 1)),
                        tk.RedynisPolicy(), device="cpu")
    blackout = tk.FaultConfig(events=(tk.FaultEvent(target=0, start_chunk=0, duration_chunks=2),
                                      tk.FaultEvent(target=1, start_chunk=0, duration_chunks=2)))
    with pytest.raises(ValueError, match="no node available at chunk 0"):
        tk.run_scenario(tk.WorkloadConfig(num_requests=100, num_nodes=2),
                        tk.ClusterConfig(num_nodes=2, faults=blackout), tk.RedynisPolicy(),
                        daemon_interval=10, device="cpu")


def _fault_chunk(seed, b=3_000, k=300, n=5):
    rng = np.random.default_rng(seed)
    hosts = rng.random((k, n)) < 0.4
    hosts[rng.random(k) < 0.05] = False
    return dict(hosts=hosts, keys=rng.integers(0, k, b).astype(np.int32),
                nodes=rng.integers(0, n, b).astype(np.int32), is_read=rng.random(b) < 0.6,
                valid=rng.random(b) < 0.9), rng.random(k) < 0.05


@pytest.mark.parametrize("wiped", [False, True], ids=["none_wiped", "wiped"])
@pytest.mark.parametrize("avail", ["master_down", "master_up", "all_up"])
@pytest.mark.parametrize("read_mode", ["map", "no_local", "ideal"])
def test_fault_prepass_matches_jax(read_mode, avail, wiped):
    chunk, wiped_keys = _fault_chunk({"map": 1, "no_local": 2, "ideal": 3}[read_mode])
    live = {"master_down": [False, True, False, True, True], "master_up": [True, False, True, False, True],
            "all_up": [True] * 5}[avail]
    rtt = np.asarray(jk.wan5_cluster(transfer_ms_per_kb=0.5).rtt_matrix())
    args = [chunk[name] for name in ("hosts", "keys", "nodes", "is_read", "valid")] + [np.array(live), rtt]
    kw = dict(read_mode=read_mode, master=0, xfer_write_ms=0.5078125)
    want = jref.fault_extra_ms_ref(*(jnp.asarray(a) for a in args), **kw,
                                   wiped=jnp.asarray(wiped_keys) if wiped else None)
    got = tref.fault_extra_ms_ref(*(_t(a) for a in args), **kw,
                                  wiped=_t(wiped_keys) if wiped else None)
    for name, g, w in zip(("extra", "unavailable", "failover"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    extra = got[0].numpy()
    if avail == "master_down" and read_mode != "ideal":
        assert got[2].any() and (extra < 0).any()  # stand-ins nearer than the master
    if avail == "all_up":  # x - x: every delta +0.0, sign bit clear
        assert not extra.view(np.uint32).any()
        assert got[1].any() == (wiped and read_mode != "ideal") and not got[2].any()


@pytest.mark.parametrize("budget", [None, 24 * 1024.0], ids=["no_budget", "budget"])
@pytest.mark.parametrize("spec", ["redynis:h=0.2,expiry=3", "costgreedy"])
def test_policy_sweep_availability_stage_matches_jax(spec, budget):
    """Down nodes lose their copies and take no new ones, before the
    capacity projection."""
    rng = np.random.default_rng(11)
    k, n = 300, 5
    counts = rng.integers(0, 4, (k, n)).astype(np.int32)
    arrays = (counts, rng.random((k, n)) < 0.4, rng.integers(0, 10, k).astype(np.int32),
              rng.random(k) < 0.95, np.zeros(k, np.int32))
    rtt = np.asarray(jk.wan5_cluster().rtt_matrix())
    obj = rng.choice([512.0, 1024.0, 2048.0, 8192.0], k).astype(np.float32)
    avail = np.array([True, False, True, True, False])
    jstatic, jparams = jp.split_policy(jp.parse_policy(spec).resolve(n))
    tstatic, tparams = tp.split_policy(tp.parse_policy(spec).resolve(n))
    jctx = jp.PolicyContext(jnp.asarray(rtt), jnp.asarray(obj),
                            None if budget is None else jnp.full((n,), budget, jnp.float32), jparams,
                            avail=jnp.asarray(avail))
    tctx = tp.PolicyContext(_t(rtt), _t(obj), None if budget is None else torch.full((n,), budget),
                            tparams, avail=_t(avail))
    jstore = jmeta.MetadataStore(*(jnp.asarray(a) for a in arrays))
    jplan, _, jnew = jp.policy_sweep(jstatic, jstatic.init(jstore, jctx), jstore, 9, jctx)
    tstore = store_from_numpy(*arrays, device="cpu")
    tplan, _, tnew = tp.policy_sweep(tstatic, tstatic.init(tstore, tctx), tstore, 9, tctx)
    for name in ("owners", "to_add", "to_drop", "expired"):
        np.testing.assert_array_equal(getattr(tplan, name).numpy(), np.asarray(getattr(jplan, name)),
                                      err_msg=name)
    if budget is not None:
        np.testing.assert_array_equal(tplan.capacity_evicted.numpy(), np.asarray(jplan.capacity_evicted))
    np.testing.assert_array_equal(tnew.hosts.numpy(), np.asarray(jnew.hosts))
    assert not tplan.owners[:, ~_t(avail)].any() and tplan.to_drop[:, ~_t(avail)].any()


def test_publish_mask_matches_jax():
    rng = np.random.default_rng(12)
    old = rng.random((200, 5)) < 0.4
    new = old ^ (rng.random((200, 5)) < 0.02)
    np.testing.assert_array_equal(tp.publish_mask(_t(old), _t(new)).numpy(),
                                  np.asarray(jp.publish_mask(jnp.asarray(old), jnp.asarray(new))))


# ---------------------------------------------------------------------------
# Engines: the region-outage scenario of tests/test_faults.py.
# ---------------------------------------------------------------------------

INTERVAL = 100
OUTAGE = (0, 60, 40)  # region 0 (node 0 of wan5), chunks [60, 100)
WORKLOAD = dict(num_requests=20_000, num_keys=400, affinity=0.8, read_fraction=0.7)
# (workload, fault mode, routing, policy)
ENGINE_CASES = {
    "crash_redynis": ("wan5", "crash", None, "redynis"),
    "crash_replicated": ("wan5", "crash", None, "replicated"),
    "crash_remote": ("wan5", "crash", None, "remote"),
    "partition_redynis": ("wan5", "partition", None, "redynis"),
    "partition_replicated": ("wan5", "partition", None, "replicated"),
    "partition_remote": ("wan5", "partition", None, "remote"),
    # both tiers: the directory home inside the crashed region freezes the
    # publish ring while it is down
    "crash_routing_redynis": ("diurnal", "crash", (8, 50, 0.9, 0), "redynis"),
}
EXACT = ("replication_moves", "deletion_moves", "evictions", "capacity_evictions", "hit_rate",
         "router_consults", "directory_fetches", "mis_routes", "stale_consults",
         "unavailable_reads", "unavailable_writes", "failovers", "repair_moves")
CLOSE = ("throughput_ops_s", "mean_latency_ms", "node_busy_ms", "peak_occupancy_bytes")
SERIES = ("hist_group", "chunk_hist", "hit_rate", "requests", "moves", "unavailable_reads",
          "unavailable_writes", "failovers", "repair_moves", "unreachable_frac", "wiped_frac",
          "availability", "effective_hit_rate", "occupancy_bytes", "router_consults",
          "mis_routes", "stale_consults", "stale_age_hist")


def _jax_workload(case):
    make = jk.wan5_workload if ENGINE_CASES[case][0] == "wan5" else jk.diurnal_workload
    return make(**WORKLOAD)


def _jax_cluster(case):
    _, mode, routing, _ = ENGINE_CASES[case]
    cl = jk.wan5_cluster()._replace(faults=jk.region_outage(*OUTAGE, mode=mode))
    if routing is not None:
        lag, entries, decay, home = routing
        cl = cl._replace(routing=jk.RoutingConfig(publish_lag_chunks=lag, cache_entries=entries,
                                                  decay=decay, home_node=home))
    return cl


@lru_cache(maxsize=None)
def _jax_run(case, engine):
    run = jk.run_scenario if engine == "scan" else jk.run_scenario_reference
    return run(_jax_workload(case), _jax_cluster(case), jk.parse_policy(ENGINE_CASES[case][3]), seed=0,
               daemon_interval=INTERVAL, telemetry=jk.TelemetryConfig())


@lru_cache(maxsize=None)
def _trace(case):
    return trace_from_numpy(*(np.asarray(a) for a in jk.generate_trace(_jax_workload(case), 0)),
                            device="cpu")


def _port_run(case, engine, cluster=None, policy=None, telemetry=True):
    cluster = cluster_from_fields(**_jax_cluster(case)._asdict()) if cluster is None else cluster
    run = tk.run_scenario if engine == "scan" else tk.run_scenario_reference
    return run(tk.WorkloadConfig(**_jax_workload(case)._asdict()), cluster,
               tk.parse_policy(policy or ENGINE_CASES[case][3]), daemon_interval=INTERVAL,
               device="cpu", trace=_trace(case),
               telemetry=telemetry_from_fields(**jk.TelemetryConfig()._asdict()) if telemetry else None)


def assert_runs_match(ours, ref, ctx):
    (a, ta), (b, tb) = ours, ref
    for name in EXACT:
        assert getattr(a, name) == getattr(b, name), (ctx, name, getattr(a, name), getattr(b, name))
    for name in CLOSE:
        np.testing.assert_allclose(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
                                   rtol=1e-6, err_msg=f"{ctx} {name}")
    for name in SERIES:
        np.testing.assert_array_equal(np.asarray(getattr(ta, name)), np.asarray(getattr(tb, name)),
                                      err_msg=f"{ctx} {name}")


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_run_scenario_matches_jax_with_faults(case):
    ours = _port_run(case, "scan")
    assert_runs_match(ours, _jax_run(case, "scan"), case)
    res, trace = ours
    assert res.unavailable_reads > 0 and res.unavailable_writes > 0
    lo, hi = OUTAGE[1], OUTAGE[1] + OUTAGE[2]
    assert trace.availability[lo:hi].max() < 1.0 and (trace.availability[:lo] == 1.0).all()
    _, mode, _, policy = ENGINE_CASES[case]
    if policy != "redynis":  # a static policy never re-seeds
        assert res.repair_moves == 0 and res.replication_moves == 0
    if policy == "replicated":  # a copy on every node survives, and stays reachable
        assert not trace.wiped_frac.any() and not trace.unreachable_frac.any()
    elif mode == "partition":  # loss-free: nothing wiped, sole copies cut off while it lasts
        assert not trace.wiped_frac.any() and trace.unreachable_frac[lo:hi].max() > 0
    else:  # the crash destroys sole copies; Redynis re-seeds them
        assert trace.wiped_frac[lo] > 0 and (res.repair_moves > 0) == (policy == "redynis")
    if ENGINE_CASES[case][2] is not None:
        assert res.mis_routes > 0 and res.directory_fetches > 0


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_run_scenario_reference_matches_jax_with_faults(case):
    """The float64 oracles, the publish ring (frozen while the home node is
    down) on both sides."""
    ours = _port_run(case, "reference")
    want = _jax_run(case, "reference")
    assert_runs_match(ours, want, case)
    np.testing.assert_array_equal(ours[1].raw_latency_ms, want[1].raw_latency_ms)
    scan = _port_run(case, "scan")
    for name in EXACT[:4] + EXACT[5:]:
        assert getattr(ours[0], name) == getattr(scan[0], name), name


def _assert_identical(a, b, ctx):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), (ctx, name)
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"{ctx} {name}")


@pytest.mark.parametrize("engine", ["scan", "reference"])
def test_fault_off_paths_and_an_all_up_schedule_are_the_engine_without_faults(engine):
    """``faults=None``, ``FaultConfig(enabled=False)`` and an empty event
    list are one program; a schedule whose only event lies past the trace
    keeps the fault path on (every node up, nothing wiped) and gives the
    same results, bit for bit: the failover delta is ``x - x``."""
    off = tk.wan5_cluster()
    allup = tk.FaultConfig(events=(tk.FaultEvent(kind="node", target=1, start_chunk=10**6),))
    for policy in ("redynis", "remote"):
        base = _port_run("crash_redynis", engine, cluster=off, policy=policy)
        for faults in (tk.FaultConfig(enabled=False), tk.FaultConfig(), allup):
            got = _port_run("crash_redynis", engine, cluster=off._replace(faults=faults), policy=policy)
            _assert_identical(base[0], got[0], f"{engine} {policy} {faults}")
            if faults is not allup:
                _assert_identical(base[1], got[1], f"{engine} {policy} {faults}")
            else:  # the chunk loop also fills the (zero) fault series
                for name in ("hist_group", "chunk_hist", "mean_latency_ms", "availability"):
                    np.testing.assert_array_equal(getattr(base[1], name), getattr(got[1], name))
                assert not got[1].unavailable_reads.any() and (got[1].availability == 1.0).all()
        assert base[0].unavailable_reads == 0 and base[0].repair_moves == 0


def test_run_experiment_with_faults_matches_per_seed_run_scenario():
    cluster = tk.wan5_cluster()._replace(faults=tk.region_outage(0, 6, 4))
    kw = dict(num_requests=4_000, num_keys=200, affinity=0.8)
    out = tk.run_experiment(read_fractions=(0.7,), iterations=2, cluster=cluster, daemon_interval=200,
                            policies=[tk.RedynisPolicy(), tk.StaticPolicy("replicated")],
                            device="cpu", region_weights=(0.35, 0.25, 0.20, 0.12, 0.08), **kw)
    for label, (row,) in out["policies"].items():
        pol = tk.RedynisPolicy() if label.startswith("redynis") else tk.StaticPolicy("replicated")
        wl = tk.WorkloadConfig(read_fraction=0.7, num_nodes=5,
                               region_weights=(0.35, 0.25, 0.20, 0.12, 0.08), **kw)
        for seed, got in enumerate(row["results"]):
            want = tk.run_scenario(wl, cluster, pol, seed=seed, daemon_interval=200, device="cpu",
                                   trace=tk.generate_trace(wl, seed, device="cpu"))
            _assert_identical(got, want, f"{label} seed {seed}")
            assert got.unavailable_reads > 0
