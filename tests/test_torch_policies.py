"""The port's six placement policies, the shared policy engine and the
registry, on the CPU against the JAX reference.

Sweeps run both packages on one metadata store made with numpy from a
seed; engine runs replay the JAX trace (``generate_trace``) through both
``run_scenario``s. The JAX side of a sweep is ``policy_sweep``, the jitted
form its engine runs: XLA contracts ``DecayLFUPolicy``'s
``ema * alpha + delta`` into one fused multiply-add there (the eager
``_policy_sweep`` rounds twice), and the port writes that fused form out.

Bars, each with its reason:

* owners, adds, drops, expired, capacity evictions, the swept store and
  ``f`` — exact: the same integer counts, f32 expressions in the
  reference's op order, first-index argmaxes and stable ranks;
* ``DecayLFUPolicy``'s EMA state — exact over several sweeps (above);
* labels and errors — equal strings;
* engine runs: replication, deletion, expiry and capacity moves and the
  hit rate exact; throughput, mean latency, node busy and peak occupancy
  to rtol 1e-5 (re-associated f32 sums).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.metadata as jmeta  # noqa: E402
import repro.core.policy as jp  # noqa: E402
import repro.kvsim as jk  # noqa: E402
import repro_torch.core.policy as tp  # noqa: E402
from repro_torch.interop import cluster_from_fields, store_from_numpy, trace_from_numpy  # noqa: E402
from repro_torch.kvsim import WorkloadConfig, run_scenario  # noqa: E402


def _warm_exp():
    """PyTorch's CPU ``exp`` can return values off by ~1e-4 on its first
    call in a process (about one process in eight); one call first avoids it."""
    torch.exp(torch.zeros(1))


_warm_exp()

# One spec per policy family, with knobs that make each bite on a small store.
SWEEP_SPECS = [
    "redynis:h=0.2,expiry=3,decay=0.5",
    "static:mode=replicated",
    "topk:k=40,decay=0.75",
    "costgreedy:min_saved_ms_per_kib=150",
    "decaylfu:h=0.2,alpha=0.3",
    "sizeaware:size_threshold_bytes=1024,large_fanout=2",
]
# benchmarks/policy_matrix.py's eight specs, and the sixth family.
MATRIX_SPECS = [
    "local", "remote", "replicated", "redynis", "redynis:h=0.05,decay=0.9",
    "topk:k=100", "costgreedy", "decaylfu:alpha=0.5", "sizeaware",
]


def _store(seed, k=300, n=5):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 4, (k, n)).astype(np.int32)  # many f == H ties
    counts[rng.random(k) < 0.2] = 0
    hosts = rng.random((k, n)) < 0.4
    hosts[rng.random(k) < 0.05] = False  # keys with no replica
    last = rng.integers(0, 10, k).astype(np.int32)
    live = rng.random(k) < 0.95
    home = np.zeros(k, np.int32)
    return counts, hosts, last, live, home


def _contexts(seed, k, n, budget):
    rng = np.random.default_rng(seed)
    rtt = np.array((jk.wan5_cluster() if n == 5 else jk.ClusterConfig()).rtt_matrix())
    obj = rng.choice([512.0, 1024.0, 2048.0, 8192.0], k).astype(np.float32)
    cap_j = None if budget is None else jnp.asarray(budget, jnp.float32)
    cap_t = None if budget is None else torch.tensor(budget, dtype=torch.float32).expand(n)
    return (rtt, obj, cap_j, cap_t)


def _sweep_both(spec, arrays, ctxs, state_j=None, state_t=None, now=9):
    rtt, obj, cap_j, cap_t = ctxs
    jpol, tpol = jp.parse_policy(spec), tp.parse_policy(spec)
    n = arrays[0].shape[1]
    jpol, tpol = jpol.resolve(n), tpol.resolve(n)
    jstatic, jparams = jp.split_policy(jpol)
    tstatic, tparams = tp.split_policy(tpol)
    jstore = jmeta.MetadataStore(*(jnp.asarray(a) for a in arrays))
    tstore = store_from_numpy(*arrays, device="cpu")
    jctx = jp.PolicyContext(rtt=jnp.asarray(rtt), object_bytes=jnp.asarray(obj),
                            capacity_bytes=cap_j, params=jparams)
    tctx = tp.PolicyContext(rtt=torch.from_numpy(rtt), object_bytes=torch.from_numpy(obj),
                            capacity_bytes=cap_t, params=tparams)
    if state_j is None:
        state_j, state_t = jstatic.init(jstore, jctx), tstatic.init(tstore, tctx)
    jplan, jstate, jnew = jp.policy_sweep(jstatic, state_j, jstore, now, jctx)
    tplan, tstate, tnew = tp.policy_sweep(tstatic, state_t, tstore, now, tctx)
    return (jplan, jstate, jnew), (tplan, tstate, tnew)


@pytest.mark.parametrize("budget", [None, 24 * 1024.0], ids=["no_budget", "budget"])
@pytest.mark.parametrize("spec", SWEEP_SPECS)
def test_policy_sweep_matches_jax(spec, budget):
    arrays = _store(1)
    (jplan, _, jnew), (tplan, _, tnew) = _sweep_both(spec, arrays, _contexts(2, 300, 5, budget))
    for name in ("owners", "to_add", "to_drop", "expired", "f"):
        np.testing.assert_array_equal(getattr(tplan, name).numpy(), np.asarray(getattr(jplan, name)),
                                      err_msg=f"{spec} {name}")
    if budget is None:
        assert tplan.capacity_evicted is None and not np.asarray(jplan.capacity_evicted).any()
    else:
        np.testing.assert_array_equal(tplan.capacity_evicted.numpy(),
                                      np.asarray(jplan.capacity_evicted), err_msg=spec)
    for name in ("access_counts", "hosts", "live"):
        np.testing.assert_array_equal(getattr(tnew, name).numpy(), np.asarray(getattr(jnew, name)),
                                      err_msg=f"{spec} {name}")
    if spec.startswith("redynis"):  # the kernel route and the plain one agree
        tstatic, tparams = tp.split_policy(tp.parse_policy(spec))
        ctx = tp.PolicyContext(torch.zeros(5, 5), torch.from_numpy(_contexts(2, 300, 5, budget)[1]),
                               None if budget is None else torch.full((5,), budget), tparams)
        plain, _, _ = tp.policy_sweep(tstatic, (), store_from_numpy(*arrays, device="cpu"), 9, ctx,
                                      fused=False)
        assert torch.equal(plain.owners, tplan.owners)


def test_decaylfu_state_matches_jax_over_sweeps():
    rng = np.random.default_rng(3)
    arrays = list(_store(4, k=200, n=3))
    ctxs = _contexts(5, 200, 3, 16 * 1024.0)
    state_j = state_t = None
    for sweep in range(5):
        arrays[0] = arrays[0] + rng.integers(0, 3, arrays[0].shape).astype(np.int32)
        (jplan, state_j, jnew), (tplan, state_t, tnew) = _sweep_both(
            "decaylfu:h=0.3,alpha=0.3", arrays, ctxs, state_j, state_t, now=sweep)
        for a, b in zip(state_j, state_t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"sweep {sweep}")
        np.testing.assert_array_equal(tplan.owners.numpy(), np.asarray(jplan.owners))
        arrays[1] = np.asarray(jnew.hosts)


def test_policy_masked_step_commits_only_on_due_ticks():
    arrays = _store(6, k=200, n=3)
    _, obj, _, cap = _contexts(7, 200, 3, 16 * 1024.0)
    static, params = tp.split_policy(tp.DecayLFUPolicy(h=0.3, alpha=0.3))
    store = store_from_numpy(*arrays, device="cpu")
    ctx = tp.PolicyContext(torch.zeros(3, 3), torch.from_numpy(obj), cap, params)
    state = static.init(store, ctx)
    stats, kept, same = tp.policy_masked_step(static, state, store, 4, False, ctx)
    assert kept is state and same is store and all(int(x) == 0 for x in stats)
    stats, new_state, new = tp.policy_masked_step(static, state, store, 4, True, ctx)
    plan, want_state, _ = tp.policy_sweep(static, state, store, 4, ctx)
    assert int(stats.capacity_evictions) == int(plan.capacity_evicted.sum()) > 0
    assert int(stats.adds) == int(plan.to_add.sum())
    assert all(torch.equal(a, b) for a, b in zip(new_state, want_state))


def test_labels_and_registry_match_jax():
    for spec in MATRIX_SPECS + SWEEP_SPECS:
        a, b = jp.parse_policy(spec), tp.parse_policy(spec)
        assert tp.describe_policy(b) == jp.describe_policy(a), spec
        assert tp.policy_repr(b) == jp.policy_repr(a), spec
        for n in (3, 5):
            assert tp.describe_policy(b.resolve(n)) == jp.describe_policy(a.resolve(n)), spec
    assert sorted(tp.POLICIES) == sorted(jp.POLICIES)
    assert tp.make_policy("remote") == tp.StaticPolicy(mode="remote")
    # Class-aware equality: equal field tuples of two families differ.
    assert tp.TopKPolicy(k=1.0, decay=1.0, period=1) != (1.0, 1.0, 1)
    assert len({tp.RedynisPolicy(), tp.RedynisPolicy(), tp.StaticPolicy()}) == 2
    assert tp.split_policy(tp.parse_policy("topk:k=40"))[1] == jp.split_policy(jp.parse_policy("topk:k=40"))[1]


@pytest.mark.parametrize("spec,n", [
    ("nosuch", 3), ("redynis:h", 3), ("redynis:h=0.6", 3), ("redynis:expiry=-1", 3),
    ("redynis:decay=0", 3), ("topk:k=-1", 3), ("topk:period=0", 3),
    ("costgreedy:min_saved_ms_per_kib=-1", 3), ("decaylfu:alpha=1.5", 3),
    ("sizeaware:large_fanout=0.5", 5), ("sizeaware:size_threshold_bytes=-1", 5),
    ("static:mode=elsewhere", 3),
])
def test_errors_match_jax(spec, n):
    errors = []
    for mod in (jp, tp):
        with pytest.raises(ValueError) as info:
            mod.parse_policy(spec).resolve(n).validate(n)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


ENGINE_SPECS = ["redynis:expiry=3,decay=0.75,period=2", "topk:k=30", "costgreedy",
                "decaylfu:alpha=0.3,period=2", "sizeaware:size_threshold_bytes=1024", "remote"]


@pytest.mark.parametrize("topo", ["flat", "wan5_edge"])
@pytest.mark.parametrize("spec", ENGINE_SPECS)
def test_run_scenario_matches_jax(spec, topo):
    if topo == "flat":
        jwl = jk.WorkloadConfig(num_requests=3_000, num_keys=200, skewed=True, read_fraction=0.8)
        jcl = jk.ClusterConfig(capacity_bytes=48 * 1024.0)
    else:
        jwl = jk.wan5_workload(num_requests=3_000, num_keys=200, affinity=0.8, read_fraction=0.9,
                               skewed=True)
        jcl = jk.wan5_edge_cluster(edge_capacity_bytes=12 * 1024.0)
    ref = jk.run_scenario(jwl, jcl, jk.parse_policy(spec), seed=1, daemon_interval=400)
    t = jk.generate_trace(jwl, 1)
    ours = run_scenario(
        WorkloadConfig(**jwl._asdict()), cluster_from_fields(**jcl._asdict()), tp.parse_policy(spec),
        seed=1, daemon_interval=400, device="cpu",
        trace=trace_from_numpy(*(np.asarray(a) for a in t), device="cpu"),
    )
    for name in ("replication_moves", "deletion_moves", "evictions", "capacity_evictions", "hit_rate"):
        assert getattr(ours, name) == getattr(ref, name), (spec, topo, name)
    for name in ("throughput_ops_s", "mean_latency_ms", "node_busy_ms", "peak_occupancy_bytes"):
        np.testing.assert_allclose(np.asarray(getattr(ours, name)), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, err_msg=f"{spec} {topo} {name}")
    if spec != "remote":
        assert ours.capacity_evictions > 0, (spec, topo)  # the budget bites
