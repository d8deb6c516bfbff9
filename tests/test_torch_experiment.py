"""The port's experiment grid (``run_experiment``), its reference engine
(``run_scenario_reference``) and ``confidence_interval_99``, on the CPU
against the JAX reference.

The port's traces draw other random bits than JAX's, so the grid is fed
JAX's trace of each seed (``traces=``) and each row is held to per-seed JAX
``run_scenario`` on that trace, never to JAX ``run_experiment``'s own rows.

Bars, each with its reason:

* ``confidence_interval_99`` — exact: the same numpy expression;
* per-seed moves and hit rate, and each row's ``hit_rate`` and
  ``hit_rate_ci99`` — exact: integer counts and the same f32 division;
* per-seed throughput and mean latency, each row's ``throughput``,
  ``ci99`` and ``mean_latency_ms`` — rtol 1e-5: re-associated f32 sums;
* per-seed P99 and each row's ``p99_latency_ms``, ``p99_ci99`` and merged
  histogram — exact: equal histograms (the bin rule's known ulp cases, see
  ``tests/test_torch_telemetry.py``, do not occur in these traces);
* ``run_scenario_reference`` against ``run_scenario``: moves and
  histograms exact, the hit rate to rtol 1e-6 (an f64 division against an
  f32 one), throughput, mean latency and busy to rtol 1e-5.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.kvsim as jk  # noqa: E402
import repro_torch.kvsim as tk  # noqa: E402
from repro_torch.interop import telemetry_from_fields, trace_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _warm_exp():
    """PyTorch's CPU ``exp`` can return values off by ~1e-4 on its first
    call in a process (about one process in eight); one call first avoids it."""
    torch.exp(torch.zeros(1))


_warm_exp()


def _jax_trace(wl, seed):
    """The port's ``traces=`` hook: JAX's trace of this workload and seed."""
    jwl = jk.WorkloadConfig(**wl._asdict())
    return trace_from_numpy(*(np.asarray(a) for a in jk.generate_trace(jwl, seed)), device="cpu")


def test_confidence_interval_99_matches_jax():
    rng = np.random.default_rng(0)
    for samples in (rng.random(5) * 100, rng.random((4, 6)), np.array([3.5]), rng.random((1, 3))):
        a, b = jk.confidence_interval_99(samples), tk.confidence_interval_99(samples)
        assert type(a[0]) is type(b[0])
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])


GRID_POLICIES = [("local", "local"), ("optimized", "redynis"), ("remote", "remote"),
                 ("topk", "topk:k=20")]


@pytest.mark.parametrize("telemetry", [False, True], ids=["plain", "telemetry"])
def test_run_experiment_rows_match_per_seed_jax(telemetry):
    iterations, rfs = 2, (1.0, 0.75)
    kw = dict(num_requests=3_000, num_keys=200)
    tcfg = jk.TelemetryConfig() if telemetry else None
    out = tk.run_experiment(
        read_fractions=rfs, skewed=True, iterations=iterations, daemon_interval=500,
        policies=[tk.parse_policy(s) for _, s in GRID_POLICIES],
        telemetry=telemetry_from_fields(**tcfg._asdict()) if telemetry else None,
        device="cpu", traces=_jax_trace, **kw,
    )
    assert out["num_batched_calls"] == iterations * len(rfs) * len(GRID_POLICIES)
    assert out["read_fractions"] == list(rfs) and out["skewed"] is True
    labels = list(out["policies"])
    assert labels == [jk.describe_policy(jk.parse_policy(s).resolve(3)) for _, s in GRID_POLICIES]
    for (name, spec), label in zip(GRID_POLICIES, labels):
        for rf, row in zip(rfs, out["policies"][label]):
            jwl = jk.WorkloadConfig(read_fraction=rf, skewed=True, **kw)
            refs = [jk.run_scenario(jwl, jk.ClusterConfig(), jk.parse_policy(spec), seed=s,
                                    daemon_interval=500, telemetry=tcfg) for s in range(iterations)]
            traces = [r[1] for r in refs] if telemetry else None
            refs = [r[0] for r in refs] if telemetry else refs
            for ours, ref in zip(row["results"], refs):
                for f in ("replication_moves", "deletion_moves", "capacity_evictions", "hit_rate"):
                    assert getattr(ours, f) == getattr(ref, f), (name, rf, f)
                np.testing.assert_allclose(ours.throughput_ops_s, ref.throughput_ops_s, rtol=1e-5)
            thr, ci = jk.confidence_interval_99([r.throughput_ops_s for r in refs])
            hit, hit_ci = jk.confidence_interval_99([r.hit_rate for r in refs])
            assert (row["hit_rate"], row["hit_rate_ci99"]) == (hit, hit_ci), (name, rf)
            np.testing.assert_allclose([row["throughput"], row["mean_latency_ms"]],
                                       [thr, np.mean([r.mean_latency_ms for r in refs])], rtol=1e-5)
            np.testing.assert_allclose(row["ci99"], ci, rtol=1e-5, atol=1e-6 * thr)
            if not telemetry:
                assert "p99_latency_ms" not in row and "trace" not in row
                continue
            p99, p99_ci = jk.confidence_interval_99([t.quantile(0.99) for t in traces])
            assert (row["p99_latency_ms"], row["p99_ci99"]) == (p99, p99_ci), (name, rf)
            np.testing.assert_array_equal(row["trace"].hist_group, sum(t.hist_group for t in traces))
            assert row["quantiles"] == row["trace"].tail_summary()


def test_run_experiment_checks_its_arguments():
    with pytest.raises(ValueError, match="policies is required"):
        tk.run_experiment(device="cpu")
    with pytest.raises(ValueError, match="duplicate policy labels"):
        tk.run_experiment(policies=[tk.RedynisPolicy(), tk.RedynisPolicy(h=1 / 3)], device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        tk.run_experiment(policies=[tk.RedynisPolicy()], engine="fast", device="cpu")


CASES = [
    ("redynis:expiry=2,decay=0.5", "wan5_edge", False),
    ("decaylfu:alpha=0.3", "flat_budget", True),
    ("costgreedy", "wan5_edge", False),
    ("remote", "flat_budget", False),
]


@pytest.mark.parametrize("spec,topo,contention", CASES)
def test_reference_engine_matches_run_scenario(spec, topo, contention):
    service = tk.ServiceConfig(serve_bytes_per_ms=256.0) if contention else None
    if topo == "wan5_edge":
        cl = tk.wan5_edge_cluster(edge_capacity_bytes=12 * 1024.0, service=service)
        wl = tk.wan5_workload(num_requests=3_000, num_keys=200, skewed=True, read_fraction=0.9)
    else:
        cl = tk.ClusterConfig(capacity_bytes=48 * 1024.0, service=service)
        wl = tk.WorkloadConfig(num_requests=3_000, num_keys=200, skewed=True, read_fraction=0.8)
    kw = dict(seed=3, daemon_interval=700, device="cpu", telemetry=tk.TelemetryConfig())
    a, ta = tk.run_scenario(wl, cl, tk.parse_policy(spec), **kw)
    b, tb = tk.run_scenario_reference(wl, cl, tk.parse_policy(spec), **kw)
    for f in ("replication_moves", "deletion_moves", "evictions", "capacity_evictions"):
        assert getattr(a, f) == getattr(b, f), (spec, f)
    np.testing.assert_allclose(a.hit_rate, b.hit_rate, rtol=1e-6)
    for f in ("throughput_ops_s", "mean_latency_ms", "node_busy_ms", "peak_occupancy_bytes"):
        np.testing.assert_allclose(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), rtol=1e-5)
    np.testing.assert_array_equal(ta.hist_group, tb.hist_group)
    np.testing.assert_array_equal(ta.moves, tb.moves)
    np.testing.assert_array_equal(ta.capacity_evictions, tb.capacity_evictions)
    assert ta.raw_latency_ms is None and tb.raw_latency_ms.shape == (3_000,)
    np.testing.assert_allclose(tb.raw_latency_ms.mean(), b.mean_latency_ms, rtol=1e-12)
    if spec != "remote":
        assert a.capacity_evictions > 0


def test_reference_engine_routes_and_raises_like_the_port():
    kw = dict(iterations=2, num_requests=2_000, policies=[tk.RedynisPolicy(), tk.StaticPolicy("remote")],
              device="cpu", num_keys=150)
    ref = tk.run_experiment(engine="reference", **kw)
    assert ref["num_batched_calls"] == 0
    for label, rows in ref["policies"].items():
        pol = tk.RedynisPolicy() if label.startswith("redynis") else tk.StaticPolicy("remote")
        for rf, row in zip(ref["read_fractions"], rows):
            wl = tk.WorkloadConfig(num_requests=2_000, num_keys=150, read_fraction=rf)
            for seed, got in enumerate(row["results"]):
                want = tk.run_scenario_reference(wl, tk.ClusterConfig(), pol, seed=seed, device="cpu")
                assert got.hit_rate == want.hit_rate and got.throughput_ops_s == want.throughput_ops_s
    # routing and attribution are ported: with both on, the reference engine
    # gives the chunk engine's component counts and the scan's mean latency
    attribution = telemetry_from_fields(**jk.TelemetryConfig(attribution=jk.AttributionConfig())._asdict())
    args = (tk.WorkloadConfig(num_requests=1_000, num_keys=50),
            tk.ClusterConfig(routing=tk.RoutingConfig(publish_lag_chunks=1)), tk.RedynisPolicy())
    kw = dict(daemon_interval=100, device="cpu", telemetry=attribution)
    ref_res, ref_tr = tk.run_scenario_reference(*args, **kw)
    res, tr = tk.run_scenario(*args, **kw)
    np.testing.assert_array_equal(ref_tr.attr_hist_group, tr.attr_hist_group)
    assert ref_res.mean_latency_ms == pytest.approx(res.mean_latency_ms, rel=1e-6)
    assert ref_res.router_consults == res.router_consults > 0


def test_port_imports_neither_jax_nor_the_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_torch)|from repro[. ](?!_torch))", re.M)
    for path in files:
        assert not pattern.search(path.read_text()), path
