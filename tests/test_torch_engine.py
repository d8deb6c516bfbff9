"""The port's ``run_scenario`` on the CPU against the JAX reference engine
on the same trace.

The JAX engine draws its trace from the seed; the test draws the same trace
with JAX ``generate_trace`` and hands it to the port (``trace=``), so both
engines replay identical requests. Held to live JAX output, never to the
checked-in seed goldens (see ROADMAP.md §3).

Tolerances, each with its reason:

* replication_moves, deletion_moves, evictions, hit_rate — exact: integer
  counts (hit_rate is the same f32 division of two exact counts);
* throughput, mean latency, node busy, peak occupancy — rtol 1e-5: the JAX
  static fast path folds busy as a matmul and the port as per-block sums,
  so the f32 sums are re-associated.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.kvsim as jk  # noqa: E402
from repro_torch.interop import cluster_from_fields, trace_from_numpy  # noqa: E402
from repro_torch.kvsim import (  # noqa: E402
    ClusterConfig,
    RedynisPolicy,
    StaticPolicy,
    WorkloadConfig,
    generate_trace,
    run_scenario,
    wan5_workload,
)

EXACT = ("replication_moves", "deletion_moves", "evictions", "capacity_evictions", "hit_rate")
CLOSE = ("throughput_ops_s", "mean_latency_ms", "node_busy_ms", "peak_occupancy_bytes")

BASELINES = {
    "local": (jk.StaticPolicy(mode="local"), StaticPolicy(mode="local")),
    "remote": (jk.StaticPolicy(mode="remote"), StaticPolicy(mode="remote")),
    "optimized": (jk.RedynisPolicy(), RedynisPolicy()),
    "replicated": (jk.StaticPolicy(mode="replicated"), StaticPolicy(mode="replicated")),
}


def _same_trace(jwl, seed):
    t = jk.generate_trace(jwl, seed)
    return trace_from_numpy(*(np.asarray(a) for a in t), device="cpu")


def _port_workload(jwl):
    return WorkloadConfig(**jwl._asdict())


def assert_matches(ours, ref, ctx):
    for name in EXACT:
        assert getattr(ours, name) == getattr(ref, name), (ctx, name)
    for name in CLOSE:
        np.testing.assert_allclose(
            np.asarray(getattr(ours, name)), np.asarray(getattr(ref, name)),
            rtol=1e-5, err_msg=f"{ctx} {name}",
        )


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_port_matches_jax_flat_baselines(name):
    jwl = jk.WorkloadConfig(num_requests=4_000, num_keys=200, skewed=True)
    jpol, tpol = BASELINES[name]
    ref = jk.run_scenario(jwl, jk.ClusterConfig(), jpol, seed=2, daemon_interval=500)
    ours = run_scenario(
        _port_workload(jwl), cluster_from_fields(**jk.ClusterConfig()._asdict()),
        tpol, seed=2, daemon_interval=500, device="cpu", trace=_same_trace(jwl, 2),
    )
    assert_matches(ours, ref, name)


def test_port_matches_jax_wan5_redynis_with_expiry_and_decay():
    """wan5 topology, a partial final chunk, a period > 1, expiry and decay."""
    jwl = jk.wan5_workload(num_requests=3_300, num_keys=150, affinity=0.8, read_fraction=0.8)
    jcl = jk.wan5_cluster(transfer_ms_per_kb=0.5)
    jpol = jk.RedynisPolicy(h=0.2, expiry=3, decay=0.75, period=2)
    ref = jk.run_scenario(jwl, jcl, jpol, seed=1, daemon_interval=400)
    ours = run_scenario(
        _port_workload(jwl), cluster_from_fields(**jcl._asdict()),
        RedynisPolicy(h=0.2, expiry=3, decay=0.75, period=2), seed=1,
        daemon_interval=400, device="cpu", trace=_same_trace(jwl, 1),
    )
    assert ours.replication_moves > 0 and ours.evictions > 0
    assert_matches(ours, ref, "wan5")


def test_port_matches_jax_pallas_backends():
    """The reference's kernel spelling: replay_backend="pallas" with the
    Pallas ownership sweep (interpret mode on the CPU)."""
    jwl = jk.WorkloadConfig(num_requests=2_000, num_keys=150, skewed=True, read_fraction=0.9)
    ref = jk.run_scenario(
        jwl, jk.ClusterConfig(), jk.RedynisPolicy(backend="pallas"), seed=3,
        daemon_interval=500, replay_backend="pallas",
    )
    ours = run_scenario(
        _port_workload(jwl), cluster_from_fields(**jk.ClusterConfig()._asdict()),
        RedynisPolicy(), seed=3, daemon_interval=500, device="cpu",
        trace=_same_trace(jwl, 3),
    )
    assert_matches(ours, ref, "pallas")


def test_generate_trace_statistics():
    """The port's own generator draws the reference's distributions."""
    wl = wan5_workload(num_requests=200_000, num_keys=1_000, affinity=0.7, read_fraction=0.8)
    t = generate_trace(wl, seed=0, device="cpu")
    keys, nodes = t.keys.long(), t.nodes.long()
    assert t.keys.dtype == torch.int32 and t.is_read.dtype == torch.bool
    assert int(keys.min()) >= 0 and int(keys.max()) < wl.num_keys
    hot_share = float((keys < 100).float().mean())
    assert abs(hot_share - 0.9) < 0.01
    assert abs(float(t.is_read.float().mean()) - 0.8) < 0.01
    at_natural = float((nodes == t.natural_node[keys].long()).float().mean())
    assert abs(at_natural - 0.7) < 0.01
    region = torch.bincount(t.natural_node.long(), minlength=5).float() / wl.num_keys
    np.testing.assert_allclose(region.numpy(), wl.region_weights, atol=0.05)
    again = generate_trace(wl, seed=0, device="cpu")
    assert torch.equal(again.keys, t.keys) and torch.equal(again.nodes, t.nodes)


def test_paper_ordering_on_generated_trace():
    """local > optimized > remote in throughput, with real replication."""
    wl = WorkloadConfig(num_requests=20_000)
    res = {
        name: run_scenario(wl, ClusterConfig(), pol, seed=0, device="cpu")
        for name, pol in (
            ("local", StaticPolicy("local")),
            ("optimized", RedynisPolicy()),
            ("remote", StaticPolicy("remote")),
        )
    }
    assert res["local"].throughput_ops_s > res["optimized"].throughput_ops_s
    assert res["optimized"].throughput_ops_s > res["remote"].throughput_ops_s
    assert res["optimized"].replication_moves > 0
