"""The port's trace generation (``kvsim/workload.py``: ``generate_trace``,
``generate_key_state``, ``generate_trace_chunk``; the plain version of the
``trace_window`` kernel) and streamed runs, on the CPU against the JAX
reference.

The port draws from ``jax.random``'s threefry stream in the partitionable
layout (``kvsim/prng.py``), so a seed gives the reference's materialized
trace. A streamed window is the counters of its positions: every
``generate_trace_chunk`` equals the same positions of that trace. (JAX's
own streamed windows rebuild the classic layout and differ from its
materialized trace under jax 0.9; they are not what the port is held to.)

Bars, each with its reason:

* keys, nodes, reads and natural nodes — exact, on the presets of
  ``tests/test_workload_stream.py`` and the wan5 and diurnal presets;
* lognormal object sizes — within 8 ulps (about one key in ten off by one
  or more): ``exp`` and ``log1p`` of the port's f32 are correctly rounded
  where XLA's CPU approximations are a few ulps off; equal sizes
  (``sigma = 0``) are exact;
* every window, including one past the end of the trace (its valid rows)
  and one at position 2**30 — exact against the materialized trace's
  positions;
* a streamed run — every ``SimResult`` field and ``SimTrace`` leaf equal,
  bit for bit, to the materialized run; for a static policy, whose
  materialized run takes the whole-trace path while a streamed run always
  takes the chunk loop, the f32 sums (throughput, mean latency, busy,
  component sums) to rtol 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.kvsim as jk  # noqa: E402
import repro_torch.kvsim as tk  # noqa: E402
from repro_torch.kernels.trace_window import ref as twref  # noqa: E402
from repro_torch.kernels.trace_window.ops import trace_window  # noqa: E402
from repro_torch.kvsim import workload as tw  # noqa: E402


def _warm_exp():
    """PyTorch's CPU ``exp`` can return values off by ~1e-4 on its first
    call in a process (about one process in eight); one call first avoids it."""
    torch.exp(torch.zeros(1))


_warm_exp()

PRESETS = {
    "uniform": dict(num_requests=777, num_keys=64),
    "skewed": dict(num_requests=777, num_keys=64, skewed=True, read_fraction=0.7),
    "wan5": jk.wan5_workload(num_requests=777, num_keys=64, affinity=0.8)._asdict(),
    "diurnal": jk.diurnal_workload(num_requests=777, num_keys=64, affinity=0.8)._asdict(),
    "lognormal": jk.wan5_workload(num_requests=777, num_keys=64, affinity=0.8, object_bytes_sigma=0.5,
                                  read_fraction=0.6)._asdict(),
    "wan5_large": jk.wan5_workload(num_requests=50_000, num_keys=2_000, affinity=0.7,
                                   read_fraction=0.9)._asdict(),
    "diurnal_large": jk.diurnal_workload(num_requests=40_001, num_keys=1_500, affinity=0.8,
                                         read_fraction=0.7, object_bytes_sigma=1.0)._asdict(),
    "one_node": dict(num_requests=3_000, num_keys=100, num_nodes=1, skewed=True, affinity=0.5),
}


def _both(name, seed):
    kw = PRESETS[name]
    return jk.generate_trace(jk.WorkloadConfig(**kw), seed), tw.WorkloadConfig(**kw)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_generate_trace_equals_jax(name, seed):
    jt, cfg = _both(name, seed)
    tt = tw.generate_trace(cfg, seed, device="cpu")
    for f in ("keys", "nodes", "natural_node"):
        got = getattr(tt, f)
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jt, f)), err_msg=f)
    np.testing.assert_array_equal(tt.is_read.numpy(), np.asarray(jt.is_read))
    got, want = tt.object_bytes.numpy(), np.asarray(jt.object_bytes)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    if cfg.object_bytes_sigma == 0:
        assert ulps.max() == 0
    else:
        assert ulps.max() <= 8, ulps.max()
    natural, sizes = tw.generate_key_state(cfg, seed, device="cpu")
    assert torch.equal(natural, tt.natural_node) and torch.equal(sizes, tt.object_bytes)


@pytest.mark.parametrize("chunk_size", [100, 111, 256, 1_000])
@pytest.mark.parametrize("name", ["uniform", "skewed", "wan5", "diurnal", "lognormal"])
def test_every_chunk_equals_a_slice_of_the_jax_trace(name, chunk_size):
    """Chunk sizes that divide 777 and that do not: the final chunk runs
    past the trace, and its valid rows equal the trace's last ones."""
    jt, cfg = _both(name, 5)
    r = cfg.num_requests
    natural = tw.generate_key_state(cfg, 5, device="cpu")[0]
    for c in range(-(-r // chunk_size)):
        ch = tw.generate_trace_chunk(cfg, 5, c, chunk_size, natural=natural)
        assert ch.keys.shape == (chunk_size,)
        lo, hi = c * chunk_size, min((c + 1) * chunk_size, r)
        for f in ("keys", "nodes", "is_read"):
            np.testing.assert_array_equal(getattr(ch, f)[: hi - lo].numpy(),
                                          np.asarray(getattr(jt, f))[lo:hi], err_msg=f"{f} chunk {c}")
        if hi - lo < chunk_size:  # past the end: well-typed values
            assert int(ch.keys.min()) >= 0 and int(ch.keys.max()) < cfg.num_keys
            assert int(ch.nodes.min()) >= 0 and int(ch.nodes.max()) < cfg.num_nodes
    again = tw.generate_trace_chunk(cfg, 5, 1, chunk_size, device="cpu")  # natural drawn anew
    assert torch.equal(again.keys, tw.generate_trace_chunk(cfg, 5, 1, chunk_size, natural=natural).keys)


def test_window_far_into_the_stream_is_the_counters_of_its_positions():
    """A window at position 2**30 of a trace of 2**31 - 1 requests: the
    plain version's draws equal the stream transforms at those positions
    (no ``[R]`` draw exists to slice), and the diurnal phase is taken at
    the true positions."""
    cfg = tw.diurnal_workload(num_requests=2**31 - 1, num_keys=5_000, affinity=0.7, read_fraction=0.6)
    params = tw.window_params(cfg, 3)
    natural = tw.generate_key_state(cfg, 3, device="cpu")[0]
    start = 2**30
    keys, nodes, is_read = trace_window(start, 4_097, params, natural)
    pos = torch.arange(start, start + 4_097, dtype=torch.int64)
    k_hot, k_key, k_node, k_rw, _, k_other = tw._workload_keys(3)
    from repro_torch.kvsim import prng

    n_hot = 500
    want_keys = torch.where(prng.bernoulli(k_hot, cfg.hot_traffic, pos),
                            prng.randint(k_key, pos, 0, n_hot),
                            prng.randint(prng.fold_in(k_key, 1), pos, n_hot, cfg.num_keys))
    assert torch.equal(keys, want_keys)
    nat = natural[want_keys.long()].long()
    stay = prng.bernoulli(k_node, cfg.affinity, pos)
    shift = prng.randint(k_other, pos, 1, 5).long()
    want_nodes = (torch.where(stay, nat, (nat + shift) % 5) + pos * 4 // cfg.num_requests) % 5
    assert torch.equal(nodes, want_nodes.to(torch.int32))
    assert torch.equal(is_read, prng.bernoulli(k_rw, cfg.read_fraction, pos))
    assert int((pos * 4 // cfg.num_requests).min()) == 2  # the window sits in phase 2


def test_request_window_takes_arbitrary_positions():
    """``_request_window`` at scattered positions (descending, repeated, a
    2-D batch) equals the JAX trace at those positions."""
    jt, cfg = _both("diurnal", 5)
    natural = tw.generate_key_state(cfg, 5, device="cpu")[0]
    pos = np.array([[776, 0, 3, 3], [500, 100, 101, 7]])
    ch = tw._request_window(cfg, tw._workload_keys(5), torch.from_numpy(pos), natural)
    for f in ("keys", "nodes", "is_read"):
        np.testing.assert_array_equal(getattr(ch, f).numpy(), np.asarray(getattr(jt, f))[pos], err_msg=f)


def test_plain_version_slabs_agree_with_one_slab(monkeypatch):
    cfg = tw.wan5_workload(num_requests=10_000, num_keys=300, affinity=0.8)
    params = tw.window_params(cfg, 1)
    natural = tw.generate_key_state(cfg, 1, device="cpu")[0]
    whole = trace_window(0, 10_000, params, natural)
    monkeypatch.setattr(twref, "SLAB", 999)
    for a, b in zip(whole, trace_window(0, 10_000, params, natural)):
        assert torch.equal(a, b)
    assert [x.shape[0] for x in trace_window(5, 0, params, natural)] == [0, 0, 0]
    assert params.words()[:2] == list(tw._workload_keys(1)[0])
    with pytest.raises(ValueError):
        trace_window(-1, 10, params, natural)


STREAM_CASES = {
    "redynis_telemetry": (dict(num_requests=20_500, num_keys=400, affinity=0.8, read_fraction=0.7),
                          "redynis", True, {}),
    "remote_contention": (dict(num_requests=9_999, num_keys=300, object_bytes_sigma=1.0),
                          "remote", True, dict(service=tk.ServiceConfig(serve_bytes_per_ms=256.0))),
    "costgreedy_routing_faults": (dict(num_requests=12_000, num_keys=300, affinity=0.8), "costgreedy",
                                  False, dict(routing=tk.RoutingConfig(publish_lag_chunks=2,
                                                                       cache_entries=50),
                                              faults=tk.region_outage(0, 10, 8))),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_streamed_run_equals_the_materialized_run(case):
    kw, pol, tel, cl = STREAM_CASES[case]
    wl = tk.diurnal_workload(**kw)
    cluster = tk.wan5_cluster()._replace(**cl)
    telemetry = tk.TelemetryConfig(attribution=tk.AttributionConfig(),
                                   flight=tk.FlightRecorderConfig(mode="reservoir")) if tel else None
    runs = [tk.run_scenario(wl, cluster, tk.parse_policy(pol), seed=2, daemon_interval=500,
                            device="cpu", telemetry=telemetry, trace_mode=mode)
            for mode in ("materialized", "streamed")]
    if telemetry is None:
        runs = [(r,) for r in runs]
    # A static policy's materialized run takes the whole-trace path (its f32
    # sums re-associated), its streamed run the chunk loop, as in the
    # reference: the f32 sums agree to rtol 1e-6 there, everything else exactly.
    loose = ("throughput_ops_s", "mean_latency_ms", "node_busy_ms",
             "attr_chunk_sum_ms", "attr_chunk_mean_ms") if pol == "remote" else ()
    for a, b in zip(*runs):
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if f in loose:
                np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-6, err_msg=f"{case} {f}")
            elif x is not None:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"{case} {f}")


def test_streamed_mode_rejects_a_trace_and_static_runs_take_the_loop():
    wl = tk.WorkloadConfig(num_requests=500, num_keys=50)
    trace = tk.generate_trace(wl, 0, device="cpu")
    with pytest.raises(ValueError, match="streamed"):
        tk.run_scenario(wl, tk.ClusterConfig(), tk.RedynisPolicy(), device="cpu", trace=trace,
                        trace_mode="streamed")
    with pytest.raises(ValueError, match="trace_mode"):
        tk.run_scenario(wl, tk.ClusterConfig(), tk.RedynisPolicy(), device="cpu", trace_mode="lazy")
    assert tk.TRACE_MODES == jk.TRACE_MODES
