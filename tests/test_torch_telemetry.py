"""The port's telemetry and contention on the CPU against the JAX reference.

Engine cases replay one trace through both engines: the trace is drawn with
JAX ``generate_trace`` and handed to the port (``trace=``), and the configs
are built from one set of values (``cluster_from_fields``,
``telemetry_from_fields``). Kernel-level cases make their inputs with numpy
from a seed and hand them to both packages.

Bars, each with its reason:

* ``hist_group``, ``chunk_hist``, and the per-chunk hits, reads, requests,
  moves, drops and evictions — exact: integer counts of the same requests
  in the same bins (the latencies are the same f32 bits, and the bin rule
  is the reference's expression with the correctly rounded f32 log; XLA's
  CPU log is an ulp off it at a few values, which then land one bin over:
  ``test_bin_index_matches_jax_but_where_its_f32_log_is_an_ulp_off`` counts
  them within 64 ulps of every edge, and none lies in these runs' traces);
* ``p99_latency_ms`` and ``tail_summary()`` — exact: the same numpy
  interpolation of equal histograms;
* per-chunk ``mean_latency_ms`` (``lat_sum``) and ``occupancy_bytes`` —
  rtol 1e-5: f32 sums of the same values taken in another order;
* ``load_factor`` — rtol ``(B + 2) * 2**-24`` for chunks of ``B``
  requests: the reference folds each node's demand as a sequential f32
  scatter (relative error at most ``(B - 1) * 2**-24`` for positive
  terms), the port in f64 rounded once, and ``rho`` takes one more
  rounding in each.
* With a lognormal object-size spread (sigma > 0) the folds differ in their
  last bits, so ``rho`` and every wait may differ by ulps; a latency that
  lies within an ulp of a bin edge may then land in the neighbouring bin.
  The contention cases therefore allow a differing histogram cell only as
  far as the port's own latencies lie within 4 ulps of a bin edge (on these
  seeds none does, and the histograms are equal).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.kvsim as jk  # noqa: E402
from repro.kernels.chunk_replay import ref as jref  # noqa: E402
from repro.kernels.latency_histogram.kernel import latency_histogram_call  # noqa: E402
from repro.kernels.latency_histogram.ref import latency_histogram_ref as jax_hist_ref  # noqa: E402
from repro.kvsim import telemetry as jtel  # noqa: E402
import repro_torch.kvsim.simulate as sim_mod  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    cluster_from_fields,
    telemetry_from_fields,
    trace_from_numpy,
)
from repro_torch.kernels.chunk_replay import ref as tref  # noqa: E402
from repro_torch.kernels.chunk_replay.ops import chunk_replay  # noqa: E402
from repro_torch.kernels.latency_histogram.ops import latency_histogram  # noqa: E402
from repro_torch.kernels.latency_histogram.ref import (  # noqa: E402
    bin_edges,
    bin_index,
    latency_histogram_chunks_ref,
    latency_histogram_ref,
)
from repro_torch.kvsim import (  # noqa: E402
    RedynisPolicy,
    ServiceConfig,
    SimTrace,
    StaticPolicy,
    TelemetryConfig,
    WorkloadConfig,
    run_scenario,
)
from repro_torch.kvsim import telemetry as ttel  # noqa: E402
from repro_torch.kvsim.cluster import WAN5_RTT_MS, flat_rtt  # noqa: E402

EXACT = ("hist_group", "chunk_hist", "hit_rate", "requests", "moves", "drops",
         "evictions", "capacity_evictions", "p99_latency_ms", "router_consults",
         "directory_fetches", "mis_routes", "stale_consults", "stale_age_hist",
         "unavailable_reads", "unavailable_writes", "failovers", "repair_moves",
         "unreachable_frac", "wiped_frac", "effective_hit_rate")
CLOSE = ("mean_latency_ms", "occupancy_bytes")


def _same_trace(jwl, seed):
    t = jk.generate_trace(jwl, seed)
    return trace_from_numpy(*(np.asarray(a) for a in t), device="cpu")


def _near_edge_count(lat: np.ndarray, edges: np.ndarray, ulps: int = 4) -> int:
    """Latencies within ``ulps`` f32 ulps of an interior bin edge."""
    inner = edges[1:-1].astype(np.float32)
    pos = np.searchsorted(inner, lat)
    lo = inner[np.clip(pos - 1, 0, len(inner) - 1)]
    hi = inner[np.clip(pos, 0, len(inner) - 1)]
    gap = np.minimum(np.abs(lat - lo), np.abs(hi - lat))
    return int(np.sum(gap <= ulps * np.spacing(lat)))


def _run_both(jwl, jcl, jpol, tpol, seed, di, monkeypatch=None):
    """The JAX and the port engine on one trace; with ``monkeypatch`` the
    port's per-request latencies are recorded too."""
    jtcfg = jk.TelemetryConfig()
    ref, jtrace = jk.run_scenario(jwl, jcl, jpol, seed=seed, daemon_interval=di, telemetry=jtcfg)
    seen = []
    if monkeypatch is not None:
        def recording(*args, lat_out=None, **kw):
            lat = torch.empty(args[1].shape[0]) if lat_out is None else lat_out
            out = chunk_replay(*args, lat_out=lat, **kw)
            seen.append(lat[args[4]].clone())
            return out

        monkeypatch.setattr(sim_mod, "chunk_replay", recording)
    ours, trace = run_scenario(
        WorkloadConfig(**jwl._asdict()), cluster_from_fields(**jcl._asdict()), tpol,
        seed=seed, daemon_interval=di, device="cpu", trace=_same_trace(jwl, seed),
        telemetry=telemetry_from_fields(**jtcfg._asdict()),
    )
    lat = torch.cat(seen).numpy() if seen else None
    return ours, trace, ref, jtrace, lat


def assert_trace_matches(trace: SimTrace, jtrace, ctx, *, chunk_size, edge_lat=None):
    assert isinstance(trace, SimTrace)
    np.testing.assert_array_equal(trace.edges, jtrace.edges)
    for name in EXACT:
        got, want = np.asarray(getattr(trace, name)), np.asarray(getattr(jtrace, name))
        assert got.shape == want.shape, (ctx, name, got.shape, want.shape)
        if edge_lat is not None and name in ("hist_group", "chunk_hist", "p99_latency_ms"):
            if not np.array_equal(got, want, equal_nan=True):
                # Only near-edge latencies may move between neighbouring bins.
                allowed = _near_edge_count(edge_lat, trace.edges)
                moved = np.abs(trace.hist_group - jtrace.hist_group).sum() / 2
                assert 0 < moved <= allowed, (ctx, name, moved, allowed)
            continue
        np.testing.assert_array_equal(got, want, err_msg=f"{ctx} {name}")
    for name in CLOSE:
        np.testing.assert_allclose(
            getattr(trace, name), getattr(jtrace, name), rtol=1e-5, err_msg=f"{ctx} {name}"
        )
    np.testing.assert_allclose(
        trace.load_factor, jtrace.load_factor, rtol=(chunk_size + 2) * 2.0**-24, atol=0,
        err_msg=f"{ctx} load_factor",
    )
    if edge_lat is None or np.array_equal(trace.hist_group, jtrace.hist_group):
        for split in ("all", "read", "write", 0):  # nan where a split is empty
            got, want = trace.tail_summary(split), jtrace.tail_summary(split)
            assert list(got) == list(want)
            np.testing.assert_array_equal(list(got.values()), list(want.values()), err_msg=ctx)
    assert trace.relative_bin_width == jtrace.relative_bin_width
    assert trace.convergence_chunk() == jtrace.convergence_chunk(), ctx
    assert trace.post_convergence_moves() == jtrace.post_convergence_moves(), ctx


def assert_result_matches(ours, ref, ctx, busy_rtol=1e-5):
    for name in ("replication_moves", "deletion_moves", "evictions", "hit_rate"):
        assert getattr(ours, name) == getattr(ref, name), (ctx, name)
    for name in ("mean_latency_ms", "peak_occupancy_bytes"):
        np.testing.assert_allclose(
            np.asarray(getattr(ours, name)), np.asarray(getattr(ref, name)), rtol=1e-5,
            err_msg=f"{ctx} {name}",
        )
    for name in ("throughput_ops_s", "node_busy_ms"):
        np.testing.assert_allclose(
            np.asarray(getattr(ours, name)), np.asarray(getattr(ref, name)), rtol=busy_rtol,
            err_msg=f"{ctx} {name}",
        )


BASELINES = {
    "local": (jk.StaticPolicy(mode="local"), StaticPolicy(mode="local")),
    "remote": (jk.StaticPolicy(mode="remote"), StaticPolicy(mode="remote")),
    "optimized": (jk.RedynisPolicy(), RedynisPolicy()),
    "replicated": (jk.StaticPolicy(mode="replicated"), StaticPolicy(mode="replicated")),
}


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_telemetry_matches_jax_flat_baselines(name):
    jwl = jk.WorkloadConfig(num_requests=4_000, num_keys=200, skewed=True)
    jpol, tpol = BASELINES[name]
    ours, trace, ref, jtrace, _ = _run_both(jwl, jk.ClusterConfig(), jpol, tpol, 2, 500)
    assert_result_matches(ours, ref, name)
    assert_trace_matches(trace, jtrace, name, chunk_size=500)
    assert trace.hist.sum() == 4_000


def test_telemetry_matches_jax_wan5_redynis_with_expiry_and_decay():
    """wan5, a partial final chunk, a period > 1, expiry, decay, transfer."""
    jwl = jk.wan5_workload(num_requests=3_300, num_keys=150, affinity=0.8, read_fraction=0.8)
    jcl = jk.wan5_cluster(transfer_ms_per_kb=0.5)
    jpol = jk.RedynisPolicy(h=0.2, expiry=3, decay=0.75, period=2)
    tpol = RedynisPolicy(h=0.2, expiry=3, decay=0.75, period=2)
    ours, trace, ref, jtrace, _ = _run_both(jwl, jcl, jpol, tpol, 1, 400)
    assert trace.evictions.sum() > 0 and trace.moves.sum() > 0
    assert_result_matches(ours, ref, "wan5")
    assert_trace_matches(trace, jtrace, "wan5", chunk_size=400)


CONTENTION = [(sigma, pol) for sigma in (0.0, 1.0) for pol in ("redynis", "remote")]


@pytest.mark.parametrize("sigma,pol", CONTENTION, ids=[f"sigma{s}-{p}" for s, p in CONTENTION])
def test_telemetry_matches_jax_under_contention(sigma, pol, monkeypatch):
    """The tail-latency grid's contention shape (benchmarks/tail_latency.py):
    balanced regions, affinity 0.8, reads only, 128 bytes/ms, capacity
    factor 1.0; a final partial chunk."""
    jwl = jk.wan5_workload(
        num_requests=5_500, num_keys=300, read_fraction=1.0, region_weights=(0.2,) * 5,
        affinity=0.8, object_bytes_sigma=sigma,
    )
    jcl = jk.wan5_cluster(service=jk.ServiceConfig(serve_bytes_per_ms=128.0, capacity_factor=1.0))
    jpol, tpol = (
        (jk.RedynisPolicy(), RedynisPolicy()) if pol == "redynis"
        else (jk.StaticPolicy(mode="remote"), StaticPolicy(mode="remote"))
    )
    ours, trace, ref, jtrace, lat = _run_both(jwl, jcl, jpol, tpol, 0, 1_000, monkeypatch)
    assert lat.shape == (5_500,)
    assert trace.load_factor.shape == (6, 5) and trace.load_factor.max() > 0.1
    # The waits make latencies fractional. The reference's scan adds them
    # to each node's busy total one request at a time in f32 (relative
    # error up to that node's request count times 2**-24); the port adds
    # exact per-chunk partials. Busy and throughput are held to that bound.
    per_node = np.bincount(np.asarray(jk.generate_trace(jwl, 0).nodes)).max()
    assert_result_matches(
        ours, ref, f"contention {sigma} {pol}", busy_rtol=max(1e-5, per_node * 2.0**-24)
    )
    assert_trace_matches(
        trace, jtrace, f"contention {sigma} {pol}", chunk_size=1_000,
        edge_lat=lat if sigma > 0 else None,
    )


def test_disabled_configs_mean_off():
    wl = WorkloadConfig(num_requests=1_000, num_keys=50)
    base = run_scenario(wl, cluster_from_fields(**jk.ClusterConfig()._asdict()),
                        RedynisPolicy(), device="cpu")
    off = run_scenario(
        wl, cluster_from_fields(**jk.ClusterConfig()._asdict())._replace(
            service=ServiceConfig(enabled=False)),
        RedynisPolicy(), device="cpu", telemetry=TelemetryConfig(enabled=False),
    )
    assert isinstance(off, type(base))
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(off, base))


# ---------------------------------------------------------------------------
# The histogram's plain versions against the JAX ref and the Pallas kernel.
# ---------------------------------------------------------------------------


def _random_chunk(seed, r, g, lo, hi):
    """Latencies over [lo/10, hi*10], the four decade edges, random
    groups and 0/1 weights (the generator of tests/test_telemetry.py)."""
    rng = np.random.default_rng(seed)
    lat = np.exp(rng.uniform(np.log(max(lo / 10, 1e-6)), np.log(hi * 10), size=r))
    lat = lat.astype(np.float32)
    lat[: min(4, r)] = np.asarray([1.0, 10.0, 100.0, 1000.0], np.float32)[: min(4, r)]
    group = rng.integers(0, g, size=r).astype(np.int32)
    weight = (rng.random(r) < 0.8).astype(np.float32)
    return lat, group, weight


HIST_GRID = [
    (0, 512, 6, 64, 1.0, 10_000.0),
    (1, 1000, 10, 128, 1.0, 10_000.0),
    (2, 77, 10, 32, 5.0, 500.0),
    (3, 2048, 16, 128, 0.1, 1e6),
    (4, 1, 2, 8, 1.0, 100.0),
]


@pytest.mark.parametrize("params", HIST_GRID, ids=[f"r{p[1]}-g{p[2]}-b{p[3]}" for p in HIST_GRID])
def test_latency_histogram_ref_matches_jax_ref_and_pallas(params):
    seed, r, g, b, lo, hi = params
    lat, group, weight = _random_chunk(seed, r, g, lo, hi)
    kw = dict(num_groups=g, num_bins=b, lo=lo, hi=hi)
    want = np.asarray(jax_hist_ref(*(jnp.asarray(a) for a in (lat, group, weight)), **kw))
    tr = r if r <= 256 else 256
    rp = -(-r // tr) * tr
    padded = [np.pad(a, (0, rp - r)) for a in (lat, group, weight)]
    pal = np.asarray(latency_histogram_call(
        *(jnp.asarray(a) for a in padded), tr=tr, interpret=True, **kw))
    got = latency_histogram_ref(*(torch.from_numpy(a) for a in (lat, group, weight)), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pal)
    np.testing.assert_array_equal(
        bin_index(torch.from_numpy(lat), lo, hi, b).numpy(),
        np.asarray(jtel.bin_index(jnp.asarray(lat), lo, hi, b)),
    )
    # The wrapper on CPU tensors is the plain version.
    wrapped = latency_histogram(*(torch.from_numpy(a) for a in (lat, group, weight)), **kw)
    assert torch.equal(wrapped, got)


# Values within 64 ulps of an edge where the port's bin differs from JAX's,
# for each HIST_GRID rule (found with jax 0.9.0 on the CPU): 22 of 45,795.
JAX_LOG_ULP_MISSES = {(1.0, 10_000.0, 64): 5, (1.0, 10_000.0, 128): 8, (5.0, 500.0, 32): 1,
                      (0.1, 1e6, 128): 8, (1.0, 100.0, 8): 0}


@pytest.mark.parametrize("params", HIST_GRID, ids=[f"b{p[3]}-lo{p[4]}-hi{p[5]}" for p in HIST_GRID])
def test_bin_index_matches_jax_but_where_its_f32_log_is_an_ulp_off(params):
    """The port takes the correctly rounded f32 log (f64, rounded once),
    the reference ``jnp.log`` in f32. Within 64 ulps of every edge the two
    bin rules agree but at a few values; at each, XLA's log of the quotient
    ``lat / lo`` is not the correctly rounded one, and the bins differ by
    exactly one. The kernels keep the port's rule."""
    _, _, _, b, lo, hi = params
    edges = bin_edges(lo, hi, b)[1:-1].astype(np.float32)
    bits = edges.view(np.int32)[:, None] + np.arange(-64, 65, dtype=np.int32)[None, :]
    lat = np.unique(bits.ravel()).view(np.float32)
    ours = bin_index(torch.from_numpy(lat), lo, hi, b).numpy()
    theirs = np.asarray(jtel.bin_index(jnp.asarray(lat), lo, hi, b))
    miss = np.nonzero(ours != theirs)[0]
    assert len(miss) <= JAX_LOG_ULP_MISSES[(lo, hi, b)], lat[miss]
    np.testing.assert_array_equal(np.abs(ours[miss] - theirs[miss]), 1)
    q = lat[miss] / np.float32(lo)
    xla_log = np.asarray(jnp.log(jnp.asarray(q)))
    assert (xla_log != np.log(q.astype(np.float64)).astype(np.float32)).all(), lat[miss]


def test_latency_histogram_ref_real_weights_allclose():
    """Real-valued weights are summed in another order than the reference's
    scatter: allclose, not bit-exact."""
    lat, group, _ = _random_chunk(7, 800, 6, 1.0, 10_000.0)
    weight = np.random.default_rng(7).random(800).astype(np.float32)
    kw = dict(num_groups=6, num_bins=64, lo=1.0, hi=10_000.0)
    want = np.asarray(jax_hist_ref(*(jnp.asarray(a) for a in (lat, group, weight)), **kw))
    got = latency_histogram_ref(*(torch.from_numpy(a) for a in (lat, group, weight)), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("rows_per_chunk", [1, 97, 250, 1000, 1500])
def test_chunks_histogram_equals_single_calls(rows_per_chunk):
    """The ``[C, G, B]`` form equals C single calls (last chunk short)."""
    lat, group, weight = (torch.from_numpy(a) for a in _random_chunk(11, 1000, 10, 1.0, 1e4))
    kw = dict(num_groups=10, num_bins=128, lo=1.0, hi=1e4)
    got = latency_histogram_chunks_ref(lat, group, weight, rows_per_chunk=rows_per_chunk, **kw)
    c = -(-1000 // rows_per_chunk)
    assert got.shape == (c, 10, 128)
    for i in range(c):
        rows = slice(i * rows_per_chunk, (i + 1) * rows_per_chunk)
        assert torch.equal(got[i], latency_histogram_ref(lat[rows], group[rows], weight[rows], **kw))
    assert torch.equal(
        latency_histogram(lat, group, weight, rows_per_chunk=rows_per_chunk, **kw), got
    )
    # trace_histogram is the same fold, and matches the reference's bincount.
    tcfg = TelemetryConfig()
    np.testing.assert_array_equal(
        ttel.trace_histogram(lat, group, weight, tcfg, 5, rows_per_chunk=rows_per_chunk).numpy(),
        np.asarray(jtel.trace_histogram(
            jnp.asarray(np.pad(lat.numpy(), (0, c * rows_per_chunk - 1000))),
            jnp.asarray(np.pad(group.numpy(), (0, c * rows_per_chunk - 1000))),
            jnp.asarray(np.pad(weight.numpy(), (0, c * rows_per_chunk - 1000))),
            jk.TelemetryConfig(), 5, c)),
    )


def test_latency_histogram_wrapper_checks_inputs():
    lat, group, weight = (torch.from_numpy(a) for a in _random_chunk(0, 10, 2, 1.0, 100.0))
    with pytest.raises(ValueError, match="num_bins"):
        latency_histogram(lat, group, weight, num_groups=2, num_bins=2)
    with pytest.raises(ValueError, match="lo"):
        latency_histogram(lat, group, weight, num_groups=2, lo=5.0, hi=1.0)
    with pytest.raises(ValueError, match="rows_per_chunk"):
        latency_histogram(lat, group, weight, num_groups=2, rows_per_chunk=0)


# ---------------------------------------------------------------------------
# The contention pre-pass against the reference's, as its engine compiles it.
# ---------------------------------------------------------------------------


def _contention_chunk(seed, b=1000, k=300, n=5):
    rng = np.random.default_rng(seed)
    hosts = rng.random((k, n)) < 0.4
    hosts[rng.random(k) < 0.1] = False
    return dict(
        hosts=hosts, keys=rng.integers(0, k, b).astype(np.int32),
        nodes=rng.integers(0, n, b).astype(np.int32), is_read=rng.random(b) < 0.8,
        valid=rng.random(b) < 0.9, rtt=np.float32(WAN5_RTT_MS),
        obj=(1024 * np.exp(rng.normal(0.0, 1.0, k))).astype(np.float32),
    )


CONTENTION_REFS = [(mode, serve) for mode in ("map", "no_local", "ideal") for serve in (128.0, 100.3)]


@pytest.mark.parametrize("mode,serve", CONTENTION_REFS, ids=[f"{m}-{s}" for m, s in CONTENTION_REFS])
def test_contention_refs_match_jax(mode, serve):
    """The reference's engine runs the pre-pass under ``jit`` with the
    scalars as constants, so it is compared jitted. Serving nodes and
    demands are exact; the wait is exact from the same ``rho``; ``rho``
    and the composed ``extra_ms`` carry the fold's tolerance (module
    docstring), the wait's amplified by ``1 / (1 - rho_max)``."""
    d = _contention_chunk(hash((mode, serve)) % 2**32)
    b = d["keys"].shape[0]
    kw = dict(read_mode=mode, service_ms=10.0, serve_bytes_per_ms=serve,
              capacity_ms=1.0 * b * 10.0, rho_max=0.95)
    names = ("hosts", "keys", "nodes", "is_read", "valid", "rtt", "obj")
    j = {key: jnp.asarray(d[key]) for key in names}
    t = {key: torch.from_numpy(d[key]) for key in names}

    jserve = jax.jit(lambda r, x, i, m: jref.serving_node_ref(r, x, i, m, read_mode=mode))
    if mode != "ideal":
        np.testing.assert_array_equal(
            tref.serving_node_ref(t["hosts"][t["keys"].long()], t["nodes"], t["is_read"],
                                  t["rtt"], read_mode=mode).numpy(),
            np.asarray(jserve(j["hosts"][j["keys"]], j["nodes"], j["is_read"], j["rtt"])),
        )
    jdemand = jax.jit(lambda o: jref.service_demand_ref(
        o, service_ms=10.0, serve_bytes_per_ms=serve))(j["obj"])
    tdemand = tref.service_demand_ref(t["obj"], service_ms=10.0, serve_bytes_per_ms=serve)
    np.testing.assert_array_equal(tdemand.numpy(), np.asarray(jdemand))

    jextra, jrho = jax.jit(lambda *a: jref.contention_extra_ms_ref(*a, **kw))(
        *(j[key] for key in names))
    textra, trho = tref.contention_extra_ms_ref(*(t[key] for key in names), **kw)
    rtol = (b + 2) * 2.0**-24
    np.testing.assert_allclose(trho.numpy(), np.asarray(jrho), rtol=rtol, atol=0)
    np.testing.assert_allclose(textra.numpy(), np.asarray(jextra), rtol=rtol / (1 - 0.95), atol=0)

    serving = tref.serving_node_ref(
        None if mode == "ideal" else t["hosts"][t["keys"].long()], t["nodes"], t["is_read"],
        t["rtt"], read_mode=mode)
    demand = tdemand[t["keys"].long()]
    jwait = jax.jit(jref.contention_wait_ref)(
        jnp.asarray(demand.numpy()), jrho, jnp.asarray(serving.numpy().astype(np.int32)))
    np.testing.assert_array_equal(
        tref.contention_wait_ref(demand, torch.from_numpy(np.array(jrho)), serving).numpy(),
        np.asarray(jwait),
    )


@pytest.mark.parametrize("slab_rows", [1_000, 3_000, 1 << 22])
def test_contention_chunks_ref_equals_per_chunk_calls(slab_rows, monkeypatch):
    """The static path's whole-trace pre-pass equals one call per chunk
    (a short last chunk is masked, not re-sized), in one slab or several."""
    monkeypatch.setattr(tref, "SLAB_ROWS", slab_rows)
    d = _contention_chunk(3, b=5_500)
    t = {key: torch.from_numpy(v) for key, v in d.items()}
    kw = dict(read_mode="map", service_ms=10.0, serve_bytes_per_ms=128.0,
              capacity_ms=10_000.0, rho_max=0.95)
    extra, rho = tref.contention_extra_ms_chunks_ref(
        t["hosts"], t["keys"], t["nodes"], t["is_read"], t["rtt"], t["obj"],
        chunk_size=1_000, **kw)
    assert extra.shape == (5_500,) and rho.shape == (6, 5)
    for c in range(6):
        rows = slice(c * 1_000, min((c + 1) * 1_000, 5_500))
        e, p = tref.contention_extra_ms_ref(
            t["hosts"], t["keys"][rows], t["nodes"][rows], t["is_read"][rows],
            torch.ones(rows.stop - rows.start, dtype=torch.bool), t["rtt"], t["obj"], **kw)
        assert torch.equal(extra[rows], e) and torch.equal(rho[c], p), c


@pytest.mark.parametrize("mode", ["map", "no_local", "ideal"])
def test_chunk_replay_per_request_outputs(mode):
    """``lat_out`` holds each request's latency after ``extra_ms`` and the
    valid mask (the reference's elementwise position), ``hit_out`` its
    read-hit flag; passing them changes no other output."""
    rng = np.random.default_rng(4)
    b, k, n = 777, 333, 3
    hosts = rng.random((k, n)) < 0.4
    arrays = (hosts, rng.integers(0, k, b).astype(np.int32), rng.integers(0, n, b).astype(np.int32),
              rng.random(b) < 0.75, rng.random(b) < 0.9, np.float32(flat_rtt()))
    extra = rng.uniform(0.0, 30.0, b).astype(np.float32)
    kw = dict(service_ms=10.0, master=1, xfer_read_ms=2.0, xfer_write_ms=3.0, read_mode=mode)
    targs = [torch.from_numpy(a) for a in arrays]
    lat, hit = torch.empty(b), torch.empty(b, dtype=torch.bool)
    with_out = chunk_replay(*targs, extra_ms=torch.from_numpy(extra), lat_out=lat, hit_out=hit,
                            num_bins=64, **kw)
    without = chunk_replay(*targs, extra_ms=torch.from_numpy(extra), num_bins=64, **kw)
    for a, w in zip(with_out, without):
        assert torch.equal(a, w)
    jargs = [jnp.asarray(a) for a in arrays]
    jlat, jhit = jref.chunk_latency_ref(*jargs[:4], jargs[5], **kw)
    valid = arrays[4]
    want = np.where(valid, np.asarray(jlat) + extra, np.float32(0.0))
    np.testing.assert_array_equal(lat.numpy(), want)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit) & valid)
    assert int(hit.sum()) == int(with_out[2])


# ---------------------------------------------------------------------------
# Host-side quantiles, merging and config handling.
# ---------------------------------------------------------------------------


def test_quantiles_and_merge_match_jax():
    rng = np.random.default_rng(9)
    hists = rng.integers(0, 50, size=(40, 128)).astype(np.float64)
    hists[3] = 0.0  # an empty row gives nan
    hists[4, :] = 0.0
    hists[4, 0] = 5.0  # all underflow
    hists[5, :] = 0.0
    hists[5, -1] = 5.0  # all overflow
    edges = TelemetryConfig().edges()
    np.testing.assert_array_equal(edges, jk.TelemetryConfig().edges())
    for q in (0.5, 0.9, 0.99, 0.999):
        np.testing.assert_array_equal(
            ttel.histogram_quantile_rows(hists, edges, q),
            jtel.histogram_quantile_rows(hists, edges, q),
        )
    assert ttel.quantile_summary(hists[0], edges) == jtel.quantile_summary(hists[0], edges)
    s, c, n = 3, 4, 5
    fields = dict(
        hist=rng.integers(0, 9, (s, c, 2 * n, 16)), hits=rng.random((s, c)),
        reads=rng.random((s, c)), lat_sum=rng.random((s, c)), count=rng.random((s, c)),
        adds=rng.random((s, c)), drops=rng.random((s, c)), expiry_evictions=rng.random((s, c)),
        capacity_evictions=rng.random((s, c)), occupancy=rng.random((s, c, n)),
        load_factor=rng.random((s, c, n)),
    )
    got = ttel.merge_leaves(ttel.TelemetryLeaves(**fields))
    want = jtel.merge_leaves(jtel.TelemetryLeaves(**fields))
    for name in ttel.TelemetryLeaves._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)
    cfg = TelemetryConfig(num_bins=16)
    assert ttel.leaves_quantile(got, cfg, 0.99) == jtel.leaves_quantile(
        want, jk.TelemetryConfig(num_bins=16), 0.99)
    assert set(ttel.LEAF_KINDS) == set(ttel.TelemetryLeaves._fields)
    assert all(jtel.LEAF_KINDS[k] == v for k, v in ttel.LEAF_KINDS.items())


def test_telemetry_config_validation_and_normalize():
    assert ttel.normalize_telemetry(None) is None
    assert ttel.normalize_telemetry(TelemetryConfig(enabled=False)) is None
    assert ttel.normalize_telemetry(TelemetryConfig(backend="pallas")).backend == "pallas"
    off_attr = TelemetryConfig(attribution=jtel.AttributionConfig(enabled=False))
    assert ttel.normalize_telemetry(off_attr).attribution is None
    for bad in (dict(num_bins=3), dict(lo_ms=0.0), dict(lo_ms=5.0, hi_ms=1.0), dict(backend="x")):
        with pytest.raises(ValueError):
            ttel.normalize_telemetry(TelemetryConfig(**bad))
    for bad in (dict(serve_bytes_per_ms=0.0), dict(capacity_factor=-1.0), dict(rho_max=1.0)):
        with pytest.raises(ValueError):
            ServiceConfig(**bad).validate()
    assert ServiceConfig().capacity_ms(1000, 10.0) == jk.ServiceConfig().capacity_ms(1000, 10.0)
    assert tuple(TelemetryConfig()) == tuple(jk.TelemetryConfig())
    assert tuple(ServiceConfig()) == tuple(jk.ServiceConfig())
