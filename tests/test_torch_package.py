"""Package rules of the port, and its kernels on the card.

The CPU cases check that ``repro_torch`` stands alone (no JAX, nothing of
``repro``), that its entry points refuse to fall back to the CPU, that
inputs outside the port raise ``NotImplementedError``, and that inputs
which raised before their slice was ported now run. The ``cuda`` cases
hold each CUDA kernel against its plain version; they skip where there is
no card and run on one with ``python -m pytest -m cuda tests/test_torch_package.py``.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import create_store  # noqa: E402
from repro_torch.core.expert_placement import ExpertPlacement  # noqa: E402
from repro_torch.core.hot_embedding import HotEmbedding  # noqa: E402
from repro_torch.core.traffic import create_stats  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    expert_state_from_numpy,
    hot_embedding_state_from_numpy,
    kv_cache_from_numpy,
    params_from_numpy,
    store_from_numpy,
    trace_from_numpy,
)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import ParamSpec, dense_init, init_params  # noqa: E402
from repro_torch.serving import SessionRouter  # noqa: E402
from repro_torch.kvsim import (  # noqa: E402
    AttributionConfig,
    ClusterConfig,
    FaultConfig,
    FaultEvent,
    FlightRecorderConfig,
    RedynisPolicy,
    RoutingConfig,
    ServiceConfig,
    StaticPolicy,
    TelemetryConfig,
    WorkloadConfig,
    generate_trace,
    region_outage,
    run_scenario,
    wan5_cluster,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = [
    "repro_torch",
    "repro_torch.device",
    "repro_torch.interop",
    "repro_torch.core",
    "repro_torch.core.metadata",
    "repro_torch.core.ownership",
    "repro_torch.core.placement",
    "repro_torch.core.policy",
    "repro_torch.kvsim",
    "repro_torch.kvsim.cluster",
    "repro_torch.kvsim.workload",
    "repro_torch.kvsim.simulate",
    "repro_torch.kvsim.telemetry",
    "repro_torch.kvsim.routing",
    "repro_torch.kvsim.faults",
    "repro_torch.kvsim.prng",
    "repro_torch.kvsim.tracing",
    "repro_torch.spmd",
    "repro_torch.core.repartition",
    "repro_torch.kernels._build",
    "repro_torch.kernels.trace_window.ops",
    "repro_torch.kernels.trace_window.ref",
    "repro_torch.kernels.chunk_replay.ops",
    "repro_torch.kernels.chunk_replay.ref",
    "repro_torch.kernels.latency_histogram.ops",
    "repro_torch.kernels.latency_histogram.ref",
    "repro_torch.kernels.ownership_sweep.ops",
    "repro_torch.kernels.ownership_sweep.ref",
    "repro_torch.kernels.moe_router.ops",
    "repro_torch.kernels.moe_router.ref",
    "repro_torch.kernels.hot_gather.ops",
    "repro_torch.kernels.hot_gather.ref",
    "repro_torch.configs",
    "repro_torch.configs.base",
    "repro_torch.configs.deepseek_moe_16b",
    "repro_torch.models.params",
    "repro_torch.models.layers",
    "repro_torch.models.moe",
    "repro_torch.dist",
    "repro_torch.core.traffic",
    "repro_torch.core.expert_placement",
    "repro_torch.core.hot_embedding",
    "repro_torch.configs.qwen3_1_7b",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.kernels.flash_decode.ops",
    "repro_torch.kernels.flash_decode.ref",
    "repro_torch.models.attention",
    "repro_torch.models.transformer",
    "repro_torch.models.model",
    "repro_torch.train.fault",
    "repro_torch.serving",
    "repro_torch.serving.kvcache",
    "repro_torch.serving.router",
    "repro_torch.serving.engine",
    "repro_torch.launch.serve",
]


def test_package_imports_without_jax_or_reference():
    script = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in MODULES)
        + "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout


@pytest.mark.parametrize("module", MODULES)
def test_each_module_imports_first(module):
    """Any module may be the first one imported (no import cycle bites)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", f"import {module}"],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_sources_name_neither_jax_nor_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / name for name in (
        "chip_smoke.py", "chip_fault_check.py", "chip_histogram_split.py")]
    for path in files:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "repro." not in text.replace("repro_torch.", ""), path


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario(WorkloadConfig(num_requests=100, num_keys=10), ClusterConfig(), RedynisPolicy())


def _store_arrays(k=4, n=3):
    return (np.zeros((k, n), np.int32), np.zeros((k, n), bool), np.zeros(k, np.int32),
            np.ones(k, bool), np.zeros(k, np.int32))


def _trace_arrays(r=6, k=4):
    return (np.zeros(r, np.int32), np.zeros(r, np.int32), np.ones(r, bool),
            np.zeros(k, np.int32), np.full(k, 1040.0, np.float32))


@pytest.mark.parametrize(
    "make",
    [
        lambda device: generate_trace(
            WorkloadConfig(num_requests=100, num_keys=10), 0, device=device),
        lambda device: create_store(4, 3, device),
        lambda device: ClusterConfig().rtt_matrix(device),
        lambda device: trace_from_numpy(*_trace_arrays(), device=device),
        lambda device: store_from_numpy(*_store_arrays(), device=device),
        lambda device: ExpertPlacement(2, 8, 4, 2).init_state(device=device),
        lambda device: HotEmbedding(64, 4, 8).init_state(device=device),
        lambda device: create_stats(8, 4, device=device),
        lambda device: list(init_params(
            {"w": ParamSpec((4, 4), (None, None), dense_init(4))},
            torch.Generator(device=device or ("cuda" if torch.cuda.is_available() else "cpu")),
            device=device).values()),
        lambda device: list(params_from_numpy({"w": np.ones((2, 2), np.float32)}, device=device).values()),
        lambda device: expert_state_from_numpy(
            np.zeros((2, 8, 4), np.float32), np.zeros((2, 2), np.int32), 0, 0, 0.0, device=device),
        lambda device: hot_embedding_state_from_numpy(
            np.zeros((64, 4), np.float32), np.full(8, -1, np.int32), np.full(64, -1, np.int32), 0,
            device=device),
        lambda device: kv_cache_from_numpy(
            np.zeros((2, 1, 4, 2, 32), np.float32), np.zeros((2, 1, 4, 2, 32), np.float32),
            np.zeros(1, np.int32), device=device),
        lambda device: Model(reduced(get_config("qwen3-1.7b")), device).init_state(2, 8),
        lambda device: SessionRouter(4, 8, device=device).store,
    ],
    ids=["generate_trace", "create_store", "rtt_matrix", "trace_from_numpy", "store_from_numpy",
         "expert_placement", "hot_embedding", "create_stats", "init_params", "params_from_numpy",
         "expert_state_from_numpy", "hot_embedding_state_from_numpy", "kv_cache_from_numpy",
         "model_init_state", "session_router"],
)
def test_tensor_builders_default_to_cuda(make):
    """Every public function that makes tensors puts them on the card
    unless the CPU is asked for; without a card the default raises."""
    out = make("cpu")
    tensors = [out] if isinstance(out, torch.Tensor) else list(out)
    assert all(t.device.type == "cpu" for t in tensors)
    if torch.cuda.is_available():
        assert make(None)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make(None)


@pytest.mark.parametrize(
    "cluster,kwargs,what",
    [
        # streamed traces (with the routing tier on, too), attribution and the
        # flight recorder are ported: they run, and give the results of the
        # run without them; sharding is ported too, and runs only on the
        # ranks of a torch.distributed group (tests/test_torch_sharded_engine.py):
        # outside one it raises
        (ClusterConfig(routing=RoutingConfig()), {"trace_mode": "streamed"}, None),
        (ClusterConfig(faults=region_outage(0, 0, 1)), {"num_shards": 2}, "none is initialised"),
        (ClusterConfig(), {"telemetry": TelemetryConfig(attribution=AttributionConfig())}, None),
        (ClusterConfig(), {"telemetry": TelemetryConfig(flight=FlightRecorderConfig())}, None),
        (ClusterConfig(), {"trace_mode": "streamed"}, None),
        (ClusterConfig(), {"num_shards": 2}, "none is initialised"),
    ],
    ids=["routing", "faults", "attribution", "flight", "streamed", "shards"],
)
def test_out_of_slice_inputs_raise(cluster, kwargs, what):
    """A sharded call outside a group of its size raises ``ValueError``;
    the inputs that raised before their slice (streamed traces,
    attribution, the flight recorder) give the results of the run without
    them, bit for bit."""
    def run(**kw):
        return run_scenario(WorkloadConfig(num_requests=1_000, num_keys=10), cluster,
                            RedynisPolicy(), daemon_interval=150, device="cpu", **kw)

    if what is not None:
        with pytest.raises(ValueError, match=what):
            run(**kwargs)
        return
    got = run(**kwargs)
    if "telemetry" in kwargs:
        (got, tr), (want, tw) = got, run(telemetry=TelemetryConfig())
        for f in ("hist_group", "chunk_hist", "mean_latency_ms", "moves", "router_consults"):
            np.testing.assert_array_equal(getattr(tr, f), getattr(tw, f), err_msg=f)
        assert (tr.attr_hist_group is None) != (tr.flight_meta is None)
    else:
        want = run()
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_interop_rejects_uncovered_cluster_fields():
    from repro_torch.interop import cluster_from_fields

    assert cluster_from_fields(**ClusterConfig()._asdict()) == ClusterConfig()
    carried = cluster_from_fields(service=ServiceConfig(serve_bytes_per_ms=128.0))
    assert carried.service == ServiceConfig(serve_bytes_per_ms=128.0)
    with pytest.raises(NotImplementedError, match="sharding"):
        cluster_from_fields(sharding=object())


def test_interop_carries_routing_and_faults():
    """The routing and failure-injection fields carry across by their
    fields, and a run with both tiers on goes through."""
    from repro_torch.interop import cluster_from_fields

    faults = FaultConfig(events=(FaultEvent("zone", 1, 2, 3, "partition"),))
    fields = dict(ClusterConfig()._asdict(), routing=RoutingConfig(publish_lag_chunks=2),
                  faults=faults, zone_of=[0, 1, 1], region_of=(0, 0, 1))
    carried = cluster_from_fields(**fields)
    assert carried.routing == RoutingConfig(publish_lag_chunks=2) and carried.faults == faults
    assert carried.zone_of == (0, 1, 1) and carried.region_of == (0, 0, 1)
    res = run_scenario(WorkloadConfig(num_requests=2_000, num_keys=50), carried, RedynisPolicy(),
                       daemon_interval=200, device="cpu")
    assert res.router_consults > 0 and res.unavailable_reads > 0


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version on the same inputs.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["map", "no_local", "ideal"])
@pytest.mark.parametrize("bins", [0, 128])
def test_chunk_replay_kernel_matches_plain_version(cuda, mode, bins):
    from repro_torch.kernels.chunk_replay.ops import chunk_replay
    from repro_torch.kernels.chunk_replay.ref import chunk_replay_ref

    rng = np.random.default_rng(1)
    b, k, n = 10_007, 3_001, 5
    hosts = rng.random((k, n)) < 0.4
    hosts[rng.random(k) < 0.1] = False
    args = [
        torch.from_numpy(a).to(cuda)
        for a in (
            hosts, rng.integers(0, k, b).astype(np.int32),
            rng.integers(0, n, b).astype(np.int32), rng.random(b) < 0.8,
            rng.random(b) < 0.9,
        )
    ]
    rtt = wan5_cluster().rtt_matrix(cuda)
    extra = torch.from_numpy(rng.uniform(0, 5, b).astype(np.float32)).to(cuda)
    kw = dict(
        service_ms=10.0, master=2, xfer_read_ms=2.0, xfer_write_ms=3.0,
        read_mode=mode, num_bins=bins, extra_ms=extra,
    )
    got = chunk_replay(*args, rtt, **kw)
    want = chunk_replay_ref(*args, rtt, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    for i in (2, 3, 4):
        assert int(got[i]) == int(want[i])
    if bins:
        assert torch.equal(got[5], want[5])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["map", "no_local"])
@pytest.mark.parametrize("b", [10_000, 400_000], ids=["cluster", "packed"])
def test_chunk_replay_kernel_takes_empty_replica_rows(cuda, mode, b):
    """Keys with no replica (a finite budget can evict a key's last one)
    pay the worst RTT in both launch modes; whole-ms latencies, so exact."""
    from repro_torch.kernels.chunk_replay.ops import chunk_replay, launch_shape
    from repro_torch.kernels.chunk_replay.ref import chunk_replay_ref

    rng = np.random.default_rng(2)
    k, n = 50_000, 3
    assert launch_shape(b, n, k)[0] == ("cluster" if b == 10_000 else "packed")
    hosts = rng.random((k, n)) < 0.4
    hosts[rng.random(k) < 0.3] = False
    args = [torch.from_numpy(a).to(cuda) for a in (
        hosts, rng.integers(0, k, b).astype(np.int32), rng.integers(0, n, b).astype(np.int32),
        rng.random(b) < 0.75, rng.random(b) < 0.95)]
    kw = dict(service_ms=10.0, master=1, xfer_read_ms=2.0, xfer_write_ms=3.0, read_mode=mode,
              num_bins=128)
    rtt = ClusterConfig().rtt_matrix(cuda)
    got, want = chunk_replay(*args, rtt, **kw), chunk_replay_ref(*args, rtt, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("bins", [0, 128])
@pytest.mark.parametrize("b", [10_000, 400_000], ids=["cluster", "packed"])
@pytest.mark.parametrize("case", ["negative_extra", "all_refused", "dead_column"])
def test_chunk_replay_kernel_takes_fault_path_operands(cuda, case, b, bins):
    """The failure-injection path's operands: a failover delta down to
    -300 ms (negative latencies bin to 0), a chunk whose every row is
    refused (``valid`` all False), and a map with one node's column all
    False (a down node under ``hosts & avail``). Whole-ms latencies, so
    every output is exact, per request too."""
    from repro_torch.kernels.chunk_replay.ops import chunk_replay, launch_shape
    from repro_torch.kernels.chunk_replay.ref import chunk_replay_ref

    rng = np.random.default_rng(4)
    k, n = 50_000, 5
    assert launch_shape(b, n, k)[0] == ("cluster" if b == 10_000 else "packed")
    hosts = rng.random((k, n)) < 0.4
    valid = rng.random(b) < 0.9
    if case == "dead_column":
        hosts[:, 0] = False
    if case == "all_refused":
        valid[:] = False
    extra = rng.integers(-300, 30, b).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (
        hosts, rng.integers(0, k, b).astype(np.int32), rng.integers(0, n, b).astype(np.int32),
        rng.random(b) < 0.7, valid)]
    outs = [(torch.empty(b, device=cuda), torch.empty(b, dtype=torch.bool, device=cuda))
            for _ in range(2)]
    kw = dict(service_ms=10.0, master=0, xfer_read_ms=2.0, xfer_write_ms=3.0, read_mode="map",
              num_bins=bins, extra_ms=torch.from_numpy(extra).to(cuda))
    rtt = wan5_cluster().rtt_matrix(cuda)
    got = chunk_replay(*args, rtt, **kw, lat_out=outs[0][0], hit_out=outs[0][1])
    want = chunk_replay_ref(*args, rtt, **kw, lat_out=outs[1][0], hit_out=outs[1][1])
    assert all(g is None and w is None or torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    if case == "all_refused":
        assert int(got[4]) == 0 and not got[0].any()
    else:
        assert bool((outs[0][0] < 0).any())


@pytest.mark.cuda
def test_project_capacity_on_the_card_equals_the_cpu(cuda):
    """Lognormal sizes: the f64 prefix sums are exact, so the card admits
    the keys the CPU admits."""
    from repro_torch.core.costmodel import project_capacity

    rng = np.random.default_rng(3)
    k, n = 100_000, 5
    counts = rng.integers(0, 4, (k, n))
    total = counts.sum(1, keepdims=True)
    f = np.where(total > 0, counts / np.maximum(total, 1), 0).astype(np.float32)
    arrays = (rng.random((k, n)) < 0.6, rng.random((k, n)) < 0.5, f,
              (1024 * np.exp(0.5 * rng.standard_normal(k))).astype(np.float32))
    budget = np.float32(1024 * k / 10)
    want = project_capacity(*(torch.from_numpy(a) for a in arrays), budget)
    got = project_capacity(*(torch.from_numpy(a).to(cuda) for a in arrays), budget)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert want[1].any() and want[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("expiry", [0, 3])
def test_ownership_sweep_kernel_matches_plain_version(cuda, expiry):
    from repro_torch.kernels.ownership_sweep.ops import ownership_sweep
    from repro_torch.kernels.ownership_sweep.ref import sweep_ref

    rng = np.random.default_rng(2)
    k, n = 100_003, 5
    counts = rng.integers(0, 4, size=(k, n)).astype(np.int32)
    counts[rng.random(k) < 0.25] = 0
    args = [
        torch.from_numpy(a).to(cuda)
        for a in (
            counts, rng.random((k, n)) < 0.4, rng.random(k) < 0.9,
            rng.integers(0, 10, k).astype(np.int32),
        )
    ]
    got = ownership_sweep(*args, 9, h=0.2, expiry=expiry)
    want = sweep_ref(*args, 9, h=0.2, expiry=expiry)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_run_scenario_card_matches_cpu(cuda):
    wl = WorkloadConfig(num_requests=20_000, num_keys=500, skewed=True)
    for pol in (RedynisPolicy(), StaticPolicy("replicated")):
        trace = generate_trace(wl, 0, device=cuda)
        a = run_scenario(wl, ClusterConfig(), pol, trace=trace)
        b = run_scenario(wl, ClusterConfig(), pol, trace=trace.cpu(), device="cpu")
        assert a.replication_moves == b.replication_moves
        assert a.hit_rate == b.hit_rate
        np.testing.assert_allclose(a.node_busy_ms, b.node_busy_ms, rtol=1e-5)


def _histogram_inputs(seed, r, g, device):
    """Log-uniform latencies over [0.1, 1e5] ms with the decade edges
    1/10/100/1000 ms first, random groups, 0/1 weights."""
    rng = np.random.default_rng(seed)
    lat = np.exp(rng.uniform(np.log(0.1), np.log(1e5), r)).astype(np.float32)
    lat[:4] = [1.0, 10.0, 100.0, 1000.0]
    group = rng.integers(0, g, r).astype(np.int32)
    weight = (rng.random(r) < 0.8).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (lat, group, weight)]


@pytest.mark.cuda
@pytest.mark.parametrize("g,rows_per_chunk", [(6, None), (10, 10_000), (10, 997), (128, None), (128, 4_096)])
def test_latency_histogram_kernel_matches_plain_version(cuda, g, rows_per_chunk):
    from repro_torch.kernels.latency_histogram.ops import latency_histogram
    from repro_torch.kernels.latency_histogram.ref import (
        latency_histogram_chunks_ref,
        latency_histogram_ref,
    )

    lat, group, weight = _histogram_inputs(3, 100_003, g, cuda)
    kw = dict(num_groups=g, num_bins=128, lo=1.0, hi=10_000.0)
    got = latency_histogram(lat, group, weight, rows_per_chunk=rows_per_chunk, **kw)
    want = (
        latency_histogram_ref(lat, group, weight, **kw) if rows_per_chunk is None
        else latency_histogram_chunks_ref(lat, group, weight, rows_per_chunk=rows_per_chunk, **kw)
    )
    torch.cuda.synchronize()
    assert torch.equal(got, want)  # 0/1 weights: exact counts
    one = torch.ones(4, dtype=torch.int32, device=cuda)
    edge = latency_histogram(lat[:4], one, weight[:4] * 0 + 1, num_groups=2, num_bins=128)
    assert edge[1].nonzero().flatten().tolist() == [1, 32, 64, 95]
    real = torch.rand(lat.shape[0], device=cuda)
    torch.testing.assert_close(
        latency_histogram(lat, group, real, **kw), latency_histogram_ref(lat, group, real, **kw),
        rtol=1e-5, atol=1e-3,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("distinct", [1, 5])
@pytest.mark.parametrize("rows_per_chunk", [None, 10_000, 997])
def test_latency_histogram_kernel_folds_colliding_rows(cuda, distinct, rows_per_chunk):
    """Every row one latency, or one of five: each warp's lanes aim at a
    handful of cells. 0/1 weights exact, real weights (per chunk) to the
    real-weight bar."""
    from repro_torch.kernels.latency_histogram.ops import latency_histogram
    from repro_torch.kernels.latency_histogram.ref import latency_histogram_chunks_ref

    rng = np.random.default_rng(distinct)
    r, g = 300_007, 10
    values = np.float32([123.4, 2.5, 40.0, 180.25, 20_000.0])[:distinct]
    lat = torch.from_numpy(rng.choice(values, r)).to(cuda)
    group = torch.from_numpy(rng.integers(0, g, r).astype(np.int32)).to(cuda)
    kw = dict(num_groups=g, num_bins=128, lo=1.0, hi=10_000.0)
    rpc = r if rows_per_chunk is None else rows_per_chunk
    ones = torch.ones(r, device=cuda)
    got = latency_histogram(lat, group, ones, rows_per_chunk=rows_per_chunk, **kw)
    want = latency_histogram_chunks_ref(lat, group, ones, rows_per_chunk=rpc, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want[0] if rows_per_chunk is None else want)
    if rows_per_chunk is not None:
        real = torch.rand(r, device=cuda)
        torch.testing.assert_close(
            latency_histogram(lat, group, real, rows_per_chunk=rpc, **kw),
            latency_histogram_chunks_ref(lat, group, real, rows_per_chunk=rpc, **kw),
            rtol=1e-5, atol=1e-3,
        )


@pytest.mark.cuda
@pytest.mark.parametrize("r,offset,rows_per_chunk", [
    (4_099, 0, 1), (4_099, 1, 997), (100_003, 1, None), (100_003, 3, 10_000), (100_001, 0, 10**8),
])
def test_latency_histogram_kernel_takes_unaligned_rows(cuda, r, offset, rows_per_chunk):
    """R not a multiple of 4, inputs at an offset off 16 bytes (scalar
    loads), chunks that start off a 16-byte boundary (scalar heads and
    tails), rows_per_chunk 1 and above R; rows outside [0, G) dropped."""
    from repro_torch.kernels.latency_histogram.ops import latency_histogram
    from repro_torch.kernels.latency_histogram.ref import latency_histogram_chunks_ref

    lat, group, weight = _histogram_inputs(7, r + offset, 10, cuda)
    group[::7] = -1
    group[::11] = 10
    lat, group, weight = lat[offset:], group[offset:], weight[offset:]
    kw = dict(num_groups=10, num_bins=128, lo=1.0, hi=10_000.0)
    got = latency_histogram(lat, group, weight, rows_per_chunk=rows_per_chunk, **kw)
    want = latency_histogram_chunks_ref(lat, group, weight, rows_per_chunk=rows_per_chunk or r, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want[0] if rows_per_chunk is None else want)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [226, 227, 228, 454])
def test_latency_histogram_kernel_takes_every_shared_layout(cuda, g):
    """At B 128 the block's shared memory holds the f32 histogram, then the
    u32 counts and the threshold table where they fit: both (226), counts
    with the table read from global memory (227), the table without counts
    (228), neither (454, the largest G the wrapper admits)."""
    from repro_torch.kernels.latency_histogram.ops import latency_histogram
    from repro_torch.kernels.latency_histogram.ref import latency_histogram_chunks_ref

    r = 200_003
    lat, group, weight = _histogram_inputs(g, r, g, cuda)
    kw = dict(num_groups=g, num_bins=128, lo=1.0, hi=10_000.0)
    for rpc in (None, 10_000):
        got = latency_histogram(lat, group, weight, rows_per_chunk=rpc, **kw)
        want = latency_histogram_chunks_ref(lat, group, weight, rows_per_chunk=rpc or r, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want[0] if rpc is None else want), rpc
    real = torch.rand(r, device=cuda)
    torch.testing.assert_close(
        latency_histogram(lat, group, real, rows_per_chunk=997, **kw),
        latency_histogram_chunks_ref(lat, group, real, rows_per_chunk=997, **kw),
        rtol=1e-5, atol=1e-3,
    )


@pytest.mark.cuda
def test_latency_histogram_sets_each_rule_up_once(cuda):
    """The threshold table of a rule is set up by one counted launch the
    first time a device sees the rule, then reused, on other streams too
    (ordered after its set-up)."""
    from repro_torch.kernels.latency_histogram.ops import latency_histogram
    from repro_torch.kernels.latency_histogram.ref import latency_histogram_ref

    lat, group, weight = _histogram_inputs(3, 50_001, 6, cuda)
    kw = dict(num_groups=6, num_bins=48, lo=3.0, hi=3_000.0)
    setups = latency_histogram.setup_launches
    for _ in range(3):
        side = torch.cuda.Stream(cuda)
        side.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(side):
            got = latency_histogram(lat, group, weight, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, latency_histogram_ref(lat, group, weight, **kw))
    assert latency_histogram.setup_launches - setups == 1


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi,num_bins", [(1.0, 10_000.0, 128), (5.0, 500.0, 32)])
def test_latency_histogram_threshold_count_is_bin_of_on_every_float(cuda, lo, hi, num_bins):
    from repro_torch.kernels.latency_histogram.ops import check_bin_rule

    assert check_bin_rule(lo, hi, num_bins, cuda) == (0, None)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["map", "no_local", "ideal"])
def test_chunk_replay_per_request_outputs_match_plain_version(cuda, mode):
    from repro_torch.kernels.chunk_replay.ops import chunk_replay
    from repro_torch.kernels.chunk_replay.ref import chunk_replay_ref

    rng = np.random.default_rng(5)
    b, k, n = 100_003, 30_001, 5
    args = [
        torch.from_numpy(a).to(cuda)
        for a in (
            rng.random((k, n)) < 0.4, rng.integers(0, k, b).astype(np.int32),
            rng.integers(0, n, b).astype(np.int32), rng.random(b) < 0.8, rng.random(b) < 0.9,
        )
    ]
    rtt = wan5_cluster().rtt_matrix(cuda)
    extra = torch.from_numpy(rng.uniform(0, 50, b).astype(np.float32)).to(cuda)
    kw = dict(service_ms=10.0, master=0, xfer_read_ms=1.0, xfer_write_ms=2.0, read_mode=mode,
              extra_ms=extra)
    outs = []
    for fn in (chunk_replay, chunk_replay_ref):
        lat = torch.empty(b, device=cuda)
        hit = torch.empty(b, dtype=torch.bool, device=cuda)
        fn(*args, rtt, lat_out=lat, hit_out=hit, **kw)
        outs.append((lat, hit))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["redynis", "remote"])
def test_telemetry_run_card_matches_cpu(cuda, policy):
    wl = WorkloadConfig(num_requests=30_000, num_keys=500, num_nodes=5, skewed=True,
                        region_weights=(0.2,) * 5, affinity=0.8, object_bytes_sigma=1.0)
    cl = wan5_cluster(service=ServiceConfig(serve_bytes_per_ms=128.0, capacity_factor=1.0))
    pol = RedynisPolicy() if policy == "redynis" else StaticPolicy("remote")
    trace = generate_trace(wl, 0, device=cuda)
    a, ta = run_scenario(wl, cl, pol, trace=trace, telemetry=TelemetryConfig())
    b, tb = run_scenario(wl, cl, pol, trace=trace.cpu(), device="cpu", telemetry=TelemetryConfig())
    assert a.hit_rate == b.hit_rate and a.replication_moves == b.replication_moves
    np.testing.assert_array_equal(ta.hist_group, tb.hist_group)
    np.testing.assert_array_equal(ta.chunk_hist, tb.chunk_hist)
    np.testing.assert_allclose(ta.load_factor, tb.load_factor, rtol=1e-6)
    np.testing.assert_allclose(ta.mean_latency_ms, tb.mean_latency_ms, rtol=1e-5)


def _gather_inputs(v, r, d, t, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    slot_map = np.full(v, -1, np.int32)
    slot_map[rng.choice(v, r, replace=False)] = np.arange(r, dtype=np.int32)
    table = torch.from_numpy(rng.standard_normal((r, d)).astype(np.float32)).to(device, dtype)
    return (torch.from_numpy(rng.integers(0, v, t).astype(np.int32)).to(device),
            torch.from_numpy(slot_map).to(device), table)


@pytest.mark.cuda
@pytest.mark.parametrize("v,r,d,t", [(5_000, 64, 256, 333), (1_024, 8, 64, 128), (300, 5, 3, 77)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hot_gather_kernel_matches_plain_version(cuda, v, r, d, t, dtype):
    from repro_torch.kernels.hot_gather.ops import hot_gather
    from repro_torch.kernels.hot_gather.ref import hot_gather_ref

    args = _gather_inputs(v, r, d, t, dtype, cuda)
    rows, hit = hot_gather(*args)
    want_rows, want_hit = hot_gather_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(hit, want_hit) and torch.equal(rows, want_rows)
    table = args[2].clone().requires_grad_(True)
    hot_gather(args[0], args[1], table)[0].float().sum().backward()
    counts = torch.bincount(args[1][args[0].long()][hit].long(), minlength=r).to(dtype)
    assert torch.equal(table.grad, counts[:, None].expand(r, d))


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,k,group", [(512, 64, 6, 128), (300, 32, 8, 128), (1024, 8, 2, 256),
                                         (32_768, 64, 6, 512)])
def test_moe_router_kernel_matches_plain_version(cuda, t, e, k, group):
    from repro_torch.kernels.moe_router.ops import moe_router
    from repro_torch.kernels.moe_router.ref import router_ref

    logits = torch.from_numpy(np.random.default_rng(t).standard_normal((t, e)).astype(np.float32)).to(cuda)
    gates, ids, counts = moe_router(logits, k=k, group=group)
    want = router_ref(logits, k, group)
    torch.cuda.synchronize()
    assert torch.equal(ids, want[1]) and torch.equal(counts, want[2])
    torch.testing.assert_close(gates, want[0], rtol=1e-6, atol=0)
    assert float(counts.sum()) == t * k


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,k", [(512, 64, 6), (300, 32, 8), (1024, 8, 8)])
def test_moe_router_gates_carry_the_gradient_on_the_card(cuda, t, e, k):
    """The kernel's gates through the wrapper's ``autograd.Function``: the
    closed-form backward equals autograd through the plain version on the
    same logits (f32 sums in another order: rtol 1e-5)."""
    from repro_torch.kernels.moe_router.ops import moe_router
    from repro_torch.kernels.moe_router.ref import router_ref

    rng = np.random.default_rng(t + k)
    x = torch.from_numpy(rng.standard_normal((t, e)).astype(np.float32)).to(cuda)
    dg = torch.from_numpy(rng.standard_normal((t, k)).astype(np.float32)).to(cuda)
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    gates, ids, _ = moe_router(a, k=k, group=t)
    assert gates.requires_grad and not ids.requires_grad
    (gates * dg).sum().backward()
    (router_ref(b, k, t)[0] * dg).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)


def _replay_inputs(b, k, n, device, seed):
    """A random map (a tenth of the keys with no replica), requests, a
    random RTT matrix of whole ms with a zero diagonal, and extra_ms."""
    rng = np.random.default_rng(seed)
    hosts = rng.random((k, n)) < 0.4
    hosts[rng.random(k) < 0.1] = False
    rtt = rng.integers(1, 300, (n, n)).astype(np.float32)
    np.fill_diagonal(rtt, 0.0)
    arrays = (hosts, rng.integers(0, k, b).astype(np.int32), rng.integers(0, n, b).astype(np.int32),
              rng.random(b) < 0.8, rng.random(b) < 0.9, rtt, rng.uniform(0, 30, b).astype(np.float32))
    return [torch.from_numpy(a).to(device) for a in arrays]


def _replay_equal(got, want, exact_sums):
    for i in (2, 3, 4):
        assert int(got[i]) == int(want[i]), i
    if exact_sums:  # whole-ms latencies, sums below 2**24: the f64 sums are exact
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    assert (got[5] is None) == (want[5] is None)
    if got[5] is not None:
        assert torch.equal(got[5], want[5])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 257, 10_000, 10_003, 100_003, 2_000_003])
@pytest.mark.parametrize("n", [3, 5, 64])
@pytest.mark.parametrize("bins,extra", [(0, False), (0, True), (128, False), (128, True)])
def test_chunk_replay_one_launch_matches_plain_version(cuda, b, n, bins, extra):
    """B of one request, a vector tail (10,003), one cluster launch (up to
    16,384 requests on up to 8 nodes), a one-step grid launch (100,003, and
    N 64 at every B) and a grid-stride launch (2,000,003): the combine
    across blocks both ways; N 3 and 5 (the replica-set tables) and 64;
    histogram and extra_ms on and off, the per-request outputs given with
    extra_ms. Two calls on the same inputs give the same bits, each one
    kernel launch."""
    from repro_torch.kernels.chunk_replay.ops import chunk_replay
    from repro_torch.kernels.chunk_replay.ref import chunk_replay_ref

    hosts, keys, nodes, is_read, valid, rtt, extra_ms = _replay_inputs(b, 100_003, n, cuda, b + n)
    kw = dict(service_ms=10.0, master=n // 2, xfer_read_ms=2.0, xfer_write_ms=3.0, read_mode="map",
              num_bins=bins, extra_ms=extra_ms if extra else None)
    outs = [(torch.empty(b, device=cuda), torch.empty(b, dtype=torch.bool, device=cuda))
            for _ in range(3)] if extra else [(None, None)] * 3
    args = (hosts, keys, nodes, is_read, valid, rtt)
    before = chunk_replay.launches
    got = chunk_replay(*args, **kw, lat_out=outs[0][0], hit_out=outs[0][1])
    again = chunk_replay(*args, **kw, lat_out=outs[1][0], hit_out=outs[1][1])
    want = chunk_replay_ref(*args, **kw, lat_out=outs[2][0], hit_out=outs[2][1])
    torch.cuda.synchronize()
    assert chunk_replay.launches == before + 2
    _replay_equal(got, want, exact_sums=not extra)
    for x, y in zip(got, again):
        assert (x is None and y is None) or torch.equal(x, y)
    if extra:
        for lat, hit in outs[:2]:
            assert torch.equal(lat, outs[2][0]) and torch.equal(hit, outs[2][1])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [10_003, 100_003])
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("mode", ["map", "no_local", "ideal"])
def test_chunk_replay_unaligned_views_match_plain_version(cuda, b, offset, mode):
    """Views at odd offsets (requests and map): the kernel's scalar loads
    and byte-wise map rows, in a cluster launch (10,003 requests) and a
    grid launch (100,003)."""
    from repro_torch.kernels.chunk_replay.ops import chunk_replay, vector_io
    from repro_torch.kernels.chunk_replay.ref import chunk_replay_ref

    k, n = 30_001, 5
    hosts, keys, nodes, is_read, valid, rtt, extra_ms = _replay_inputs(b + offset, k + 1, n, cuda, offset)
    flat = torch.cat([torch.zeros(offset, dtype=torch.bool, device=cuda), hosts[:k].reshape(-1)])
    view_hosts = flat[offset:].view(k, n)
    view = [x[offset:] for x in (keys, nodes, is_read, valid, extra_ms)]
    view[0] = view[0].clamp_max(k - 1)
    assert not vector_io([view[0].data_ptr()], [view[2].data_ptr()])
    kw = dict(service_ms=10.0, master=1, xfer_read_ms=2.0, xfer_write_ms=3.0, read_mode=mode,
              num_bins=128, extra_ms=view[4])
    outs = [(torch.empty(b + 1, device=cuda)[1:], torch.empty(b + 1, dtype=torch.bool, device=cuda)[1:])
            for _ in range(2)]
    args = (view_hosts, *view[:4], rtt)
    got = chunk_replay(*args, **kw, lat_out=outs[0][0], hit_out=outs[0][1])
    want = chunk_replay_ref(*args, **kw, lat_out=outs[1][0], hit_out=outs[1][1])
    torch.cuda.synchronize()
    _replay_equal(got, want, exact_sums=False)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def _router_logits(t, e, rng, ties):
    """Logits whose softmax has no two picks within an ulp: each row a
    permutation of a 0.03-spaced ladder plus a row offset. With ``ties``,
    whole numbers 0..3: many exact ties, which must break to the lower id."""
    if ties:
        return rng.integers(0, 4, (t, e)).astype(np.float32)
    ladder = np.tile(np.arange(e, dtype=np.float32) * 0.03, (t, 1))
    return rng.permuted(ladder, axis=1) + rng.standard_normal((t, 1)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("t,group", [(1_000, 300), (4_099, 512), (777, 7)])
@pytest.mark.parametrize("e", [32, 64, 128, 256])
@pytest.mark.parametrize("k", [1, 6, 8])
@pytest.mark.parametrize("ties", [False, True])
def test_moe_router_row_tiles_match_plain_version(cuda, t, group, e, k, ties):
    """T not a multiple of the row tile nor of the group, groups shorter
    than a block (7), E 32 to 256, k 1 to 8: ids and counts exact (no near
    ties in these logits; planted exact ties go to the lower id), gates to
    1e-6 relative; one launch a call, and the count scratch left zero (a
    second call gives the same counts)."""
    from repro_torch.kernels.moe_router.ops import moe_router
    from repro_torch.kernels.moe_router.ref import router_ref

    logits = torch.from_numpy(_router_logits(t, e, np.random.default_rng(t + e + k), ties)).to(cuda)
    before = moe_router.launches
    gates, ids, counts = moe_router(logits, k=k, group=group)
    again = moe_router(logits, k=k, group=group)
    want = router_ref(logits, k, group)
    torch.cuda.synchronize()
    assert moe_router.launches == before + 2
    assert torch.equal(ids, want[1]) and torch.equal(counts, want[2])
    torch.testing.assert_close(gates, want[0], rtol=1e-6, atol=0)
    assert all(torch.equal(x, y) for x, y in zip((gates, ids, counts), again))
    assert counts.shape == (-(-t // group), e) and float(counts.sum()) == t * k


@pytest.mark.cuda
def test_ownership_sweep_kernel_takes_f32_traffic(cuda):
    from repro_torch.kernels.ownership_sweep.ops import ownership_sweep
    from repro_torch.kernels.ownership_sweep.ref import sweep_ref

    rng = np.random.default_rng(3)
    k, n = 1_792, 4
    counts = (rng.integers(0, 50, (k, n)) * 0.98 ** 3).astype(np.float32)
    counts[rng.random(k) < 0.2] = 0
    args = [torch.from_numpy(a).to(cuda) for a in (
        counts, np.zeros((k, n), bool), np.ones(k, bool), np.zeros(k, np.int32))]
    got = ownership_sweep(*args, 0, h=0.25)
    want = sweep_ref(*args, 0, h=0.25)
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    torch.testing.assert_close(got[4], want[4], rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("counts_dtype", ["int32", "f32"])
@pytest.mark.parametrize("k,n,offset",
                         [(1_000, 3, 0), (3_333, 7, 0), (1_023, 5, 1), (17, 3, 0), (5_000, 4, 3)])
def test_ownership_sweep_tiles_match_plain_version(cuda, k, n, offset, counts_dtype):
    """Keys not a multiple of the block tile; N of 3 and 7, whose byte
    planes are not whole 16-byte vectors; arrays starting off a 16-byte
    boundary (a sliced view); f at or next to H = 1 / N on f32 traffic
    (rows of equal counts). Every output exact."""
    from repro_torch.kernels.ownership_sweep.ops import ownership_sweep
    from repro_torch.kernels.ownership_sweep.ref import sweep_ref

    rng = np.random.default_rng(k + n)
    rows = k + offset
    if counts_dtype == "f32":
        counts = (rng.integers(0, 50, (rows, n)) * 0.98 ** 3).astype(np.float32)
        counts[rng.random(rows) < 0.2] = np.float32(0.98 ** 5)  # equal counts: f at or next to H
    else:
        counts = rng.integers(0, 4, (rows, n)).astype(np.int32)
    counts[rng.random(rows) < 0.2] = 0
    arrays = (counts, rng.random((rows, n)) < 0.4, rng.random(rows) < 0.9,
              rng.integers(0, 10, rows).astype(np.int32))
    args = [torch.from_numpy(a).to(cuda)[offset:] for a in arrays]
    got = ownership_sweep(*args, 9, h=1 / n, expiry=3)
    want = sweep_ref(*args, 9, h=1 / n, expiry=3)
    torch.cuda.synchronize()
    for name, g, w in zip(("owners", "add", "drop", "expired", "f"), got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize(
    "family,what",
    [("ssm", "RWKV"), ("hybrid", "RecurrentGemma"), ("audio", "encoder-decoder"), ("vlm", "vision")],
)
def test_model_families_of_later_slices_raise(family, what):
    # The four families serve (tests/test_torch_families.py) and train: their
    # Model.loss gives a finite loss and a gradient in every leaf (against
    # the reference in tests/test_torch_family_train.py); it raises on
    # quantized params, as every family's does. ``what`` names the stack
    # that the family trains through, in its module's docstring.
    from repro_torch import tree as tree_lib
    from repro_torch.models import encdec, model as model_mod, rglru, rwkv6
    from repro_torch.configs import ShapeConfig
    from repro_torch.kvsim import prng

    arch = {"ssm": "rwkv6-1.6b", "hybrid": "recurrentgemma-2b", "audio": "whisper-base",
            "vlm": "llava-next-34b"}[family]
    stack = {"ssm": rwkv6, "hybrid": rglru, "audio": encdec, "vlm": model_mod}[family]
    assert what in stack.__doc__
    model = Model(reduced(get_config(arch)), "cpu")
    assert model.cfg.family == family
    params = model.init(torch.Generator().manual_seed(0))
    leaves = tree_lib.leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    batch = model.make_batch(ShapeConfig("cell", 32, 2, "train"), prng.prng_key(0))
    loss, met = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert bool(torch.isfinite(loss)) and set(met) == {"xent", "loss"}
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert sum(float(g.float().abs().sum()) for g in grads) > 0
    params["embed"] = {"q": params["embed"].detach().to(torch.int8), "s": torch.ones(1)}
    with pytest.raises(NotImplementedError, match="quantized"):
        model.loss(params, batch)


def test_model_loss_and_quantized_params_raise():
    # Model.loss is ported (tests/test_torch_trainer.py); quantized params
    # raise in it as in prefill.
    model = Model(reduced(get_config("qwen3-1.7b")), "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    params["embed"] = {"q": params["embed"].to(torch.int8), "s": torch.ones(1)}
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="quantized"):
        model.loss(params, {"tokens": tokens, "targets": tokens})
    with pytest.raises(NotImplementedError, match="quantized"):
        model.prefill(params, {"tokens": tokens})


def _attention_inputs(b, s, t, h, kh, dh, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
            for shape in ((b, s, h, dh), (b, t, kh, dh), (b, t, kh, dh))]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,t,h,kh,dh,causal,window",
    [(2, 256, 256, 4, 2, 64, True, 0), (1, 128, 128, 8, 1, 128, True, 0),
     (2, 256, 256, 4, 4, 32, True, 64), (1, 128, 384, 4, 2, 64, False, 0),
     (1, 192, 192, 6, 2, 64, True, 0), (1, 1000, 1000, 16, 8, 128, True, 0),
     (1, 300, 300, 4, 2, 256, True, 100)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_version(cuda, b, s, t, h, kh, dh, causal, window, dtype):
    """tests/test_kernels.py's shapes, a ragged qwen3 prefill and D = 256
    with a window; f32 to 2e-5, bf16 to 2e-2 (that file's bars)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    q, k, v = _attention_inputs(b, s, t, h, kh, dh, dtype, cuda, seed=s + t)
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _scaled_bar(want):
    """chip_smoke.py's output-scaled bf16 bar: 2**-6 of each value plus its
    row's rms over head_dim."""
    w = want.float()
    return 2**-6 * (w.abs() + w.pow(2).mean(dim=-1, keepdim=True).sqrt())


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("q_rows", [64, 128])
@pytest.mark.parametrize(
    "b,s,t,h,kh,causal,window",
    [(1, 1000, 1000, 8, 8, True, 0), (2, 130, 130, 16, 2, True, 0), (1, 700, 700, 8, 4, True, 200),
     (2, 128, 384, 8, 1, False, 0), (1, 200, 77, 4, 2, False, 0), (1, 65, 65, 2, 1, True, 64)],
)
def test_flash_attention_tma_kernel_matches_plain_version(cuda, b, s, t, h, kh, dh, causal, window, q_rows):
    """The TMA/wgmma kernel at D 64, 128 and 256, through both of its q tiles:
    ragged causal S, a window, non-causal T != S (longer and shorter than
    S), GQA groups 1 to 8; bf16 to 2e-2 and to half of the output-scaled bar."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    q, k, v = _attention_inputs(b, s, t, h, kh, dh, torch.bfloat16, cuda, seed=s + t + dh)
    before = fa_ops.flash_attention.launches_by_variant["tma_wgmma"]
    got = fa_ops._launch(q, k, v, causal, window, "tma_wgmma", q_rows)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches_by_variant["tma_wgmma"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert float(((got.float() - want.float()).abs() / _scaled_bar(want)).max()) <= 0.5
    assert torch.equal(fa_ops.flash_attention(q, k, v, causal=causal, window=window),
                       fa_ops._launch(q, k, v, causal, window, "tma_wgmma", fa_ops.q_rows(s, h, b)))


@pytest.mark.cuda
@pytest.mark.parametrize("variant,dtype,dh", [
    ("f32_simt", torch.float32, 64), ("mma_sync", torch.bfloat16, 32), ("mma_sync", torch.bfloat16, 256),
    ("tma_wgmma", torch.bfloat16, 64), ("tma_wgmma", torch.bfloat16, 128), ("tma_wgmma", torch.bfloat16, 256),
])
@pytest.mark.parametrize("b,s,t,h,kh,causal,window", [
    (1, 256, 64, 4, 2, True, 16), (2, 192, 128, 4, 2, False, 24), (1, 1000, 100, 8, 2, True, 30),
])
def test_flash_attention_rows_without_keys_are_the_mean_of_v(cuda, variant, dtype, dh, b, s, t, h, kh,
                                                            causal, window):
    """window > 0 and T + window <= S: rows i >= T + window - 1 see no key,
    in q tiles with no kv tile to visit and inside tiles that visit some.
    Every variant (the TMA one through both q tiles) gives them the mean of
    v over T, as the plain version does; f32 to 2e-5, bf16 to 2e-2 and, for
    the TMA kernel, to half of the output-scaled bar. ``mma_sync`` at D 256,
    no longer the dispatch's choice there, is launched by name."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    named = (variant, dh) == ("mma_sync", 256)
    assert (fa_ops.variant(dtype, dh) == variant) != named and fa_ops.has_empty_rows(s, t, window)
    q, k, v = _attention_inputs(b, s, t, h, kh, dh, dtype, cuda, seed=s + t + dh)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    tiles = (64, 128) if variant == "tma_wgmma" else (None,)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    first = t + window - 1
    mean_v = v.float().mean(dim=1).repeat_interleave(h // kh, dim=1)[:, None].expand(b, s - first, h, dh)
    for rows in tiles:
        got = fa_ops._launch(q, k, v, causal, window, variant, rows)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(got[:, first:].float(), mean_v, atol=tol, rtol=tol)
        if variant == "tma_wgmma":
            assert float(((got.float() - want.float()).abs() / _scaled_bar(want)).max()) <= 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,kh,dh", [(2, 1024, 8, 2, 64), (4, 512, 4, 1, 128),
                                         (2, 768, 16, 16, 32), (16, 8192, 16, 8, 128),
                                         (3, 700, 12, 1, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain_version(cuda, b, t, h, kh, dh, dtype):
    """tests/test_kernels.py's shapes, the serving shape, G = 12 at D = 256
    (one block holds the 12 heads); lengths random with 1 and one past T,
    and 0 (every position masked: the mean of v) where there are three
    sequences or more."""
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref

    rng = np.random.default_rng(t)
    q = torch.from_numpy(rng.standard_normal((b, h, dh)).astype(np.float32)).to(cuda, dtype)
    _, k, v = _attention_inputs(b, 1, t, h, kh, dh, dtype, cuda, seed=t)
    lengths = rng.integers(1, t, b).astype(np.int32)
    lengths[0], lengths[-1] = 1, t + 5
    if b > 2:
        lengths[1] = 0
    lengths = torch.from_numpy(lengths).to(cuda)
    got = flash_decode(q, k, v, lengths)
    want = flash_decode_ref(q, k, v, lengths)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,g", [(8, 2048, 10, 10), (5, 1000, 16, 16), (2, 300, 40, 20)])
@pytest.mark.parametrize("split", [None, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_holds_the_groups_of_recurrentgemma(cuda, b, t, h, g, split, dtype):
    """recurrentgemma-2b's group of 10 q heads a kv head at D 256 (its rings
    are 2,048 slots), a group of 16 and one of 20 (two head groups of 10);
    lengths 0, 1, T + 7, T and random; the split rule's splits and longer
    and shorter ones, so rows of one split, of a few and of 32 are merged.
    One launch a call; the result is the same bits call after call, and the
    merge's counters are 0 after it."""
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref

    rng = np.random.default_rng(t + g)
    kh = h // g
    q = torch.from_numpy(rng.standard_normal((b, h, 256)).astype(np.float32)).to(cuda, dtype)
    _, k, v = _attention_inputs(b, 1, t, h, kh, 256, dtype, cuda, seed=t + g)
    lengths = rng.integers(1, t, b).astype(np.int32)
    lengths[:4] = (0, 1, t + 7, t)[:b]
    lengths = torch.from_numpy(lengths).to(cuda)
    before = fd_ops.flash_decode.launches
    got = fd_ops._launch(q, k, v, lengths, split)
    again = fd_ops._launch(q, k, v, lengths, split)
    want = flash_decode_ref(q, k, v, lengths)
    torch.cuda.synchronize()
    assert fd_ops.flash_decode.launches == before + 2
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(got, again)
    mean_v = v[0].float().mean(dim=0).repeat_interleave(g, dim=0)  # length 0: the mean of v
    torch.testing.assert_close(got[0].float(), mean_v, atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        assert float(((got.float() - want.float()).abs() / _scaled_bar(want)).max()) <= 1.0
    assert all(int(buf.abs().sum()) == 0 for buf in fd_ops._counters.values())


@pytest.mark.cuda
def test_serving_on_card_matches_cpu(cuda):
    """The reduced qwen3 engine on the card against the same engine on the
    CPU (plain versions), same params: every sampling call's logits to the
    bf16 bar, teacher-forced with the CPU engine's tokens."""
    from repro_torch.serving import Request, ServeEngine

    cfg = reduced(get_config("qwen3-1.7b"))
    cpu_params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    cpu_eng = ServeEngine(Model(cfg, "cpu"), cpu_params, num_lanes=2, cache_len=48)
    eng = ServeEngine(Model(cfg, cuda), to(cpu_params, cuda), num_lanes=2, cache_len=48)
    want, got = [], []
    cpu_sample = cpu_eng._sample

    def record(logits):
        want.append(logits)
        return cpu_sample(logits)

    def forced(logits):
        got.append(logits.cpu())
        return cpu_sample(want[len(got) - 1]).to(cuda)

    cpu_eng._sample, eng._sample = record, forced
    rng = np.random.default_rng(0)
    steps = [("a", rng.integers(0, cfg.vocab_size, 37), 6), None,
             ("b", rng.integers(0, cfg.vocab_size, 20), 4)]
    for item in steps:
        for e in (cpu_eng, eng):
            if item is None:
                e.step()
            else:
                e.admit(Request(item[0], item[1], max_new=item[2]))
    while cpu_eng.step():
        eng.step()
    assert len(got) == len(want) == 8  # two admits and six steps
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-2, rtol=2e-2)


def _window_cases():
    """(workload, start, count) of the ``trace_window`` cases: uniform and
    skewed, region weights, diurnal, read fractions 0.5 and 1.0, one and
    five nodes, a window past the trace, a window at 2**30."""
    from repro_torch.kvsim.workload import diurnal_workload, wan5_workload

    return {
        "uniform": (WorkloadConfig(num_requests=100_000, num_keys=5_000, read_fraction=0.5), 0, 100_000),
        "one_node": (WorkloadConfig(num_requests=50_000, num_keys=999, num_nodes=1, skewed=True,
                                    affinity=0.3), 123, 40_000),
        "wan5": (wan5_workload(num_requests=1_000_000, num_keys=100_000, affinity=0.8,
                               read_fraction=1.0), 10_000, 30_000),
        "diurnal_past_end": (diurnal_workload(num_requests=25_000, num_keys=2_000, affinity=0.7,
                                              read_fraction=0.7), 20_000, 10_000),
        "far": (diurnal_workload(num_requests=2**31 - 1, num_keys=1_000_000, affinity=0.8,
                                 read_fraction=0.9), 2**30, 65_537),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "one_node", "wan5", "diurnal_past_end", "far"])
def test_trace_window_kernel_matches_plain_version(cuda, case):
    from repro_torch.kernels.trace_window.ops import trace_window
    from repro_torch.kernels.trace_window.ref import trace_window_ref
    from repro_torch.kvsim.workload import generate_key_state, window_params

    wl, start, count = _window_cases()[case]
    params = window_params(wl, 7)
    natural = generate_key_state(wl, 7, device="cpu")[0]
    got = trace_window(start, count, params, natural.to(cuda))
    want = trace_window_ref(start, count, params, natural)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w), case


@pytest.mark.cuda
@pytest.mark.parametrize("num_bins", [64, 96])
def test_attribution_fold_through_latency_histogram_matches_plain_version(cuda, num_bins):
    """The attribution fold on the card (the ``latency_histogram`` kernel at
    the attribution bin rule, 8 x 2N groups a chunk; per-chunk launches a
    component over a trace) against the plain version, and the rule's
    threshold count against ``bin_of`` on every float."""
    from repro_torch.kernels.latency_histogram.ops import check_bin_rule
    from repro_torch.kvsim.telemetry import attribution_chunk_hist, attribution_trace_hist

    rng = np.random.default_rng(num_bins)
    r, n = 40_000, 5
    comps = np.exp(rng.uniform(np.log(1e-3), np.log(1e5), (8, r))).astype(np.float32)
    comps[rng.random((8, r)) < 0.3] = 0.0
    group = rng.integers(0, 2 * n, r).astype(np.int32)
    weight = (rng.random(r) < 0.9).astype(np.float32)
    acfg = AttributionConfig(num_bins=num_bins)
    cpu = [torch.from_numpy(a) for a in (comps, group, weight)]
    dev = [t.to(cuda) for t in cpu]
    assert torch.equal(attribution_chunk_hist(*dev, acfg, n).cpu(), attribution_chunk_hist(*cpu, acfg, n))
    assert torch.equal(attribution_trace_hist(*dev, acfg, n, rows_per_chunk=9_999).cpu(),
                       attribution_trace_hist(*cpu, acfg, n, rows_per_chunk=9_999))
    assert check_bin_rule(acfg.lo_ms, acfg.hi_ms, num_bins, cuda) == (0, None)


# The families of the training slice (reduced configs; the CPU parity with
# the reference is tests/test_torch_family_train.py): case -> (arch, config
# overrides, token rows a sequence).
FAMILY_TRAIN_CASES = {
    "ssm": ("rwkv6-1.6b", {}, 64),
    "hybrid": ("recurrentgemma-2b", {"attn_chunk": 32}, 160),
    "audio": ("whisper-base", {}, 24),
    "audio_padded": ("whisper-base", {"num_frames": 40, "attn_chunk": 16}, 24),
    "vlm": ("llava-next-34b", {}, 48),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FAMILY_TRAIN_CASES))
def test_family_loss_on_the_card_matches_plain_versions(cuda, case, monkeypatch):
    """``Model.loss`` and every gradient on the card, through ``hot_gather``
    (where the config has a hot-row cache holding the batch's 8 most
    frequent tokens) and through its plain version with the wrapper's own
    backward, on the same bf16 params and batch, at ``chip_smoke.py`` phase
    13's bars: the loss within 1e-3 relative and every leaf's gradient
    within 5e-2 relative L2 (a hit row equals the table's row, so the two
    differ only where the card's atomic adds of the embedding's backward run
    in another order); all finite, ``embed``'s nonzero; one ``hot_gather``
    launch a loss where there is a cache."""
    import repro_torch.core.hot_embedding as he_mod
    from repro_torch import tree as tree_lib
    from repro_torch.kernels.hot_gather import ops as hg_ops
    from repro_torch.kernels.hot_gather.ref import hot_gather_ref

    arch, over, seq = FAMILY_TRAIN_CASES[case]
    cfg = reduced(get_config(arch), remat="full", **over)
    model = Model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    leaves = tree_lib.leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 64, (2, seq)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks).to(cuda),
             "targets": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)).to(cuda)}
    extra = {"vlm": ("patches", cfg.num_patches), "audio": ("frames", cfg.num_frames)}.get(cfg.family)
    if extra:
        batch[extra[0]] = torch.from_numpy(rng.standard_normal((2, extra[1], cfg.d_model)).astype(np.float32)
                                           ).to(cuda, torch.bfloat16)
    he = None
    if cfg.hot_embed_rows:
        vals, cnt = np.unique(toks, return_counts=True)
        hot = vals[np.argsort(-cnt, kind="stable")][:8].astype(np.int32)
        hot_ids = np.full(cfg.hot_embed_rows, -1, np.int32)
        hot_ids[: len(hot)] = hot
        slot_map = np.full(cfg.padded_vocab, -1, np.int32)
        slot_map[hot] = np.arange(len(hot), dtype=np.int32)
        he = hot_embedding_state_from_numpy(np.zeros((cfg.padded_vocab, 1), np.float32), hot_ids, slot_map,
                                            np.zeros((), np.int32), device=cuda)

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, tok, smap, table):
            rows, hit = hot_gather_ref(tok, smap, table)
            ctx.save_for_backward(tok, smap)
            ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
            ctx.mark_non_differentiable(hit)
            return rows, hit

        backward = hg_ops._HotGather.backward

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    before = hg_ops.hot_gather.launches
    loss_k, _ = model.loss(params, batch, hot_embed=he)
    grads_k = torch.autograd.grad(loss_k, leaves)
    assert hg_ops.hot_gather.launches - before == (0 if he is None else 1)
    monkeypatch.setattr(he_mod, "hot_gather", Plain.apply)
    loss_p, _ = model.loss(params, batch, hot_embed=he)
    grads_p = torch.autograd.grad(loss_p, leaves)
    assert bool(torch.isfinite(loss_k)) and abs(float(loss_k) - float(loss_p)) <= 1e-3 * abs(float(loss_p))
    for a, b in zip(grads_k, grads_p):
        assert bool(torch.isfinite(a).all()) and rel(a, b) <= 5e-2
    paths = [path for path, _ in tree_lib.leaves_with_paths(params)]
    assert float(grads_k[paths.index((("key", "embed"),))].float().abs().sum()) > 0
