"""Package rules of the port, and its kernels on the card.

The CPU cases check that ``repro_torch`` stands alone (no JAX, nothing of
``repro``), that its entry points refuse to fall back to the CPU, and that
inputs outside this slice raise ``NotImplementedError``. The ``cuda`` cases
hold each CUDA kernel against its plain version; they skip where there is
no card and run on one with ``python -m pytest -m cuda tests/test_torch_package.py``.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import create_store  # noqa: E402
from repro_torch.interop import store_from_numpy, trace_from_numpy  # noqa: E402
from repro_torch.kvsim import (  # noqa: E402
    ClusterConfig,
    RedynisPolicy,
    ServiceConfig,
    StaticPolicy,
    TelemetryConfig,
    WorkloadConfig,
    generate_trace,
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
    "repro_torch.kernels._build",
    "repro_torch.kernels.chunk_replay.ops",
    "repro_torch.kernels.chunk_replay.ref",
    "repro_torch.kernels.latency_histogram.ops",
    "repro_torch.kernels.latency_histogram.ref",
    "repro_torch.kernels.ownership_sweep.ops",
    "repro_torch.kernels.ownership_sweep.ref",
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
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
    ],
    ids=["generate_trace", "create_store", "rtt_matrix", "trace_from_numpy", "store_from_numpy"],
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


class _SubConfig:
    """Stands in for the reference's AttributionConfig/FlightRecorderConfig."""

    enabled = True


@pytest.mark.parametrize(
    "cluster,kwargs,what",
    [
        (ClusterConfig(routing=object()), {}, "routing"),
        (ClusterConfig(faults=object()), {}, "faults"),
        (ClusterConfig(capacity_bytes=4096.0), {}, "capacity_bytes"),
        (ClusterConfig(), {"telemetry": TelemetryConfig(attribution=_SubConfig())}, "attribution"),
        (ClusterConfig(), {"telemetry": TelemetryConfig(flight=_SubConfig())}, "flight"),
        (ClusterConfig(), {"trace_mode": "streamed"}, "streamed"),
        (ClusterConfig(), {"num_shards": 2}, "num_shards"),
    ],
    ids=["routing", "faults", "capacity", "attribution", "flight", "streamed", "shards"],
)
def test_out_of_slice_inputs_raise(cluster, kwargs, what):
    with pytest.raises(NotImplementedError, match=what):
        run_scenario(
            WorkloadConfig(num_requests=100, num_keys=10), cluster, RedynisPolicy(),
            device="cpu", **kwargs,
        )


def test_interop_rejects_uncovered_cluster_fields():
    from repro_torch.interop import cluster_from_fields

    assert cluster_from_fields(**ClusterConfig()._asdict()) == ClusterConfig()
    carried = cluster_from_fields(service=ServiceConfig(serve_bytes_per_ms=128.0))
    assert carried.service == ServiceConfig(serve_bytes_per_ms=128.0)
    with pytest.raises(NotImplementedError, match="routing"):
        cluster_from_fields(routing=object())


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
