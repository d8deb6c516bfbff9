"""The port's flight-recorder export (``kvsim/tracing.py``) against the
reference's on the same records, and on the records of a run: the JSON
lines and the Chrome trace-event document, byte for byte but for the tag
in ``otherData.source`` that names the package that wrote the document."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.kvsim.tracing as jtr  # noqa: E402
import repro_torch.kvsim as tk  # noqa: E402
import repro_torch.kvsim.tracing as ttr  # noqa: E402


def _warm_exp():
    """PyTorch's CPU ``exp`` can return values off by ~1e-4 on its first
    call in a process (about one process in eight); one call first avoids it."""
    torch.exp(torch.zeros(1))


_warm_exp()


def _records(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        comps = {name: float(np.float32(rng.exponential(5.0)) * (rng.random() < 0.6))
                 for name in tk.COMPONENTS}
        out.append(dict(pos=int(i * 37), chunk=int(i // 8), key=int(rng.integers(0, 500)),
                        node=int(rng.integers(0, 5)), router=int(rng.integers(-1, 5)),
                        is_read=bool(rng.random() < 0.7), total_ms=float(sum(comps.values())),
                        components=comps))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_exports_equal_the_reference_on_the_same_records(seed, tmp_path):
    records = _records(seed)
    assert _retagged(ttr.chrome_trace_events(records)) == jtr.chrome_trace_events(records)
    for writer in ("write_jsonl", "write_chrome_trace"):
        got, want = tmp_path / f"{writer}_port", tmp_path / f"{writer}_ref"
        assert getattr(ttr, writer)(records, str(got)) == getattr(jtr, writer)(records, str(want))
        assert got.read_bytes().replace(PORT_TAG, REF_TAG) == want.read_bytes(), writer


PORT_TAG, REF_TAG = b"repro_torch.kvsim flight recorder", b"repro.kvsim flight recorder"


def _retagged(doc):
    return {**doc, "otherData": {**doc["otherData"], "source": REF_TAG.decode()}}


def test_exports_of_a_run_load_back():
    _, trace = tk.run_scenario(
        tk.wan5_workload(num_requests=4_000, num_keys=200),
        tk.wan5_cluster()._replace(routing=tk.RoutingConfig(publish_lag_chunks=1, cache_entries=20)),
        tk.RedynisPolicy(), daemon_interval=500, device="cpu",
        telemetry=tk.TelemetryConfig(flight=tk.FlightRecorderConfig(samples_per_chunk=4)))
    records = trace.flight_records()
    assert len(records) == 32 and all(r["router"] >= 0 for r in records)
    doc = json.loads(json.dumps(ttr.chrome_trace_events(records)))
    events = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(events) == 32 and _retagged(doc) == jtr.chrome_trace_events(records)
    assert doc["otherData"]["source"] == PORT_TAG.decode()
    assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)
