"""The scenario path's spans and counters (``repro_torch.obs``): recorded
only while a ``torch.profiler`` session collects, nested as the module's
docstring lists them, counting the chunks and sweeps of the run, and
leaving every result bit for bit as it was.

CPU, 2,000 keys in chunks of 1,000, a few seconds in all. The ``cuda`` case
runs on a card: ``python3 -m pytest -m cuda tests/test_torch_obs.py``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from repro_torch import obs
from repro_torch.kvsim import (
    AttributionConfig,
    FaultConfig,
    FaultEvent,
    FlightRecorderConfig,
    RedynisPolicy,
    RoutingConfig,
    ServiceConfig,
    StaticPolicy,
    TelemetryConfig,
    WorkloadConfig,
    run_scenario,
    run_scenario_reference,
    wan5_cluster,
)

KEYS, CHUNK, CHUNKS = 2000, 1000, 10
PARENT = {
    "chunk": "scenario", "static_replay": "scenario",
    **dict.fromkeys(["fault_prepass", "routing_prepass", "contention_prepass",
                     "attribution_components", "chunk_replay", "fault_counters", "occupancy",
                     "record_accesses", "policy_step", "repair_accounting", "publish"], "chunk"),
    "attribution_fold": "attribution_components", "flight_recorder": "attribution_components",
    **dict.fromkeys(["decide", "capacity_projection", "count_decay", "sweep_stats"], "policy_step"),
}
# The cells' path: finite budgets, contention and telemetry under Redynis.
CELL_PATH = {"scenario", "chunk", "contention_prepass", "chunk_replay", "occupancy",
             "record_accesses", "policy_step", "decide", "capacity_projection", "count_decay",
             "sweep_stats"}
BUDGET = 400 * 1024.0  # bytes a node: about a fifth of the keys


def _cluster(budget=BUDGET, **kw):
    return wan5_cluster(capacity_bytes=budget,
                        service=ServiceConfig(serve_bytes_per_ms=256.0, capacity_factor=1.0), **kw)


def _run(cluster=None, policy=None, telemetry=TelemetryConfig(), fn=run_scenario):
    wl = WorkloadConfig(num_requests=CHUNKS * CHUNK, num_keys=KEYS, num_nodes=5)
    return fn(wl, _cluster() if cluster is None else cluster, policy or RedynisPolicy(), seed=3,
              daemon_interval=CHUNK, device="cpu", telemetry=telemetry)


def _profiled(fn):
    """``fn()`` in a profiler's warm-up step, then in its active step:
    what each recorded, and the active step's result."""
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        warm = obs.recorded()
        prof.step()
        out = fn()
    return warm, obs.recorded(), out


def _tree(rec):
    """Check that every span lies inside its parent and that the names nest
    as the recorder's docstring lists; return the set of names."""
    spans = rec.spans
    assert spans[0].name == "scenario" and spans[0].parent == -1
    for i, s in enumerate(spans):
        assert s.scenario == rec.id and s.start_ns <= s.end_ns
        if i:
            p = spans[s.parent]
            assert s.parent < i and PARENT[s.name] == p.name, (s.name, p.name)
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    return {s.name for s in spans}


def _equal(a, b):
    """Bit-identical results: every field of the SimResult and SimTrace."""
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, strict=True)
    elif isinstance(a, float):
        assert a == b or (np.isnan(a) and np.isnan(b))
    else:
        assert a == b


def test_the_cells_path_nests_counts_and_changes_no_bit():
    warm, recs, out = _profiled(_run)
    assert warm == [] and len(recs) == 1
    rec = recs[0]
    assert _tree(rec) == CELL_PATH
    names = [s.name for s in rec.spans]
    assert names.count("chunk") == names.count("policy_step") == CHUNKS
    assert rec.counters == dict(chunks=CHUNKS, sweeps=CHUNKS)
    assert out[0].capacity_evictions > 0  # the budgets bind
    _equal(out, _run())


def test_every_tier_nests_and_changes_no_bit():
    cluster = _cluster(routing=RoutingConfig(publish_lag_chunks=2, cache_entries=500),
                       faults=FaultConfig(events=(FaultEvent(target=1, start_chunk=3,
                                                             duration_chunks=2),)))
    tel = TelemetryConfig(attribution=AttributionConfig(), flight=FlightRecorderConfig())
    policy = RedynisPolicy(period=2)
    _, recs, out = _profiled(lambda: _run(cluster, policy, tel))
    (rec,) = recs
    assert _tree(rec) == set(PARENT) - {"static_replay"} | {"scenario"}
    assert rec.counters["sweeps"] == CHUNKS // 2 and rec.counters["chunks"] == CHUNKS
    _equal(out, _run(cluster, policy, tel))


def test_a_frozen_map_and_infinite_budgets():
    _, recs, _ = _profiled(lambda: _run(policy=StaticPolicy(mode="replicated")))
    assert _tree(recs[0]) == {"scenario", "static_replay"}
    assert recs[0].counters == dict(chunks=CHUNKS, sweeps=0)
    _, recs, _ = _profiled(lambda: _run(_cluster(budget=float("inf")), telemetry=None))
    assert _tree(recs[0]) == CELL_PATH - {"capacity_projection"}
    assert recs[0].counters == dict(chunks=CHUNKS, sweeps=CHUNKS)


def test_nothing_records_without_a_collecting_profiler():
    obs.reset()
    _run()
    assert obs.recorded() == []
    warm, recs, _ = _profiled(lambda: _run(fn=run_scenario_reference))
    assert warm == [] and recs == []
    assert obs.span("chunk") is obs.span("decide")  # the one shared no-op context
    r = range(3)
    assert obs.each("chunk", r) is r


def test_the_root_span_keeps_run_scenarios_name_signature_and_docstring():
    import inspect

    plain = run_scenario.__wrapped__
    assert run_scenario.__name__ == "run_scenario" and run_scenario.__doc__ == plain.__doc__
    assert inspect.signature(run_scenario) == inspect.signature(plain)


@pytest.mark.cuda
def test_spans_and_the_cards_records_share_a_clock():
    """A span around one kernel launch encloses the profiler's runtime
    record of the launch, and the kernel starts on the device after the
    span started: the profiler's host and device records are on the clock
    the spans read."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.autograd import DeviceType

    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    obs.reset()
    # As the benchmark traces: CUDA activity only, a warm-up step first.
    prof = profile(activities=[ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1))
    prof.start()
    (x * 2).sum()
    torch.cuda.synchronize()
    prof.step()
    with obs.scenario():
        with obs.span("launch"):
            x.mul_(3)
    torch.cuda.synchronize()
    prof.stop()
    (rec,) = obs.recorded()
    span = next(s for s in rec.spans if s.name == "launch")
    events = list(prof.profiler.kineto_results.events())
    launches = [e for e in events if e.name().startswith(("cudaLaunch", "cuLaunch"))]
    assert len(launches) == 1, [e.name() for e in events]
    launch = launches[0]
    kernel = next(e for e in events if e.device_type() == DeviceType.CUDA
                  and e.correlation_id() == launch.correlation_id())
    launch_end = launch.start_ns() + launch.duration_ns()
    assert span.start_ns <= launch.start_ns() <= launch_end <= span.end_ns
    assert kernel.start_ns() >= span.start_ns
