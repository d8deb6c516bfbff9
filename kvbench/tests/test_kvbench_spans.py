"""The program's spans joined to a traced window (``kvbench/spans.py``) and
the per-layer metrics read from them, on a synthetic window and a synthetic
recording: the correlation join to the innermost span, the host's own time
without its runtime calls, the device's idle time inside and outside the
chunk loop, the device time no span holds (none, on the card), and a
metric with nothing to read left out. The ``cuda`` case runs on a card:
``python3 -m pytest -m cuda kvbench/tests/test_kvbench_spans.py``."""

import importlib.util
from pathlib import Path

import pytest

from kvbench import profile, run, spans
from repro_torch.obs import ScenarioRecord, Span

HERE = Path(__file__).resolve().parents[1]
METRICS = ["sweep_device_ms", "projection_device_ms", "request_path_device_ms",
           "host_self_ms_per_tick", "idle_in_loop_pct"]


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _record(rid, rows, counters):
    """A ScenarioRecord from ``(name, parent, start, end)`` rows."""
    return ScenarioRecord(rid, [Span(n, rid, p, s, e) for n, p, s, e in rows], counters)


def _scenario(rid=0, t=0, projection=True):
    """Two ticks, each a replay and a due policy step (with or without the
    capacity projection), after the scenario's set-up and before its
    epilogue."""
    rows = [("scenario", -1, t, t + 1000)]
    for lo in (100, 500):
        c = len(rows)
        # the second replay starts on its chunk's first ns, as a child may
        replay = (lo + 20, lo + 100) if lo == 100 else (lo, lo + 100)
        rows += [("chunk", 0, t + lo, t + lo + 400),
                 ("chunk_replay", c, t + replay[0], t + replay[1]),
                 ("policy_step", c, t + lo + 120, t + lo + 380),
                 ("decide", c + 2, t + lo + 130, t + lo + 200)]
        if projection:
            rows.append(("capacity_projection", c + 2, t + lo + 200, t + lo + 350))
    counters = dict(chunks=2, sweeps=2)
    return _record(rid, rows, counters)


# The runtime calls (name, start, end, correlation) and what they launched.
RUNTIME = [
    ("cudaLaunchKernel", 10, 20, 1),  # scenario, its set-up
    ("cudaLaunchKernel", 130, 150, 2),  # chunk_replay
    ("cudaLaunchKernel", 210, 215, 3),  # chunk, between its children
    ("cudaLaunchKernel", 240, 260, 4),  # decide
    ("cudaLaunchKernel", 310, 330, 5),  # capacity_projection
    ("cudaLaunchKernel", 460, 470, 6),  # policy_step, after its children
    ("cudaLaunchKernel", 500, 510, 7),  # the second chunk_replay, at its chunk's first ns
    ("cudaLaunchKernel", 640, 650, 8),  # decide
    ("cudaLaunchKernel", 710, 720, 9),  # capacity_projection
    ("cudaMemcpyAsync", 910, 990, 10),  # scenario, its epilogue
    ("cudaLaunchKernel", 1100, 1110, 11),  # outside every span
    ("ProfilerStep#1", 0, 2000, 0),  # not a runtime call
]
DEVICE = [("k", 20, 60, 1), ("k", 150, 250, 2), ("k", 250, 260, 3), ("k", 260, 360, 4),
          ("k", 360, 560, 5), ("k", 560, 570, 6), ("k", 570, 620, 7), ("k", 660, 700, 8),
          ("k", 720, 820, 9), ("Memcpy DtoH", 990, 995, 10), ("k", 1110, 1130, 11),
          ("k", 1200, 1210, 99)]  # the last launched by no call the trace holds


def _window(device=DEVICE, runtime=RUNTIME, window_s=2000e-9):
    return profile.Window(list(device), sorted(runtime, key=lambda r: r[1]), window_s, 2,
                          dict(config={}, requests=[]))


@pytest.fixture
def recording(monkeypatch):
    """Install a recording in place of ``repro_torch.obs``'s."""

    def install(records):
        monkeypatch.setattr(spans, "_recorded", lambda: records)

    return install


def test_each_operation_goes_to_the_innermost_span_of_its_launch():
    att = spans.attribute(_window(), [_scenario()])
    # a span's device time holds its children's
    assert att.device_ns == dict(scenario=655, chunk=610, chunk_replay=150, policy_step=450,
                                 decide=140, capacity_projection=300)
    # untraced: the launch outside every span and the one no call holds
    assert att.total_ns == 685 and att.untraced_ns == 20 + 10
    assert att.counters == dict(chunks=2, sweeps=2)


def test_the_stage_metrics_divide_by_the_programs_counters(recording):
    recording([_scenario()])
    win = _window()
    assert _reader("sweep_device_ms")(win) == pytest.approx((450 - 300) / 2 / 1e6)
    assert _reader("projection_device_ms")(win) == pytest.approx(300 / 2 / 1e6)
    # the chunk's own launch between its stages counts to the request path
    assert _reader("request_path_device_ms")(win) == pytest.approx((610 - 450) / 2 / 1e6)


def test_host_self_time_leaves_out_its_runtime_calls(recording):
    recording([_scenario()])
    # the chunks hold [100, 900); runtime calls cover 20 + 5 + 20 + 20 + 10
    # + 10 + 10 + 10 ns of it (the profiler step's annotation is no call)
    att = spans.attribute(_window(), [_scenario()])
    assert (att.chunk_ns, att.chunk_runtime_ns) == (800, 105)
    assert _reader("host_self_ms_per_tick")(_window()) == pytest.approx((800 - 105) / 2 / 1e6)


def test_idle_inside_and_outside_the_chunk_loop(recording):
    recording([_scenario()])
    win = _window()
    # busy inside [100, 900): [150, 620), [660, 700), [720, 820)
    assert spans.attribute(win, [_scenario()]).idle_in_chunk_ns == 800 - 610
    assert _reader("idle_in_loop_pct")(win) == pytest.approx(100.0 * 190 / 2000)
    busy = profile.union_ns([(s, e) for _, s, e, _ in win.device_ops])
    assert _reader("device_idle_pct")(win) == pytest.approx(100.0 * (2000 - busy) / 2000)
    assert _reader("idle_in_loop_pct")(win) < _reader("device_idle_pct")(win)


def test_scenarios_of_another_window_are_not_counted(recording):
    old = _scenario(rid=0, t=-100_000)
    recording([old, _scenario(rid=1)])
    assert spans.attribute(_window()).counters["chunks"] == 2
    assert _reader("sweep_device_ms")(_window()) == pytest.approx((450 - 300) / 2 / 1e6)


def test_no_projection_span_leaves_its_metric_out(recording):
    recording([_scenario(projection=False)])
    win = _window()
    assert _reader("projection_device_ms")(win) is None
    # the projection's launches now fall to the policy step itself
    assert _reader("sweep_device_ms")(win) == pytest.approx(450 / 2 / 1e6)


@pytest.mark.parametrize("name", METRICS)
def test_a_program_without_spans_reads_nothing(recording, name):
    recording(None)
    assert _reader(name)(_window()) is None
    recording([])
    assert _reader(name)(_window()) is None


def test_merge_and_overlap():
    assert spans.merge([(5, 7), (0, 2), (1, 3), (7, 9)]) == [[0, 3], [5, 9]]
    assert spans.overlap_ns([[0, 3], [5, 9]], [[2, 6], [8, 20]]) == 1 + 1 + 1
    assert spans.overlap_ns([], [[0, 1]]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["wan5-10m.ycsb-b-hotspot", "wan5-10m-maxmem.ycsb-b-hotspot"])
def test_every_device_operation_of_a_traced_window_has_a_span(name, monkeypatch):
    """A traced run of the harness on the card, at a reduced size: every
    device operation of the window was launched inside a recorded
    ``scenario``, so the stages' device times add up to the window's."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    seen = []
    attribute = spans.attribute

    def keep(win, records=None):
        seen.append(attribute(win, records))
        return seen[-1]

    monkeypatch.setattr(spans, "attribute", keep)
    cell = run.load_cell(name)
    cell["config"].update(num_keys=200_000, scenario_requests=2_000_000)
    if cell["config"]["capacity_bytes"] is not None:
        cell["config"]["capacity_bytes"] = 10_000 * 1024.0
    result = run.execute(cell, 2**31 + 29, 0.5, True, device="cuda", log=lambda *a, **k: None)
    assert result["correct"] and seen and seen[-1] is not None
    att = seen[-1]
    assert att.total_ns > 0 and att.untraced_ns == 0
    assert att.device_ns["scenario"] == att.total_ns
