"""The reduction of a traced window to the per-layer metrics, on a
synthetic window: the interval union, the launch and tick counts, the
rooflines' byte counts, and a metric with nothing to read left out."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from kvbench import profile

HERE = Path(__file__).resolve().parents[1]
CONFIG = json.loads((HERE / "configs" / "wan5-10m.json").read_text())


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _window(device_ops, runtime=(), ticks=2, window_s=1e-6, config=CONFIG, requests=()):
    return profile.Window(list(device_ops), list(runtime), window_s, ticks,
                          dict(config=config, requests=list(requests)))


def test_union_of_intervals():
    assert profile.union_ns([(0, 10), (5, 20), (30, 40), (35, 36)]) == 30
    assert profile.union_ns([]) == 0


def test_idle_share_launches_and_device_time():
    ops = [("k", 0, 100, 1), ("k", 50, 300, 2), ("Memset (Device)", 500, 600, 3)]
    rt = [("cudaLaunchKernel", 0, 5, 1), ("cudaLaunchKernelExC", 10, 15, 2),
          ("cudaMemsetAsync", 20, 25, 3), ("cudaStreamSynchronize", 30, 400, 0)]
    win = _window(ops, rt, ticks=2, window_s=1000e-9)
    assert win.launches == 2 and win.busy_s == pytest.approx(400e-9)
    assert _reader("launches_per_tick").read(win) == 1.0
    assert _reader("tick_device_ms").read(win) == pytest.approx(450e-6 / 2)
    assert _reader("device_idle_pct").read(win) == pytest.approx(60.0)
    gaps = profile.breakdown(win)["idle_gaps"]
    assert gaps == [["host in cudaStreamSynchronize; then cudaMemsetAsync: Memset (Device)", 200e-9]]


def test_sweep_roofline_from_its_bytes():
    k, n = CONFIG["num_keys"], CONFIG["num_nodes"]
    mod = _reader("ownership_sweep_roofline")
    assert mod.sweep_bytes(k, n) == k * (4 * n + n + 1 + 4) + k * (3 * n + 1 + 4 * n)
    t_ns = round(mod.sweep_bytes(k, n) / 3.35e12 * 1e9 * 2)  # half the rate
    win = _window([("void ownership_sweep_kernel<int>(...)", 0, t_ns, 1)])
    assert mod.read(win) == pytest.approx(50.0, rel=1e-6)


def test_replay_roofline_counts_each_chunks_distinct_rows():
    mod = _reader("chunk_replay_roofline")
    keys = torch.tensor([0, 0, 1, 2, 5, 5, 5, 5], dtype=torch.int32)  # chunks of 4: 3 and 1 distinct
    req = type("R", (), {"keys": keys})()
    config = CONFIG | {"daemon_interval": 4, "num_nodes": 5, "telemetry": None, "contention": None}
    # rows: 3 + 1 distinct keys of 5 nodes, beside each chunk's fixed bytes
    per_call = (2 * mod.chunk_bytes(4, 0, 5, False, 0) + 4 * 5) / 2
    ops = [("chunk_replay_kernel", 0, 1000, 1), ("chunk_replay_kernel", 1000, 3000, 2)]
    win = _window(ops, config=config, requests=[req])
    assert mod.read(win) == pytest.approx(100.0 * 2 * per_call / 3.35e12 / 3e-6, rel=1e-9)


def test_distinct_per_chunk_counts_each_chunks_keys():
    keys = torch.randint(0, 300, (10_500,), dtype=torch.int32)
    got = _reader("chunk_replay_roofline").distinct_per_chunk(keys, 1000)
    assert got.tolist() == [keys[lo:lo + 1000].unique().numel() for lo in range(0, 10_500, 1000)]


@pytest.mark.parametrize("name", ["ownership_sweep_roofline", "chunk_replay_roofline"])
def test_a_kernel_that_did_not_run_is_left_out(name):
    assert _reader(name).read(_window([("other_kernel", 0, 10, 1)])) is None
