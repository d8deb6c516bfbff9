"""The harness on the card at a reduced size: each cell's run comes out
correct with its end-to-end metrics, and a traced run reads every per-layer
metric, each share of a bound at most 100 %. Run on a machine with a card:
``python3 -m pytest -m cuda kvbench``."""

import pytest

from kvbench import run

CELLS = ["wan5-10m.ycsb-b-hotspot", "wan5-10m-maxmem.ycsb-b-hotspot"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


def _small(name):
    cell = run.load_cell(name)
    config = cell["config"]
    config.update(num_keys=200_000, scenario_requests=2_000_000)
    if config["capacity_bytes"] is not None:
        config["capacity_bytes"] = 10_000 * 1024.0
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_on_the_card(card, name, trace):
    cell = _small(name)
    result = run.execute(cell, 2**31 + 17, 0.5, trace, device=card, log=lambda *a, **k: None)
    assert result["correct"] and result["attempted"] >= 2, result["check"]
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    assert set(result["metrics"]) == set(wanted)
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        for name, metric in result["metrics"].items():
            if metric["unit"] == "%":
                assert 0 < metric["value"] <= 100.0, (name, metric)
