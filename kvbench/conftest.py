import sys
from pathlib import Path

import pytest

# The port lives under src/; the benchmark imports it as the harness does.
_SRC = str(Path(__file__).resolve().parents[1] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def tiny_cell():
    """A cell of ``BENCHMARK.json`` cut to a size the CPU replays in
    milliseconds: 2,000 keys, chunks of 1,000 requests, 20 chunks a
    scenario, and (where the configuration has budgets) 100 KiB a node."""
    from kvbench.run import load_cell

    def make(name: str) -> dict:
        cell = load_cell(name)
        config = cell["config"]
        config.update(num_keys=2000, daemon_interval=1000, scenario_requests=20_000)
        if config["capacity_bytes"] is not None:
            config["capacity_bytes"] = 100 * 1024.0
        return cell

    return make
