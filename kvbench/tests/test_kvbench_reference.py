"""The plain reference against the program: ``run_scenario(device="cpu")``
(the kernels' plain versions) on the same traces, at a tiny size of each
configuration, budgets and contention and telemetry included; and the
control (the reference in bfloat16 in the program's place), which the
comparison must refuse."""

import math

import pytest
import torch

from kvbench import check, traffic
from kvbench.program import Scenario
from kvbench.reference import engine

CELLS = ["wan5-10m.ycsb-b-hotspot", "wan5-10m-maxmem.ycsb-b-hotspot"]


@pytest.mark.parametrize("seed", [4, 2**31 + 9])
@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_program_on_the_cpu(tiny_cell, name, seed):
    cell = tiny_cell(name)
    config = cell["config"]
    store, traces = traffic.draw_inputs(config, cell["traffic"], seed, "cpu")
    program = Scenario(config)
    for req in traces:
        result, trace = program.replay(store, req)
        ref = engine.replay(config, store.natural_node, store.object_bytes, *req)
        numbers = check.compare(check.program_answers(result, trace, config),
                                check.reference_answers(ref, config))
        assert numbers["counts_off"] == 0, numbers
        assert numbers["rel_gap"] < 1e-6, numbers  # f32 sums against the reference's f64
        assert result.replication_moves > 0
        if config["capacity_bytes"] is not None:
            assert result.capacity_evictions > 0  # the budget binds at this size


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(tiny_cell, name):
    cell = tiny_cell(name)
    config = cell["config"]
    store, (req, _) = traffic.draw_inputs(config, cell["traffic"], 6, "cpu")
    args = (config, store.natural_node, store.object_bytes, *req)
    want = check.reference_answers(engine.replay(*args), config)
    got = check.reference_answers(engine.replay(*args, dtype=torch.bfloat16), config)
    numbers = check.compare(got, want)
    limits = config["limits"]
    assert any(numbers[n] > limits[n] for n in check.NUMBERS), (numbers, limits)


def test_bin_index_edges():
    lat = torch.tensor([0.0, 0.5, 1.0, 10.0, 100.0, 1000.0, 9999.0, 10000.0, 1e9])
    got = engine.bin_index(lat, 1.0, 10_000.0, 128).tolist()
    assert got == [0, 0, 1, 32, 64, 95, 126, 127, 127]


def test_quantiles_of_a_histogram():
    edges = engine.bin_edges(1.0, 10_000.0, 128)
    hist = torch.zeros(128, dtype=torch.float64)
    hist[32] = 10  # [10 ms, 10 * 10**(1/31.5) ms)
    q = engine.quantile_rows(hist[None].numpy(), edges, 0.5)[0]
    assert edges[32] < q < edges[33]
    assert math.isnan(engine.quantile_rows(torch.zeros(1, 128).numpy(), edges, 0.5)[0])  # empty row


@pytest.mark.parametrize("rule", [(1.0, 10_000.0, 128), (0.01, 10_000.0, 64)])
def test_bin_index_is_the_programs_rule(rule):
    from repro_torch.kernels.latency_histogram.ref import bin_index as program_bin_index

    gen = torch.Generator().manual_seed(0)
    lat = torch.exp(torch.empty(1_000_000).uniform_(-6.0, 11.0, generator=gen))
    lat = torch.cat([lat, torch.tensor([0.0, 0.01, 1.0, 10.0, 100.0, 1000.0, 10_000.0])])
    assert torch.equal(engine.bin_index(lat, *rule), program_bin_index(lat, *rule))
