"""A run with the timed path broken underneath comes out not correct: the
harness's whole run (set-up, window, check) on the CPU at a tiny size, with
each fault the cells can have planted in the program. (Both cells run on one
chip: there is no exchange between chips to leave out.)"""

import importlib

import pytest
import torch

from kvbench import run

CELLS = ["wan5-10m.ycsb-b-hotspot", "wan5-10m-maxmem.ycsb-b-hotspot"]


def _quiet(*args, **kwargs):
    pass


def _state_unchanged(monkeypatch):
    """The daemon's step returns the store it was given, with no moves."""
    import repro_torch.kvsim.simulate as sim

    real = sim.policy_masked_step

    def step(policy, state, store, now, due, ctx):
        stats, state, _ = real(policy, state, store, now, due, ctx)
        return tuple(torch.zeros_like(s) for s in stats), state, store

    monkeypatch.setattr(sim, "policy_masked_step", step)


def _half_batch(monkeypatch):
    """The replay drops the second half of each chunk's requests."""
    import repro_torch.kvsim.simulate as sim

    real = sim.chunk_replay

    def replay(hosts, keys, nodes, is_read, valid, rtt, **kw):
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = False
        return real(hosts, keys, nodes, is_read, valid, rtt, **kw)

    monkeypatch.setattr(sim, "chunk_replay", replay)


def _answer_altered(monkeypatch):
    """The sweep's placement answer has one replica flipped where the
    kernel produces it."""
    # The package re-exports the wrapper under the subpackage's name.
    ops = importlib.import_module("repro_torch.kernels.ownership_sweep.ops")
    real = ops.ownership_sweep

    def sweep(*args, **kw):
        owners, add, drop, expired, f = real(*args, **kw)
        owners = owners.clone()
        owners[0, 0] = ~owners[0, 0]
        return owners, add, drop, expired, f

    monkeypatch.setattr(ops, "ownership_sweep", sweep)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_run_is_not_correct(tiny_cell, monkeypatch, name, fault):
    cell = tiny_cell(name)
    fault(monkeypatch)
    result = run.execute(cell, 2**31 + 21, 0.0, False, device="cpu", log=_quiet)
    assert not result["correct"] and result["failed"] == result["attempted"] == 1, result["check"]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(tiny_cell, name):
    result = run.execute(tiny_cell(name), 2**31 + 21, 0.0, False, device="cpu", log=_quiet)
    assert result["correct"] and result["attempted"] == 1, result["check"]
    assert list(result["metrics"]) == ["sim_req_per_s", "peak_mem_gib", "setup_s"]
    assert list(result)[-1] == "check"
