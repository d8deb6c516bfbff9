"""The generator of the benchmark's inputs: the same seed gives the same
arrays, another seed other arrays of the same sizes, and the mix the
traffic file states."""

import json
from pathlib import Path

import pytest
import torch

from kvbench import traffic

HERE = Path(__file__).resolve().parents[1]
CONFIG = json.loads((HERE / "configs" / "wan5-10m.json").read_text()) | {"num_keys": 5000}
MIX = json.loads((HERE / "traffic" / "ycsb-b-hotspot.json").read_text())
LARGE_SEED = 2**31 + 12_345  # the driver's seeds pass 32 signed bits


def _inputs(seed, config=CONFIG, mix=MIX, requests=200_000):
    return traffic.draw_inputs(config | {"scenario_requests": requests}, mix, seed, "cpu")


@pytest.mark.parametrize("seed", [0, 7, LARGE_SEED])
def test_same_seed_same_inputs(seed):
    (s1, t1), (s2, t2) = _inputs(seed), _inputs(seed)
    for a, b in zip([*s1, *t1[0], *t1[1]], [*s2, *t2[0], *t2[1]]):
        assert torch.equal(a, b)


def test_other_seed_other_inputs_of_the_same_sizes():
    (s1, t1), (s2, t2) = _inputs(1), _inputs(LARGE_SEED)
    for a, b in zip([*t1[0], *t1[1]], [*t2[0], *t2[1]]):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert not torch.equal(t1[0].keys, t2[0].keys)
    assert not torch.equal(t1[0].keys, t1[1].keys)  # the two traces of a run differ
    assert torch.equal(s1.object_bytes, s2.object_bytes)


def test_the_mix_is_the_traffic_files():
    store, (req, _) = _inputs(3)
    k = CONFIG["num_keys"]
    n_hot = int(k * MIX["hot_fraction"])
    hot = (req.keys < n_hot).double().mean().item()
    assert abs(hot - MIX["hot_traffic"]) < 0.005
    assert abs(req.is_read.double().mean().item() - MIX["read_fraction"]) < 0.005
    stay = (req.nodes == store.natural_node[req.keys.long()]).double().mean().item()
    assert abs(stay - MIX["affinity"]) < 0.005
    share = torch.bincount(store.natural_node.long(), minlength=5).double() / k
    assert torch.allclose(share, torch.tensor(MIX["region_weights"], dtype=torch.float64), atol=0.02)
    assert req.keys.min() >= 0 and req.keys.max() < k
    assert req.nodes.min() >= 0 and req.nodes.max() < CONFIG["num_nodes"]


def test_diurnal_shifts_rotate_the_sources():
    store, (req, _) = _inputs(5, mix=MIX | {"diurnal_shifts": 4, "affinity": 1.0}, requests=40_000)
    nat = store.natural_node[req.keys.long()]
    phase = torch.arange(40_000) * 4 // 40_000
    assert torch.equal(req.nodes, ((nat + phase) % 5).to(torch.int32))

