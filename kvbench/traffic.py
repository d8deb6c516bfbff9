"""The one generator of the benchmark's inputs: a store's per-key state and
its request traces, drawn on the device from ``--seed``.

A configuration file (``configs/<name>.json``) fixes the store: keys, nodes,
object size. A traffic file (``traffic/<name>.json``) fixes the mix:

* ``read_fraction``: P(a request is a read);
* ``hot_fraction`` / ``hot_traffic``: the paper's hotspot, the first
  ``hot_fraction`` of the keys take ``hot_traffic`` of the requests, each
  tier uniform inside;
* ``region_weights``: P(a key's natural region = i);
* ``affinity``: P(a request arrives at its key's natural region), else at
  one of the other regions, uniformly;
* ``diurnal_shifts``: the request sources rotate by one region this many
  times over a trace (0: no rotation).

Every draw comes from one ``torch.Generator`` on the device seeded with the
seed, in a fixed order (the per-key state, then each trace), in a few large
calls. The same seed gives the same arrays; any seed gives the same sizes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Store", "Requests", "draw_store", "draw_requests", "draw_inputs"]


class Store(NamedTuple):
    natural_node: torch.Tensor  # [K] int32 natural region of each key
    object_bytes: torch.Tensor  # [K] f32 payload size of each key


class Requests(NamedTuple):
    keys: torch.Tensor  # [R] int32
    nodes: torch.Tensor  # [R] int32 region the request arrives at
    is_read: torch.Tensor  # [R] bool


def _check(config: dict, traffic: dict) -> None:
    n = config["num_nodes"]
    weights = traffic["region_weights"]
    if len(weights) != n:
        raise ValueError(f"region_weights has {len(weights)} entries for {n} nodes")
    if not 0.0 < traffic["hot_fraction"] < 1.0:
        raise ValueError(f"hot_fraction must lie in (0, 1), got {traffic['hot_fraction']}")
    for name in ("read_fraction", "hot_traffic", "affinity"):
        if not 0.0 <= traffic[name] <= 1.0:
            raise ValueError(f"{name} must lie in [0, 1], got {traffic[name]}")


def draw_store(config: dict, traffic: dict, gen: torch.Generator, device) -> Store:
    """The per-key state: natural regions drawn by ``region_weights``,
    every object ``config["object_bytes"]`` long."""
    _check(config, traffic)
    k = config["num_keys"]
    w = torch.tensor(traffic["region_weights"], dtype=torch.float64, device=device)
    edges = (w.cumsum(0) / w.sum())[:-1].to(torch.float32)
    u = torch.rand(k, generator=gen, device=device)
    natural = torch.bucketize(u, edges, right=True).to(torch.int32)
    sizes = torch.full((k,), float(config["object_bytes"]), dtype=torch.float32, device=device)
    return Store(natural, sizes)


def draw_requests(config: dict, traffic: dict, store: Store, num_requests: int,
                  gen: torch.Generator) -> Requests:
    """One trace of ``num_requests`` requests over ``store``."""
    dev = store.natural_node.device
    k, n = config["num_keys"], config["num_nodes"]
    r = num_requests
    n_hot = max(1, int(k * traffic["hot_fraction"]))
    hot = torch.rand(r, generator=gen, device=dev) < traffic["hot_traffic"]
    keys = torch.randint(0, n_hot, (r,), generator=gen, device=dev, dtype=torch.int32)
    cold = torch.randint(n_hot, k, (r,), generator=gen, device=dev, dtype=torch.int32)
    keys = torch.where(hot, keys, cold)
    del hot, cold
    nat = store.natural_node[keys]
    stay = torch.rand(r, generator=gen, device=dev) < traffic["affinity"]
    shift = torch.randint(1, max(n, 2), (r,), generator=gen, device=dev, dtype=torch.int32)
    nodes = torch.where(stay, nat, (nat + shift) % n)
    del nat, stay, shift
    shifts = traffic.get("diurnal_shifts", 0)
    if shifts:
        pos = torch.arange(r, dtype=torch.int64, device=dev)
        nodes = ((nodes + (pos * shifts) // r) % n).to(torch.int32)
        del pos
    is_read = torch.rand(r, generator=gen, device=dev) < traffic["read_fraction"]
    return Requests(keys, nodes.to(torch.int32), is_read)


def draw_inputs(config: dict, traffic: dict, seed: int, device) -> tuple[Store, list[Requests]]:
    """A run's inputs from ``seed``: the store and two traces of
    ``config["scenario_requests"]`` requests, drawn in that order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    store = draw_store(config, traffic, gen, device)
    traces = [draw_requests(config, traffic, store, config["scenario_requests"], gen)
              for _ in range(2)]
    return store, traces

