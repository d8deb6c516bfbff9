"""YCSB-style workload generation (paper §8.2) + geo workload presets — the
PyTorch counterpart of ``src/repro/kvsim/workload.py``.

A seed gives the reference's trace bit for bit: every draw comes from
``jax.random``'s threefry2x32 stream, copied in ``kvsim/prng.py`` (the
partitionable layout of jax 0.9). The draws are the reference's: the
paper's two-tier 90/10 skew ("10% of the data items requested 90% of the
time"), the per-key natural request source (``choice`` over
``region_weights``, else uniform), ``affinity``, the diurnal rotation,
``read_fraction`` and the lognormal per-key sizes.

Two parts, as in the reference:

* the per-key state (:func:`generate_key_state`: natural nodes and object
  sizes, ``O(K)``), drawn once a run, on the host (the same bits whatever
  the device, since ``erf_inv`` and ``exp`` are not the same code on the
  CPU and the card) and moved to the device;
* the request fields at any positions (:func:`_request_window`, in torch
  ops on any device) and of any window (:func:`generate_trace_chunk`):
  under the partitionable layout the draw at a position depends on the
  position alone, so a window of the stream is the counters of its
  positions, with no ``[R]`` buffer. The ``trace_window`` kernel draws a
  window on the card; its plain version (the same torch ops) on the CPU.

:func:`generate_trace` is the window ``[0, R)``, so a streamed window equals
the same positions of the materialised trace by construction, on either
device. (The reference's own streamed windows rebuild the classic layout,
which jax 0.9 does not use, and differ from its materialised trace; the
port is held to the materialised one.)

The diurnal phase ``(p * shifts) // R`` is taken in int64; the reference
takes it in int32, which agrees while ``R * shifts < 2**31``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.trace_window.ops import trace_window
from repro_torch.kernels.trace_window.ref import WindowParams, window_draws
from repro_torch.kvsim import prng

__all__ = [
    "WorkloadConfig",
    "Trace",
    "TraceChunk",
    "generate_trace",
    "generate_key_state",
    "generate_trace_chunk",
    "window_params",
    "wan5_workload",
    "diurnal_workload",
]


class WorkloadConfig(NamedTuple):
    num_requests: int = 100_000  # paper: uniform set of 100k requests
    num_keys: int = 1_000  # 100 accesses/key under uniform traffic
    num_nodes: int = 3  # paper testbed: 3 nodes
    read_fraction: float = 1.0  # 1.0 .. 0.5
    skewed: bool = False  # False=uniform, True=zipfian 90/10
    hot_fraction: float = 0.10  # "10% of the data items ..."
    hot_traffic: float = 0.90  # "... 90% of the time"
    affinity: float = 1.0  # P(request arrives at the key's natural node)
    region_weights: tuple[float, ...] | None = None  # P(natural node = i)
    diurnal_shifts: int = 0  # >0: request sources rotate across the trace
    object_bytes: float = 1024.0
    object_bytes_sigma: float = 0.0  # lognormal per-key size spread


class Trace(NamedTuple):
    keys: torch.Tensor  # [R] int32
    nodes: torch.Tensor  # [R] int32 requesting node
    is_read: torch.Tensor  # [R] bool
    natural_node: torch.Tensor  # [K] int32 per-key natural source
    object_bytes: torch.Tensor  # [K] f32 per-key payload size

    def to(self, device: str | torch.device) -> "Trace":
        return Trace(*(t.to(device) for t in self))

    def cpu(self) -> "Trace":
        return self.to("cpu")


class TraceChunk(NamedTuple):
    """The per-request fields of one window of positions (the per-key state
    comes from :func:`generate_key_state`; positions ``>= num_requests``
    hold well-typed values the caller masks)."""

    keys: torch.Tensor  # [B] int32
    nodes: torch.Tensor  # [B] int32
    is_read: torch.Tensor  # [B] bool


def _check_region_weights(cfg: WorkloadConfig) -> None:
    if cfg.region_weights is not None and len(cfg.region_weights) != cfg.num_nodes:
        raise ValueError(
            f"region_weights has {len(cfg.region_weights)} entries "
            f"for {cfg.num_nodes} nodes"
        )


def _workload_keys(seed: int) -> tuple[tuple[int, int], ...]:
    """The six per-field subkeys every trace spelling shares: ``k_hot,
    k_key, k_node, k_rw, k_nat, k_other``."""
    return tuple(prng.split(prng.prng_key(seed), 6))


def _n_hot(cfg: WorkloadConfig) -> int:
    return max(1, int(cfg.num_keys * cfg.hot_fraction))


def _natural_nodes(cfg: WorkloadConfig, k_nat) -> torch.Tensor:
    """Per-key natural request source ``[K]`` int32 on the CPU."""
    pos = torch.arange(cfg.num_keys, dtype=torch.int64)
    if cfg.region_weights is not None:
        w = torch.tensor(cfg.region_weights, dtype=torch.float32)
        total = w[0]
        for x in w[1:]:  # the reference's f32 sum, left to right
            total = total + x
        return prng.choice(k_nat, cfg.num_nodes, pos, w / total)
    return prng.randint(k_nat, pos, 0, cfg.num_nodes)


def _key_sizes(cfg: WorkloadConfig, k_other) -> torch.Tensor:
    """Per-key payload sizes ``[K]`` f32 on the CPU (lognormal when sigma >
    0, from ``fold_in(k_other, 2)``)."""
    k = cfg.num_keys
    if cfg.object_bytes_sigma > 0:
        z = prng.normal(prng.fold_in(k_other, 2), torch.arange(k, dtype=torch.int64))
        sigma = float(np.float32(cfg.object_bytes_sigma))
        return float(np.float32(cfg.object_bytes)) * torch.exp(sigma * z)
    return torch.full((k,), float(cfg.object_bytes), dtype=torch.float32)


def generate_key_state(
    cfg: WorkloadConfig, seed: int = 0, device: str | torch.device | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-key state of a trace, ``(natural_node [K] int32,
    object_bytes [K] f32)`` on ``device``: the same as the
    :func:`generate_trace` fields, without drawing any request."""
    _check_region_weights(cfg)
    dev = resolve_device(device)
    _, _, _, _, k_nat, k_other = _workload_keys(seed)
    return _natural_nodes(cfg, k_nat).to(dev), _key_sizes(cfg, k_other).to(dev)


def window_params(cfg: WorkloadConfig, seed: int = 0) -> WindowParams:
    """The subkeys, draw reductions and f32 thresholds of the trace's
    request draws (what ``trace_window`` takes besides positions)."""
    _check_region_weights(cfg)
    return _window_params(cfg, _workload_keys(seed))


def _window_params(cfg: WorkloadConfig, keys6) -> WindowParams:
    k_hot, k_key, k_node, k_rw, _, k_other = keys6
    k, n, n_hot = cfg.num_keys, cfg.num_nodes, _n_hot(cfg)
    draw_lo, draw_hi = (0, n_hot) if cfg.skewed else (0, k)
    keys = (k_hot, *prng.split(k_key), *prng.split(prng.fold_in(k_key, 1)),
            *prng.split(k_other), k_node, k_rw)
    draws = tuple((lo, *prng.randint_params(lo, hi))
                  for lo, hi in ((draw_lo, draw_hi), (n_hot, k), (1, n)))
    f32 = lambda p: float(np.float32(p))  # noqa: E731
    return WindowParams(
        keys=keys, draws=draws, p_hot=f32(cfg.hot_traffic), p_stay=f32(cfg.affinity),
        p_read=f32(cfg.read_fraction), skewed=cfg.skewed, num_nodes=n,
        diurnal_shifts=cfg.diurnal_shifts, num_requests=cfg.num_requests,
    )


def _request_window(
    cfg: WorkloadConfig, keys6, pos: torch.Tensor, natural: torch.Tensor
) -> TraceChunk:
    """Per-request fields at arbitrary positions ``pos`` (int64) on
    ``natural``'s device, in torch ops: ``keys6`` from
    :func:`_workload_keys`, ``natural`` the full ``[K]`` map. A contiguous
    window is ``trace_window``'s, a kernel launch on the card."""
    return TraceChunk(*window_draws(pos.to(torch.int64), _window_params(cfg, keys6), natural))


def generate_trace_chunk(
    cfg: WorkloadConfig,
    seed: int,
    chunk_idx: int,
    chunk_size: int,
    natural: torch.Tensor | None = None,
    device: str | torch.device | None = None,
) -> TraceChunk:
    """Request positions ``[chunk_idx * chunk_size, (chunk_idx + 1) *
    chunk_size)`` of the trace ``generate_trace(cfg, seed)`` draws, equal to
    that trace's slice, in ``O(chunk_size)`` memory. ``natural`` (from
    :func:`generate_key_state`) spares the ``O(K)`` per-key draw; rows past
    ``cfg.num_requests`` hold well-typed values the caller masks."""
    if natural is None:
        natural = generate_key_state(cfg, seed, device=device)[0]
    return TraceChunk(*trace_window(chunk_idx * chunk_size, chunk_size, window_params(cfg, seed),
                                    natural))


def generate_trace(
    cfg: WorkloadConfig,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> Trace:
    """The materialised ``[R]`` trace of ``seed`` on ``device``: the
    reference's ``generate_trace(cfg, seed)``, bit for bit (the lognormal
    sizes aside, which may differ from it in an ulp or so; ``kvsim/prng.py``)."""
    natural, sizes = generate_key_state(cfg, seed, device=device)
    keys, nodes, is_read = trace_window(0, cfg.num_requests, window_params(cfg, seed), natural)
    return Trace(keys=keys, nodes=nodes, is_read=is_read, natural_node=natural,
                 object_bytes=sizes)


def wan5_workload(**kwargs) -> WorkloadConfig:
    """5-region WAN preset: skewed traffic whose natural sources concentrate
    in two hot regions (pairs with ``cluster.wan5_cluster``)."""
    kwargs.setdefault("num_nodes", 5)
    kwargs.setdefault("skewed", True)
    kwargs.setdefault("region_weights", (0.35, 0.25, 0.20, 0.12, 0.08))
    return WorkloadConfig(**kwargs)


def diurnal_workload(**kwargs) -> WorkloadConfig:
    """Diurnal hot-region preset: traffic concentrated in one region whose
    identity rotates across the trace."""
    kwargs.setdefault("num_nodes", 5)
    kwargs.setdefault("skewed", True)
    kwargs.setdefault("region_weights", (0.60, 0.10, 0.10, 0.10, 0.10))
    kwargs.setdefault("diurnal_shifts", 4)
    return WorkloadConfig(**kwargs)
