"""Batched decode engine: prefill requests into lanes, step all lanes
(counterpart of ``src/repro/serving/engine.py``).

One engine is one pod's serving deployment (the paper's RedynisService).
It only calls ``model.prefill`` / ``model.decode_step`` and carries their
decode state, whatever the family's (a KV cache, a recurrent state, an
encoder-decoder state), stacked over lanes as the model makes it for a
full batch. A ``vlm`` prompt comes with zero patch embeddings and an
``audio`` one with zero frames, as in the reference. A
new prefill overwrites its whole lane slice in place (``_write_lane``), so
a lane re-bound after an LRU eviction keeps nothing of its last session.
All lanes advance together each ``step()``, idle ones included, as in the
reference (continuous batching at lane granularity).

The engine runs on its model's device (CUDA unless the model was built
with ``device="cpu"``). ``temperature > 0`` samples by the Gumbel-max rule
with a ``torch.Generator`` seeded with ``seed``, as the reference seeds
``jax.random``; the bits differ from the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.serving.kvcache import LaneTable, state_bytes

__all__ = ["Request", "ServeEngine"]


class Request(NamedTuple):
    session: str
    tokens: np.ndarray  # prompt token ids [S]
    max_new: int = 16


def _write_lane(state, lane_state, lane: int, num_lanes: int) -> None:
    """Copy a single-lane decode state into lane ``lane`` of the batch
    state, in place, leaf by leaf in ``jax.tree``'s order (NamedTuples,
    lists and tuples nested, as rglru's state). The lane dim of each
    tensor is the first dim that is ``num_lanes`` wide in the batch state
    and 1 wide in the lane's: dim 0 for ``[B, ...]`` leaves, dim 1 for
    layer-stacked ``[L, B, ...]`` leaves."""
    for full, single in zip(tree_lib.leaves(state), tree_lib.leaves(lane_state), strict=True):
        for d in range(full.dim()):
            if full.shape[d] == num_lanes and single.shape[d] == 1:
                full.narrow(d, lane, 1).copy_(single)
                break
        else:
            raise ValueError((tuple(full.shape), tuple(single.shape), num_lanes))


class ServeEngine:
    def __init__(
        self,
        model,
        params: dict,
        num_lanes: int,
        cache_len: int,
        dist=None,
        hot_ids: torch.Tensor | None = None,
        temperature: float = 0.0,
        seed: int = 0,
    ):
        self.model = model
        self.params = params
        self.dist = dist
        self.hot_ids = hot_ids
        self.cache_len = cache_len
        self.temperature = temperature
        self.device = model.device
        self.lanes = LaneTable(num_lanes)
        self.num_lanes = num_lanes
        self.state = model.init_state(num_lanes, cache_len)
        self.last_token = torch.zeros(num_lanes, dtype=torch.int32, device=self.device)
        self.remaining = np.zeros((num_lanes,), np.int64)
        self.outputs: dict[str, list[int]] = {}
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.steps = 0
        self.tokens_out = 0

    # -------------------------------------------------------------- prefill
    def admit(self, req: Request) -> int:
        """Prefill a request into a lane. Returns the lane index."""
        lane, evicted = self.lanes.bind(req.session)
        if evicted is not None:
            self.outputs.setdefault(evicted, [])
        tokens = torch.as_tensor(np.asarray(req.tokens), dtype=torch.int32, device=self.device)
        batch = {"tokens": tokens[None, :]}
        cfg = self.model.cfg
        if cfg.family == "vlm":  # the stub frontends' inputs: zeros, as in the reference
            batch["patches"] = torch.zeros((1, cfg.num_patches, cfg.d_model), dtype=torch.bfloat16,
                                           device=self.device)
        if cfg.family == "audio":
            batch["frames"] = torch.zeros((1, cfg.num_frames, cfg.d_model), dtype=torch.bfloat16,
                                          device=self.device)
        logits, lane_state = self.model.prefill(
            self.params, batch, self.dist,
            cache_len=self.cache_len, hot_ids=self.hot_ids,
        )
        _write_lane(self.state, lane_state, lane, self.num_lanes)
        tok = self._sample(logits)[0]
        self.last_token[lane] = tok
        self.remaining[lane] = req.max_new
        self.outputs[req.session] = [int(tok)]
        return lane

    # -------------------------------------------------------------- decode
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy (first index of the max) at temperature 0, else one draw
        from ``softmax(logits / temperature)`` by the Gumbel-max rule."""
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        u = torch.rand(logits.shape, generator=self._gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        return torch.argmax(logits / self.temperature + gumbel, dim=-1).to(torch.int32)

    def step(self) -> dict[str, int]:
        """One decode step for every lane; returns ``{session: token}`` for
        the active ones."""
        active = {s: l for s, l in self.lanes.active.items() if self.remaining[l] > 0}
        if not active:
            return {}
        logits, self.state = self.model.decode_step(
            self.params, self.state, self.last_token, self.dist, hot_ids=self.hot_ids
        )
        self.last_token = self._sample(logits)
        toks = self.last_token.tolist()
        out = {}
        for session, lane in active.items():
            t = toks[lane]
            self.outputs[session].append(t)
            self.remaining[lane] -= 1
            out[session] = t
            if self.remaining[lane] == 0:
                self.lanes.release(session)
        self.steps += 1
        self.tokens_out += len(out)
        return out

    def run_to_completion(self, max_steps: int = 10_000) -> dict[str, list[int]]:
        for _ in range(max_steps):
            if not self.step():
                break
        return dict(self.outputs)

    # -------------------------------------------------------------- stats
    def cache_bytes(self) -> int:
        return state_bytes(self.state)
