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
with ``device="cpu"``). With a ``dist`` on a mesh every rank runs the same
engine on its own blocks: the params are given placed (this rank's blocks
of ``launch/sharding.param_shardings``), the decode state is placed here
(the decoder families by ``state_shardings``; the others' lanes only, their
stacks running whole over the model axis), a prefill writes its lane on
the rank that holds it, and each step's logits are gathered whole (lanes
and vocabulary) so that every rank samples the same tokens. ``temperature > 0`` samples by the Gumbel-max rule
with a ``torch.Generator`` seeded with ``seed``, as the reference seeds
``jax.random``; the bits differ from the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.dist import all_gather, coord, gather_logits, on_mesh
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
        self.step_dist, self.lane_lo, self.local_lanes = dist, 0, num_lanes
        if on_mesh(dist):
            self._place_state()
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
        pdist = self.dist._replace(batch_axes=()) if on_mesh(self.dist) else self.dist
        logits, lane_state = self.model.prefill(
            self.params, batch, pdist,
            cache_len=self.cache_len, hot_ids=self.hot_ids,
        )
        if self.lane_lo <= lane < self.lane_lo + self.local_lanes:
            _write_lane(self.state, lane_state, lane - self.lane_lo, self.local_lanes)
        tok = self._sample(gather_logits(logits, pdist))[0]
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
        mine = self.last_token[self.lane_lo:self.lane_lo + self.local_lanes]
        logits, self.state = self.model.decode_step(
            self.params, self.state, mine, self.step_dist, hot_ids=self.hot_ids
        )
        self.last_token = self._sample(self._whole_logits(logits))
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

    # -------------------------------------------------------------- mesh
    def _place_state(self) -> None:
        """This rank's blocks of the decode state: lanes over the batch
        axes where they divide them; the decoder families' caches over the
        model axis as ``state_shardings`` lays them out."""
        from repro_torch.launch.sharding import NamedSharding, dist_for_batch, place_tree, state_shardings
        from repro_torch.models.model import DECODER_FAMILIES
        from repro_torch.models.transformer import seq_split

        model, dist = self.model, self.dist
        self.step_dist = dist_for_batch(dist, self.num_lanes)
        if self.step_dist.batch_axes:
            self.local_lanes = self.num_lanes // dist.batch_size
            self.lane_lo = coord(dist, dist.batch_axes) * self.local_lanes
        if model.cfg.family in DECODER_FAMILIES:
            if seq_split(model.cfg, dist) and self.cache_len % dist.model_size:
                raise ValueError(f"cache_len {self.cache_len} does not split over the model axis")
            sh = state_shardings(model, dist.mesh, self.state)
        else:
            lanes = self.step_dist.batch

            def rows(leaf):  # the lane dim: the first one num_lanes wide
                spec = [None] * leaf.dim()
                for d in range(leaf.dim()):
                    if leaf.shape[d] == self.num_lanes:
                        spec[d] = lanes
                        break
                return NamedSharding(dist.mesh, spec)

            sh = tree_lib.tree_map(rows, self.state)
        self.state = place_tree(self.state, sh, dist)

    def _whole_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Every lane's logits over the whole vocabulary, on every rank."""
        if not on_mesh(self.dist):
            return logits
        return all_gather(gather_logits(logits, self.step_dist), 0, self.dist, self.step_dist.batch_axes)

    # -------------------------------------------------------------- stats
    def cache_bytes(self) -> int:
        return state_bytes(self.state)
