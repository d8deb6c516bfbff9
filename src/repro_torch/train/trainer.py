"""The training loop with both Redynis placement daemons in it (counterpart
of ``src/repro/train/trainer.py``).

A step is eager autograd (no ``torch.compile``, no CUDA graph): the loss
of each microbatch, its gradient by ``torch.autograd.grad``, the f32
accumulation over microbatches (a single microbatch keeps the grads in the
params' dtype, as the reference's do), optional int8 compression, then
AdamW written into the params in place. Around it, the host loop does the
paper's daemon work: it folds every step's traffic into the expert-replica
daemon (the step's routing counts) and the hot-row embedding daemon (the
step's tokens), sweeps each when ``due(step)`` (``ownership_sweep`` on the
card for the experts), and feeds the new ``hot_ids`` and hot-row state to
the next step. It checkpoints ``{"params", "opt"}`` asynchronously with the
pipeline position as metadata.

The daemons fold the counts of the step's forward pass only: under
``remat="full"`` the backward pass runs each layer again (and launches
``moe_router`` again), but its counts are not returned.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.core.expert_placement import ExpertPlacement, ExpertPlacementState
from repro_torch.core.hot_embedding import HotEmbedding, HotEmbeddingState
from repro_torch.data.pipeline import Pipeline
from repro_torch.dist import check_local
from repro_torch.kvsim import prng
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.compress import dequantize_int8, quantize_int8
from repro_torch.train.optim import OptConfig, OptState, apply_updates, init_opt

__all__ = ["TrainConfig", "TrainState", "Trainer"]


class TrainConfig(NamedTuple):
    opt: OptConfig = OptConfig()
    microbatches: int = 1
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    keep_checkpoints: int = 3
    log_every: int = 10
    # Cross-pod gradient compression (train/compress.py): "none" | "int8",
    # applied to the global gradient with stochastic rounding.
    grad_compression: str = "none"


class TrainState(NamedTuple):
    params: dict
    opt: OptState
    expert_placement: Optional[ExpertPlacementState]
    hot_embed: Optional[HotEmbeddingState]
    data_step: int  # pipeline position (a host int: the exact replay key)


class Trainer:
    def __init__(self, model, cfg: TrainConfig, dist=None, num_nodes: int = 1):
        check_local(dist)
        self.model = model
        self.cfg = cfg
        self.dist = dist
        self.num_nodes = num_nodes
        self.device = model.device
        mcfg = model.cfg
        self.expert_daemon = None
        if mcfg.num_experts and mcfg.hot_expert_slots:
            self.expert_daemon = ExpertPlacement(
                mcfg.num_layers, mcfg.num_experts, num_nodes, mcfg.hot_expert_slots,
                h=mcfg.ownership_h or None, decay=mcfg.traffic_decay, period=mcfg.sweep_period)
        self.embed_daemon = None
        if mcfg.hot_embed_rows:
            self.embed_daemon = HotEmbedding(
                mcfg.padded_vocab, num_nodes, mcfg.hot_embed_rows,
                h=mcfg.ownership_h or None, decay=mcfg.traffic_decay, period=mcfg.sweep_period)

    # ------------------------------------------------------------------ init
    def init_state(self, gen: torch.Generator) -> TrainState:
        """Fresh params from ``gen`` (a generator on the model's device),
        zeroed optimizer state and empty daemon states."""
        params = self.model.init(gen)
        for p in tree_lib.leaves(params):
            p.requires_grad_(True)
        return TrainState(
            params=params,
            opt=init_opt(params),
            expert_placement=self.expert_daemon.init_state(self.device) if self.expert_daemon else None,
            hot_embed=self.embed_daemon.init_state(self.device) if self.embed_daemon else None,
            data_step=0,
        )

    # ------------------------------------------------------------------ step
    def _grads(self, params, batch, hot_ids, hot_embed):
        leaves = tree_lib.leaves(params)
        loss, metrics = self.model.loss(params, batch, self.dist, hot_ids=hot_ids, hot_embed=hot_embed)
        grads = torch.autograd.grad(loss, leaves)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def step(self, params, opt: OptState, batch: dict, hot_ids, hot_embed):
        """One training step on ``batch``: the params and ``opt``'s tensors
        are updated in place. Returns ``(params, opt', metrics)``."""
        cfg = self.cfg
        m = cfg.microbatches
        if m > 1:
            rows = batch["tokens"].shape[0] // m
            g_acc, metrics = None, None
            for i in range(m):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                grads, mets = self._grads(params, mb, hot_ids, hot_embed)
                if g_acc is None:
                    g_acc = [torch.zeros(g.shape, dtype=torch.float32, device=g.device) for g in grads]
                    metrics = {k: torch.zeros_like(v) for k, v in mets.items()}
                g_acc = [a + g.float() for a, g in zip(g_acc, grads)]
                metrics = {k: metrics[k] + v for k, v in mets.items()}
                del grads
            grads = [g / m for g in g_acc]
            metrics = {k: v / m for k, v in metrics.items()}
        else:
            grads, metrics = self._grads(params, batch, hot_ids, hot_embed)

        if cfg.grad_compression == "int8":
            key = prng.fold_in(prng.prng_key(12), int(opt.step))
            keys = prng.split(key, len(grads))
            grads = [dequantize_int8(quantize_int8(g, k)) for g, k in zip(grads, keys)]
        params, opt, opt_metrics = apply_updates(cfg.opt, params, tree_lib.unflatten(params, grads), opt)
        metrics.update(opt_metrics)
        return params, opt, metrics

    # ------------------------------------------------------------------ run
    def run(self, state: TrainState, pipeline: Pipeline, steps: int,
            log: bool = True) -> tuple[TrainState, list[dict]]:
        cfg = self.cfg
        pstate = pipeline.seek(state.data_step)
        history: list[dict] = []
        pending_save = None
        for i in range(steps):
            batch, pstate = pipeline.next(pstate)
            hot_ids = state.expert_placement.hot_ids if state.expert_placement is not None else None
            t0 = time.perf_counter()
            params, opt, metrics = self.step(state.params, state.opt, batch, hot_ids, state.hot_embed)
            step_idx = int(opt.step)  # waits for the step
            dt = time.perf_counter() - t0

            # ---- Redynis daemons: fold traffic, sweep on period ------------
            ep, he = state.expert_placement, state.hot_embed
            if self.expert_daemon is not None and "moe_counts" in metrics:
                g = metrics["moe_counts"].shape[1]
                ep = self.expert_daemon.fold(ep, metrics["moe_counts"], self._group_nodes(g))
                if self.expert_daemon.due(step_idx):
                    ep = self.expert_daemon.sweep(ep)
            if self.embed_daemon is not None:
                he = self.embed_daemon.fold(he, batch["tokens"], self._token_nodes(batch["tokens"].shape[0]))
                if self.embed_daemon.due(step_idx):
                    he = self.embed_daemon.sweep(he)
            state = TrainState(params=params, opt=opt, expert_placement=ep, hot_embed=he,
                               data_step=int(pstate.step))

            # ---- checkpoint / log -----------------------------------------
            if cfg.checkpoint_every and step_idx % cfg.checkpoint_every == 0:
                if pending_save is not None:
                    pending_save.wait()
                pending_save = ckpt_lib.save_async(
                    cfg.checkpoint_dir, step_idx, {"params": state.params, "opt": state.opt},
                    metadata={"data_step": state.data_step})
                ckpt_lib.gc_checkpoints(cfg.checkpoint_dir, cfg.keep_checkpoints)

            scalars = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
            scalars["step"] = step_idx
            scalars["step_time_s"] = dt
            history.append(scalars)
            if log and (step_idx % cfg.log_every == 0 or i == steps - 1):
                msg = f"step {step_idx}: loss={scalars.get('loss', 0):.4f}"
                if "moe_hot_frac" in scalars:
                    msg += f" hot_frac={scalars['moe_hot_frac']:.3f}"
                print(msg, flush=True)
        if pending_save is not None:
            pending_save.wait()
        return state, history

    # ------------------------------------------------------------------ maps
    def _group_nodes(self, g: int) -> torch.Tensor:
        """Dispatch group -> EP rank (data-major blocks)."""
        per = max(g // max(self.num_nodes, 1), 1)
        return (torch.arange(g, dtype=torch.int32, device=self.device) // per) % self.num_nodes

    def _token_nodes(self, b: int) -> torch.Tensor:
        per = max(b // max(self.num_nodes, 1), 1)
        return (torch.arange(b, dtype=torch.int32, device=self.device) // per) % self.num_nodes

    # ------------------------------------------------------------------ ckpt
    def restore(self, gen: torch.Generator) -> TrainState:
        """The latest checkpoint's params, optimizer state and pipeline
        position on fresh daemon states (a fresh start when there is
        none). The checkpoint is copied into the fresh state's tensors."""
        state = self.init_state(gen)
        if not self.cfg.checkpoint_dir:
            return state
        try:
            tree, manifest = ckpt_lib.restore_checkpoint(
                self.cfg.checkpoint_dir, template={"params": state.params, "opt": state.opt})
        except FileNotFoundError:
            return state
        with torch.no_grad():
            for dst, src in zip(tree_lib.leaves({"params": state.params, "opt": state.opt}),
                                tree_lib.leaves(tree)):
                dst.copy_(src)
        return state._replace(data_step=int(manifest["metadata"].get("data_step", 0)))
