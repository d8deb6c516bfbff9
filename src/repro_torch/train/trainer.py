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

With a ``dist`` on a mesh every rank runs the same loop on its own blocks
(``dist.py``): params and optimizer state are placed by
``launch/sharding.py``'s param shardings, a batch passed to ``step`` is
this rank's rows (``run`` places the pipeline's batches by
``batch_shardings``), the gradients are summed over the batch axes where
other ranks' rows add to them (``dist.sync_grads``), and the gradient
norm and the int8 codec's scale are global (their sums and maxima reduced
over the axes each leaf is split over; the stochastic rounding draws at
each element's global position, so a key gives the one-device bits). The
daemons see the global counts and tokens and run the same on every rank.
Microbatch ``i`` is each rank's ``i``-th block of its rows (a rank with
fewer rows than microbatches runs one microbatch a row). A checkpoint
holds the whole params (gathered; rank 0 writes it) and is placed again on
restore.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.core.expert_placement import ExpertPlacement, ExpertPlacementState
from repro_torch.core.hot_embedding import HotEmbedding, HotEmbeddingState
from repro_torch.data.pipeline import Pipeline
from repro_torch import dist as dist_lib
from repro_torch.dist import on_mesh
from repro_torch.kvsim import prng
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.compress import dequantize_int8, quantize_int8
from repro_torch.train.optim import OptConfig, OptState, apply_updates, init_opt

__all__ = ["TrainConfig", "TrainState", "Trainer"]


def _entry_leaves(entries) -> list:
    """A tree of per-dim partition entries (dicts and lists, tuple leaves)
    as a list in ``jax.tree``'s order, the order of the params' leaves."""
    if isinstance(entries, dict):
        return [e for key in sorted(entries) for e in _entry_leaves(entries[key])]
    if isinstance(entries, list):
        return [e for val in entries for e in _entry_leaves(val)]
    return [entries]


def _global_positions(shape, entries, dist) -> torch.Tensor:
    """The flat index in the whole leaf of each element of this rank's
    block (``shape``, split as ``entries`` say), as an int64 tensor."""
    sizes = dist_lib.axis_sizes(dist.mesh)
    whole, offs = [], []
    for n, e in zip(shape, entries):
        axes = dist_lib.entry_axes(e)
        k = 1
        for a in axes:
            k *= sizes[a]
        whole.append(n * k)
        offs.append(dist_lib.coord(dist, axes) * n if axes else 0)
    dev = dist.mesh.device_type
    pos = torch.zeros((), dtype=torch.int64, device=dev)
    stride = 1
    for d in range(len(shape) - 1, -1, -1):
        idx = torch.arange(shape[d], dtype=torch.int64, device=dev) + offs[d]
        pos = pos + (idx * stride).reshape((-1,) + (1,) * (len(shape) - 1 - d))
        stride *= whole[d]
    return pos.expand(tuple(shape)).contiguous()


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
        self.shardings = self.entries = None
        if on_mesh(dist):
            from repro_torch.launch.sharding import param_entries, param_shardings

            self.shardings = param_shardings(model, dist.mesh)
            self.entries = _entry_leaves(param_entries(model, dist.mesh))
        self.embed_daemon = None
        if mcfg.hot_embed_rows:
            self.embed_daemon = HotEmbedding(
                mcfg.padded_vocab, num_nodes, mcfg.hot_embed_rows,
                h=mcfg.ownership_h or None, decay=mcfg.traffic_decay, period=mcfg.sweep_period)

    # ------------------------------------------------------------------ init
    def init_state(self, gen: torch.Generator) -> TrainState:
        """Fresh params from ``gen`` (a generator on the model's device),
        zeroed optimizer state and empty daemon states."""
        params = self.place(self.model.init(gen))
        for p in tree_lib.leaves(params):
            p.requires_grad_(True)
        return TrainState(
            params=params,
            opt=init_opt(params),
            expert_placement=self.expert_daemon.init_state(self.device) if self.expert_daemon else None,
            hot_embed=self.embed_daemon.init_state(self.device) if self.embed_daemon else None,
            data_step=0,
        )

    def place(self, params):
        """This rank's blocks of whole params (the params themselves off a
        mesh)."""
        if self.shardings is None:
            return params
        from repro_torch.launch.sharding import place_tree

        return place_tree(params, self.shardings, self.dist)

    # ------------------------------------------------------------------ step
    def _grads(self, params, batch, hot_ids, hot_embed):
        leaves = tree_lib.leaves(params)
        loss, metrics = self.model.loss(params, batch, self.dist, hot_ids=hot_ids, hot_embed=hot_embed)
        grads = torch.autograd.grad(loss, leaves)
        if self.entries is not None:
            grads = dist_lib.sync_grads(list(grads), self.entries, self.dist)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def _split_axes(self, i: int) -> tuple:
        return tuple(a for e in self.entries[i] for a in dist_lib.entry_axes(e))

    def _global_norm(self, grads):
        """The L2 norm of the whole gradient: a leaf's sum of squares summed
        over the axes it is split over, in tree order."""
        if self.entries is None:
            return None
        total = 0
        for i, g in enumerate(grads):
            sq = g.float().square().sum()
            total = total + dist_lib._reduce_(sq, self.dist, self._split_axes(i))
        return torch.sqrt(total)

    def _int8(self, grads, keys):
        """int8 compression of each leaf (``compress.py``); on a mesh the
        scale is the whole leaf's and the uniforms are drawn at each
        element's global position."""
        if self.entries is None:
            return [dequantize_int8(quantize_int8(g, k)) for g, k in zip(grads, keys)]
        out = []
        for i, (g, k) in enumerate(zip(grads, keys)):
            axes = self._split_axes(i)
            amax = dist_lib.all_max(g.float().abs().max(), self.dist, axes)
            pos = _global_positions(g.shape, self.entries[i], self.dist)
            out.append(dequantize_int8(quantize_int8(g, k, amax=amax, positions=pos)))
        return out

    def step(self, params, opt: OptState, batch: dict, hot_ids, hot_embed):
        """One training step on ``batch``: the params and ``opt``'s tensors
        are updated in place. Returns ``(params, opt', metrics)``."""
        cfg = self.cfg
        m = cfg.microbatches
        if self.entries is not None:  # a rank's rows may be fewer than the microbatches
            m = max(min(m, batch["tokens"].shape[0]), 1)
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
            grads = self._int8(grads, keys)
        params, opt, opt_metrics = apply_updates(cfg.opt, params, tree_lib.unflatten(params, grads), opt,
                                                 gnorm=self._global_norm(grads))
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
            params, opt, metrics = self.step(state.params, state.opt, self._rows(batch), hot_ids,
                                             state.hot_embed)
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
                tree = self._whole({"params": state.params, "opt": state.opt})
                if tree is not None:
                    pending_save = ckpt_lib.save_async(
                        cfg.checkpoint_dir, step_idx, tree, metadata={"data_step": state.data_step})
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

    def _rows(self, batch: dict) -> dict:
        """This rank's rows of a whole batch (``batch_shardings``)."""
        if self.entries is None:
            return batch
        from repro_torch.launch.sharding import batch_shardings, place

        sh = batch_shardings(self.model, self.dist.mesh, batch)
        return {k: place(v, sh[k], self.dist) for k, v in batch.items()}

    def _whole(self, tree):
        """The checkpoint tree: off a mesh ``tree``; on one the params and
        ``m``/``v`` gathered whole, on rank 0 (``None`` elsewhere)."""
        if self.entries is None:
            return tree
        params, opt = tree["params"], tree["opt"]
        gathered = []
        for t in (params, opt.m, opt.v):
            leaves = [dist_lib.gather_tree(x.detach(), self.entries[i], self.dist)
                      for i, x in enumerate(tree_lib.leaves(t))]
            gathered.append(tree_lib.unflatten(t, leaves))
        if torch.distributed.get_rank() != 0:
            return None
        return {"params": gathered[0], "opt": OptState(m=gathered[1], v=gathered[2], step=opt.step)}

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
        template = {"params": state.params, "opt": state.opt}  # the structure only
        try:
            tree, manifest = ckpt_lib.restore_checkpoint(self.cfg.checkpoint_dir, template=template)
        except FileNotFoundError:
            return state
        if self.entries is not None:
            tree = {"params": self.place(tree["params"]),
                    "opt": OptState(m=self.place(tree["opt"].m), v=self.place(tree["opt"].v),
                                    step=tree["opt"].step)}
        with torch.no_grad():
            for dst, src in zip(tree_lib.leaves({"params": state.params, "opt": state.opt}),
                                tree_lib.leaves(tree)):
                dst.copy_(src)
        return state._replace(data_step=int(manifest["metadata"].get("data_step", 0)))
