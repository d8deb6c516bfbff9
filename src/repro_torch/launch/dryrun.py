"""Multi-pod dry run: trace one (arch x shape x mesh) cell's step on the
production mesh without allocating it (counterpart of
``src/repro/launch/dryrun.py``, which lowers and compiles the cell with
XLA on 512 placeholder host devices).

    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k [--multi-pod]
        [--layout tp|fsdp|serve] [--quant] [--micro N] [--out FILE]

Per cell, in one process:
  1. a ``fake`` process group of the production mesh's size (256 or 512
     ranks, ``torch.testing``'s ``FakeStore``), this process its rank 0, and
     the mesh on it (``launch/mesh.py``);
  2. under ``FakeTensorMode`` (shapes and dtypes, no storage), rank 0's
     blocks of the params, optimizer state, batch or decode state, placed
     as ``launch/sharding.py`` places them;
  3. the cell's step — ``Trainer.step`` (microbatched loss, gradient and
     AdamW update), ``Model.prefill`` or ``Model.decode_step`` (one token
     against a full-length cache) — run once on them; collectives on the
     fake group return at once;
  4. its FLOPs, bytes and collectives counted (``launch/roofline.py``),
     its peak memory tracked (``torch.distributed._tools.mem_tracker``),
     and the analytic memory model beside them, into one JSON blob.

A cell fails on any error: a shape that does not split, an op the
placement cannot run, a data-dependent read of a fake tensor.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import cells, get_config, get_shape
from repro_torch.dist import axis_sizes
from repro_torch.launch.mesh import make_mesh, mesh_size, production_shape
from repro_torch.launch.roofline import count_step, roofline_terms
from repro_torch.launch.sharding import (
    batch_shardings,
    dist_for_batch,
    local_shape,
    make_dist,
    param_rules,
    param_shardings,
    state_shardings,
)
from repro_torch.models.model import DECODER_FAMILIES, build
from repro_torch.models.params import _leaves

__all__ = ["TRAIN_MICROBATCHES", "analytic_memory_per_chip", "model_flops_per_chip", "build_cell",
           "run_cell", "main"]

# Grad-accumulation microbatch count per arch for the train_4k cell (the
# reference's, sized for its chips' memory).
TRAIN_MICROBATCHES = {
    "yi-9b": 8,
    "qwen3-1.7b": 4,
    "llama3.2-3b": 4,
    "mistral-large-123b": 16,
    "rwkv6-1.6b": 4,
    "llava-next-34b": 16,
    "recurrentgemma-2b": 4,
    "whisper-base": 2,
    "deepseek-moe-16b": 4,
    "granite-moe-1b-a400m": 2,
}


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def analytic_memory_per_chip(model, shape, mesh, kind: str, micro: int = 1) -> dict:
    """Per-chip memory estimate (bf16 params and activations, f32
    optimizer), the reference's model term for term: params by their
    sharded bytes, ``opt_bytes`` 12 bytes a sharded param (m, v and the f32
    gradient), activations by the reference's per-layer rule, the decode
    state by ``state_shardings``. ``mesh`` is a ``DeviceMesh`` or an
    ``AbstractMesh``."""
    cfg = model.cfg
    rules = param_rules(cfg, mesh)
    axis_size = axis_sizes(mesh)

    def shards_of(spec) -> int:
        n = 1
        for ax in spec.axes:
            mesh_ax = rules.get(ax) if ax else None
            if mesh_ax:
                n *= axis_size.get(mesh_ax, 1)
        return n

    leaves = [spec for _, spec in _leaves(model.param_specs())]
    params_b = sum(float(math.prod(s.shape)) * _itemsize(s.dtype) / shards_of(s) for s in leaves)
    params_n = sum(
        float(math.prod(s.shape))
        / float(math.prod([axis_size.get(rules.get(a) or "", 1) for a in s.axes if a]))
        for s in leaves
    )
    out = {"params_bytes": params_b}
    d = cfg.d_model
    data_sh = axis_size.get("data", 1) * axis_size.get("pod", 1)
    if kind == "train":
        out["opt_bytes"] = params_n * 12  # m+v f32 + grad f32
        tokens_chip = shape.global_batch * shape.seq_len / micro / data_sh
        layers = cfg.num_layers + (cfg.encoder_layers or 0)
        # remat saves one [tokens, d] input per layer + ~4x working set
        out["act_bytes"] = tokens_chip * d * 2 * (layers + 4 * 3)
        out["logit_chunk_bytes"] = (
            shape.global_batch * shape.seq_len / max(cfg.xent_chunks, 1) / data_sh
            * cfg.padded_vocab / max(axis_size.get("model", 1), 1) * 4
        )
    elif kind == "prefill":
        tokens_chip = shape.global_batch * shape.seq_len / data_sh
        out["act_bytes"] = tokens_chip * d * 2 * 6
        kh, dh = cfg.num_kv_heads, cfg.resolved_head_dim
        m = axis_size.get("model", 1)
        kv_div = m if (kh % m == 0 or shape.seq_len % m == 0) else 1
        out["cache_bytes"] = cfg.num_layers * tokens_chip * kh * dh * 2 * 2 / kv_div
    else:  # decode
        from repro_torch import tree as tree_lib

        state = model.init_state(shape.global_batch, shape.seq_len, abstract=True)
        shardings = state_shardings(model, mesh, state)
        total = 0.0
        for leaf, sh in zip(tree_lib.leaves(state), tree_lib.leaves(shardings)):
            n = float(math.prod(leaf.shape)) * _itemsize(leaf.dtype)
            shards = 1
            for entry in sh.spec:
                if entry is None:
                    continue
                for ax in entry if isinstance(entry, tuple) else (entry,):
                    shards *= axis_size.get(ax, 1)
            total += n / shards
        out["state_bytes"] = total
    out["total_bytes"] = sum(v for v in out.values())
    out["fits_16GB"] = out["total_bytes"] < 16e9
    return out


def model_flops_per_chip(model, shape, mesh, kind: str) -> float:
    """6 N_active tokens (train) / 2 N_active tokens (inference), per chip."""
    n = model.active_params()
    chips = mesh_size(mesh)
    if kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len / chips
    if kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len / chips
    return 2.0 * n * shape.global_batch / chips  # decode: one token a sequence


def _cell_config(arch: str, layout: str | None):
    cfg = get_config(arch)
    if layout:
        cfg = dataclasses.replace(cfg, layout=layout)
    if os.environ.get("DRYRUN_REMAT"):
        cfg = dataclasses.replace(cfg, remat=os.environ["DRYRUN_REMAT"])
    if os.environ.get("DRYRUN_OVERRIDES"):
        cfg = dataclasses.replace(cfg, **json.loads(os.environ["DRYRUN_OVERRIDES"]))
    return cfg


def _blocks_of(tree, shardings, mesh, dtype=None, grad: bool = False):
    """Empty tensors of this rank's block shapes (under ``FakeTensorMode``:
    fake ones) for a tree of meta tensors and its shardings."""
    from repro_torch import tree as tree_lib

    def one(t, sh):
        out = torch.empty(local_shape(t.shape, sh.spec, mesh), dtype=dtype or t.dtype)
        return out.requires_grad_(True) if grad else out

    return tree_lib.tree_map(one, tree, shardings)


def build_cell(arch: str, shape_name: str, mesh, layout: str | None = None, quant: bool = False,
               micro: int = 0):
    """``(fn, args)`` for one cell: this rank's blocks as empty tensors (call
    it under ``FakeTensorMode`` to allocate nothing) and the step over
    them."""
    from repro_torch.train import OptConfig, OptState, TrainConfig, Trainer

    cfg = _cell_config(arch, layout)
    shape = get_shape(shape_name)
    model = build(cfg, "cpu")
    dist = make_dist(mesh, cfg.layout)
    p_sh = param_shardings(model, mesh)
    p_abs = model.abstract_params()
    if quant:  # int8-served weights (decode cells only)
        from repro_torch.launch.sharding import quantized_param_shardings

        assert shape.kind == "decode", "--quant targets serve_step cells"
        p_sh, p_abs = quantized_param_shardings(model, mesh, p_abs)
    hot = ()
    if cfg.num_experts and cfg.hot_expert_slots:
        hot = (torch.zeros((cfg.num_layers, cfg.hot_expert_slots), dtype=torch.int32),)

    if shape.kind == "train":
        micro = micro or TRAIN_MICROBATCHES.get(arch, 1)
        params = _blocks_of(p_abs, p_sh, mesh, grad=True)
        opt = OptState(m=_blocks_of(p_abs, p_sh, mesh, torch.float32),
                       v=_blocks_of(p_abs, p_sh, mesh, torch.float32),
                       step=torch.zeros((), dtype=torch.int32))
        b_abs = model.input_specs(shape)
        batch = _blocks_of(b_abs, batch_shardings(model, mesh, b_abs), mesh)
        trainer = Trainer(model, TrainConfig(opt=OptConfig(), microbatches=micro),
                          dist_for_batch(dist, shape.global_batch))

        def train_step(params, opt, batch, *hot_ids):
            return trainer.step(params, opt, batch, hot_ids[0] if hot_ids else None, None)

        return train_step, (params, opt, batch) + hot

    params = _blocks_of(p_abs, p_sh, mesh)
    if shape.kind == "prefill":
        b_abs = model.input_specs(shape)
        batch = _blocks_of(b_abs, batch_shardings(model, mesh, b_abs), mesh)
        pdist = dist_for_batch(dist, shape.global_batch)

        def prefill(params, batch, *hot_ids):
            return model.prefill(params, batch, pdist, hot_ids=hot_ids[0] if hot_ids else None)

        return prefill, (params, batch) + hot

    # decode: serve_step — one token against a seq_len cache
    s_abs = model.init_state(shape.global_batch, shape.seq_len, abstract=True)
    ddist = dist_for_batch(dist, shape.global_batch)
    if cfg.family in DECODER_FAMILIES:
        s_sh = state_shardings(model, mesh, s_abs)
    else:  # the stacks run whole over the model axis: lanes only
        from repro_torch import tree as tree_lib
        from repro_torch.launch.sharding import NamedSharding

        def lanes(leaf):
            spec = [None] * leaf.dim()
            for dim in range(leaf.dim()):
                if leaf.shape[dim] == shape.global_batch:
                    spec[dim] = ddist.batch
                    break
            return NamedSharding(mesh, spec)

        s_sh = tree_lib.tree_map(lanes, s_abs)
    state = _blocks_of(s_abs, s_sh, mesh)
    tokens = torch.zeros(local_shape((shape.global_batch,), (ddist.batch,), mesh), dtype=torch.int32)

    def serve_step(params, state, tokens, *hot_ids):
        return model.decode_step(params, state, tokens, ddist, hot_ids=hot_ids[0] if hot_ids else None)

    return serve_step, (params, state, tokens) + hot


def _fake_group(world: int) -> bool:
    """Initialise a ``fake`` process group of ``world`` ranks (this process
    rank 0) unless one of that size is there; True when this call made it."""
    import torch.distributed as tdist

    if tdist.is_initialized():
        if tdist.get_world_size() != world:
            raise RuntimeError(f"a process group of {tdist.get_world_size()} ranks is initialised; "
                               f"the dry run needs {world}")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore

    tdist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return True


def run_cell(arch: str, shape_name: str, multi_pod: bool, layout: str | None = None,
             quant: bool = False, micro: int = 0) -> dict:
    """One cell traced on rank 0 of the production mesh (fake group, fake
    tensors): the reference's JSON keys, counted by torch."""
    import torch.distributed as tdist
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape = get_shape(shape_name)
    mshape, axes = production_shape(multi_pod)
    made = _fake_group(math.prod(mshape))
    try:
        mesh = make_mesh(mshape, axes, device_type="cpu")
        model = build(_cell_config(arch, layout), "cpu")
        t0 = time.time()
        with FakeTensorMode(allow_non_fake_inputs=True):
            fn, args = build_cell(arch, shape_name, mesh, layout, quant, micro)
            t_build = time.time() - t0
            mem, mem_source, count = _tracked_memory(fn, args)
            t_run = time.time() - t0 - t_build
        mf = model_flops_per_chip(model, shape, mesh, shape.kind)
        terms = roofline_terms(count, mf)
        analytic = analytic_memory_per_chip(
            model, shape, mesh, shape.kind,
            TRAIN_MICROBATCHES.get(arch, 1) if shape.kind == "train" else 1)
        if mem is None:
            mem = {"peak_bytes_per_device": analytic["total_bytes"], "fits_16GB": analytic["fits_16GB"]}
        mem["source"] = mem_source
        return {
            "arch": arch,
            "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "kind": shape.kind,
            "chips": mesh_size(mesh),
            "params": model.num_params(),
            "active_params": model.active_params(),
            "ok": True,
            "lower_s": round(t_build, 1),
            "compile_s": round(t_run, 1),
            "memory": mem,
            "analytic_memory": analytic,
            "xla_cost_analysis": {"flops": count.flops, "bytes accessed": count.hbm_bytes,
                                  "counted_by": "torch FlopCounterMode and operator bytes"},
            "roofline": terms,
            "hlo_stats": {
                "dot_ops": count.dot_count,
                "collective_ops": count.collective_count,
                "while_trip_counts": [],
                "comm_ops": count.comm_ops,
            },
        }
    finally:
        if made:
            tdist.destroy_process_group()


def _tracked_memory(fn, args):
    """One run of the step, counted (``count_step``) and its peak memory on
    this rank tracked by ``MemTracker`` under the fake mode, split as the
    reference's keys split it: ``(dict, source, count)``; where the tracker
    fails, ``(None, reason, count)`` of a run without it."""
    from repro_torch import tree as tree_lib

    try:
        from torch.distributed._tools.mem_tracker import MemTracker

        inputs = [t for t in tree_lib.leaves(list(args)) if isinstance(t, torch.Tensor)]
        args_bytes = sum(t.numel() * t.element_size() for t in inputs)
        mt = MemTracker()
        mt.track_external(*inputs)
        with mt:
            out, count = count_step(fn, *args)
        peak = sum(v["Total"] for v in mt.get_tracker_snapshot("peak").values())
        outs = [t for t in tree_lib.leaves(out if isinstance(out, (tuple, list)) else [out])
                if isinstance(t, torch.Tensor)]
        out_bytes = sum(t.numel() * t.element_size() for t in outs)
        ids = {id(t) for t in inputs}
        alias = sum(t.numel() * t.element_size() for t in outs if id(t) in ids)
        return ({"args_bytes": args_bytes, "temp_bytes": peak - args_bytes, "output_bytes": out_bytes,
                 "alias_bytes": alias, "peak_bytes_per_device": peak, "fits_16GB": peak < 16e9},
                "torch.distributed._tools.mem_tracker.MemTracker under FakeTensorMode", count)
    except Exception as e:  # noqa: BLE001 - the analytic figure stands in, and says so
        reason = f"analytic (MemTracker failed: {type(e).__name__}: {e})"
    return None, reason, count_step(fn, *args)[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layout", default="", help="override cfg.layout (tp|fsdp|serve)")
    ap.add_argument("--quant", action="store_true", help="int8-served weights (decode)")
    ap.add_argument("--micro", type=int, default=0, help="override train microbatches")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    if args.shape not in cells(args.arch):
        res = {
            "arch": args.arch,
            "shape": args.shape,
            "mesh": "2x16x16" if args.multi_pod else "16x16",
            "ok": True,
            "skipped": "long_500k requires sub-quadratic attention "
            "(full-attention arch; see configs.cells)",
        }
    else:
        try:
            res = run_cell(args.arch, args.shape, args.multi_pod, args.layout or None,
                           args.quant, args.micro)
            if args.layout:
                res["layout"] = args.layout
            if args.quant:
                res["quant"] = True
        except Exception as e:  # a failing cell is a bug to surface
            res = {
                "arch": args.arch,
                "shape": args.shape,
                "mesh": "2x16x16" if args.multi_pod else "16x16",
                "ok": False,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:],
            }
    blob = json.dumps(res, indent=1, default=float)
    print(blob)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(blob)
    if not res.get("ok"):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
