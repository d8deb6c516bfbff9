"""Sharding rules: logical parameter axes -> mesh axes, per architecture
(counterpart of ``src/repro/launch/sharding.py``).

Parallelism layout (16 data x 16 model per pod; pods are pure DP):

  params       FSDP: 'embed' dim over data; TP: heads/mlp/experts/state
               over model; vocab over model (embedding, LM head and the
               vocab-split xent: logits are never gathered).
  activations  batch over (pod, data); attention heads over model where
               they divide it; MoE groups over the batch axes, experts over
               model (each EP rank computes its own experts' tokens and one
               all-reduce over model combines them).
  decode       KV cache: batch over data; kv-heads over model when they
               divide it, else the sequence over model (the partial
               softmaxes combine by all-reduces); recurrent state: width over
               model.

Divisibility: split param dims must divide, so archs whose head count is
not a multiple of the model axis (llama3.2 24H, llava 56H, recurrentgemma
10H, whisper 8H at 16) split head_dim in params and leave heads whole.
The reference lets GSPMD still split those heads unevenly (padded) in the
activations; the port has no padded shard, so it gathers such attention
weights and computes every head on every model rank (the MLP, experts
and vocabulary stay split).

A sharding here is a :class:`NamedSharding`: a mesh and a tuple of
partition entries, one a dim (the reference's ``PartitionSpec``).
``place`` cuts a tensor to this rank's block of a sharding; ``place_tree``
a tree.
"""

from __future__ import annotations

import torch

from repro_torch import tree as tree_lib
from repro_torch.dist import DistSpec, axes_size, axis_sizes, coord, entry_axes, on_mesh
from repro_torch.models.params import partition_specs

__all__ = [
    "make_dist",
    "param_rules",
    "param_shardings",
    "batch_shardings",
    "state_shardings",
    "opt_shardings",
    "MODEL_AXIS_SIZE",
]

MODEL_AXIS_SIZE = 16


class NamedSharding:
    """A mesh and one partition entry a dim: ``None`` (replicated), a mesh
    axis, or a tuple of mesh axes (the reference's ``NamedSharding`` over a
    ``PartitionSpec``)."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and self.mesh is other.mesh and self.spec == other.spec

    def __hash__(self):
        return hash(self.spec)

    def __repr__(self):
        return f"NamedSharding(spec={self.spec})"


def _axis_names(mesh) -> tuple:
    return tuple(axis_sizes(mesh))


def make_dist(mesh, layout: str = "tp") -> DistSpec:
    axes = _axis_names(mesh)
    if layout == "fsdp":
        # ZeRO-3: the batch spreads over every axis (no tensor parallelism
        # for the blocks), but the model axis still carries the vocab split
        # for the loss path.
        batch_axes = tuple(a for a in ("pod", "data", "model") if a in axes)
        model_axis = "model" if "model" in axes else None
        return DistSpec(mesh=mesh, batch_axes=batch_axes, model_axis=model_axis)
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)
    model_axis = "model" if "model" in axes else None
    return DistSpec(mesh=mesh, batch_axes=batch_axes, model_axis=model_axis)


def param_rules(cfg, mesh) -> dict:
    """Logical axis -> mesh axis map for this arch on this mesh.

    Three layouts (``cfg.layout``):
      tp    — FSDP('embed'->data) x TP(heads/mlp/experts/vocab->model)
      fsdp  — params fully split over (data, model) on 'embed'; no TP
      serve — TP only; params replicated over data (weights-stationary
              decode: no per-step FSDP gathers)
    """
    sizes = axis_sizes(mesh)
    names = tuple(sizes)
    m = sizes["model"] if "model" in names else 1
    d_axes = tuple(a for a in ("data", "model") if a in names)

    if cfg.layout == "fsdp":
        if d_axes and cfg.d_model % axes_size(mesh, d_axes) == 0:
            emb = d_axes
        elif "data" in names and cfg.d_model % sizes["data"] == 0:
            emb = "data"
        else:
            emb = None
        return {
            "layers": None,
            "vocab": "model" if "model" in names else None,
            "embed_rep": None,
            "embed": emb,
            "heads": None,
            "head_dim": None,
            "kv_heads": None,
            "mlp": None,
            "experts": None,
            "expert_mlp": None,
            "state": None,
        }

    heads_ok = cfg.num_heads % m == 0
    rules = {
        "layers": None,
        "vocab": "model",
        "embed_rep": None,
        "embed": None if cfg.layout == "serve" else "data",
        "heads": "model" if heads_ok else None,
        "head_dim": None if heads_ok else "model",
        # MHA archs (kv == m*k) split kv heads; GQA kv counts (1-8) < 16
        # stay replicated and the decode cache splits its sequence instead.
        "kv_heads": "model" if cfg.num_kv_heads % m == 0 else None,
        "mlp": "model" if cfg.d_ff % m == 0 else None,
        "experts": "model" if cfg.num_experts and cfg.num_experts % m == 0 else None,
        "expert_mlp": None,
        "state": "model" if (cfg.lru_width or cfg.d_model) % m == 0 else None,
    }
    if "data" not in names:
        rules["embed"] = None
    if "model" not in names:
        for k, v in rules.items():
            if v == "model":
                rules[k] = None
    return rules


def param_entries(model, mesh):
    """The tree of per-dim partition entries of the model's params."""
    return partition_specs(model.param_specs(), param_rules(model.cfg, mesh))


def _map_entries(fn, tree):
    """``fn`` over a tree (dicts and lists) whose leaves are entry tuples."""
    if isinstance(tree, dict):
        return {k: _map_entries(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_entries(fn, v) for v in tree]
    return fn(tree)


def param_shardings(model, mesh):
    """A ``NamedSharding`` tree matching the param tree."""
    return _map_entries(lambda s: NamedSharding(mesh, s), param_entries(model, mesh))


def quantized_param_shardings(model, mesh, abstract_params):
    """Shardings of an int8-quantized param tree (``repro_torch.quant``):
    a quantized leaf becomes ``{"q": <the weight's sharding>, "s": <the
    same less its last dim>}``. Returns ``(shardings, abstract tree)``."""
    from repro_torch.quant import abstract_quantize_tree

    p_sh = param_shardings(model, mesh)
    q_tree = abstract_quantize_tree(abstract_params)

    def f(sh, q):
        if isinstance(q, dict) and set(q) == {"q", "s"}:
            spec = list(sh.spec) + [None] * (q["q"].dim() - len(sh.spec))
            return {"q": sh, "s": NamedSharding(mesh, (*spec[:-1], None))}
        return sh

    def walk(sh, q):
        if isinstance(sh, NamedSharding):
            return f(sh, q)
        if isinstance(sh, dict):
            return {k: walk(sh[k], q[k]) for k in sh}
        return [walk(a, b) for a, b in zip(sh, q)]

    return walk(p_sh, q_tree), q_tree


def opt_shardings(model, mesh, opt_state_template):
    """Optimizer m/v follow the param shardings; the step is replicated."""
    ps = param_shardings(model, mesh)
    return type(opt_state_template)(m=ps, v=ps, step=NamedSharding(mesh, ()))


def batch_shardings(model, mesh, batch_specs: dict):
    """Batch dim over (pod, data); everything else replicated. Batches too
    small to split (long_500k has global_batch=1) stay replicated."""
    dist = make_dist(mesh, model.cfg.layout)
    out = {}
    for k, t in batch_specs.items():
        spec = [None] * t.dim()
        if t.dim() and t.shape[0] % max(dist.batch_size, 1) == 0:
            spec[0] = dist.batch
        out[k] = NamedSharding(mesh, spec)
    return out


def state_shardings(model, mesh, state_template):
    """Decode-state shardings by family (see the module docstring)."""
    dist = make_dist(mesh, model.cfg.layout)
    mdl = dist.model_axis
    cfg = model.cfg
    m = axis_sizes(mesh)[mdl] if mdl else 1
    bs = max(dist.batch_size, 1)

    def bspec(nbatch: int):
        return dist.batch if nbatch % bs == 0 else None

    def rep(leaf):
        return (None,) * leaf.dim()

    def kv_cache_spec(leaf):
        # [L, B, T, KH, Dh]: batch over data; kv-heads over model when they
        # divide it, else the sequence over model.
        if leaf.dim() == 5:
            t, kh = leaf.shape[2], leaf.shape[3]
            if kh % m == 0:
                return (None, bspec(leaf.shape[1]), None, mdl, None)
            return (None, bspec(leaf.shape[1]), mdl if t % m == 0 else None, None, None)
        if leaf.dim() == 1:  # lengths [B]
            return (bspec(leaf.shape[0]),)
        return rep(leaf)

    def rwkv_spec(leaf):
        if leaf.dim() == 3:  # x_tm/x_cm [L, B, D]
            return (None, bspec(leaf.shape[1]), mdl if leaf.shape[2] % m == 0 else None)
        if leaf.dim() == 5:  # wkv [L, B, H, dk, dv]
            return (None, bspec(leaf.shape[1]), mdl if leaf.shape[2] % m == 0 else None, None, None)
        return rep(leaf)

    def rglru_spec(leaf):
        if leaf.dim() == 3:  # conv [B, 3, W]
            return (bspec(leaf.shape[0]), None, mdl if leaf.shape[2] % m == 0 else None)
        if leaf.dim() == 2:  # h [B, W]
            return (bspec(leaf.shape[0]), mdl if leaf.shape[1] % m == 0 else None)
        if leaf.dim() == 4:  # window kv [B, W, KH, Dh]
            return (bspec(leaf.shape[0]), mdl if leaf.shape[1] % m == 0 else None, None, None)
        if leaf.dim() == 1:
            return (bspec(leaf.shape[0]),)
        return rep(leaf)

    fam = cfg.family
    if fam in ("dense", "moe", "vlm", "audio"):
        fn = kv_cache_spec
    elif fam == "ssm":
        fn = rwkv_spec
    elif fam == "hybrid":
        fn = rglru_spec
    else:
        raise ValueError(fam)
    return tree_lib.tree_map(lambda leaf: NamedSharding(mesh, fn(leaf)), state_template)


# ---------------------------------------------------------------------------
# Placement: a rank's blocks.


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's block of a tensor of ``shape``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = axes_size(mesh, entry_axes(entry))
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split over {entry} ({n})")
        out[dim] //= n
    return tuple(out)


def place(t: torch.Tensor, sharding: NamedSharding, dist) -> torch.Tensor:
    """This rank's block of ``t`` (a whole tensor, the same on every rank)
    under ``sharding``, as a new contiguous tensor."""
    if not on_mesh(dist):
        return t
    for dim, entry in enumerate(sharding.spec):
        axes = entry_axes(entry)
        if axes:
            n = t.shape[dim] // axes_size(dist.mesh, axes)
            t = t.narrow(dim, coord(dist, axes) * n, n)
    return t.contiguous()


def place_tree(tree, shardings, dist):
    """``place`` over a tree and its sharding tree (the same structure)."""
    if not on_mesh(dist):
        return tree
    return tree_lib.tree_map(lambda t, sh: place(t, sh, dist), tree, shardings)


def dist_for_batch(dist, rows: int):
    """``dist`` for a batch of ``rows`` rows: a batch the batch axes do not
    divide is held whole by every rank (``batch_axes=()``), as
    ``batch_shardings`` leaves it replicated."""
    if on_mesh(dist) and dist.batch_axes and rows % max(dist.batch_size, 1):
        return dist._replace(batch_axes=())
    return dist

