"""The distribution seam threaded through the models (counterpart of
``src/repro/dist.py``).

Models take a :class:`DistSpec`. ``dist=None`` (or a spec without a mesh)
runs one device and every helper here is the plain single-device op. With
a mesh (a ``torch.distributed.device_mesh.DeviceMesh``) the port runs
SPMD in **local view**: each rank holds its own block of every tensor, as
``launch/sharding.py`` places params, optimizer state, batches and decode
state, and the model code calls the collectives here where the reference
leaves them to the SPMD partitioner (GSPMD):

  * the batch rows are split over ``batch_axes`` (a batch those axes do not
    divide runs with ``batch_axes=()``: every rank holds all rows);
  * attention heads, MLP width, experts and the vocabulary are split over
    ``model_axis`` (tensor parallelism), the Megatron way: a replicated
    activation enters a rank's own slice of the work through
    :func:`copy_to` (identity; its gradient is summed over the axis) and
    the partial results leave through :func:`all_reduce` (summed; its
    gradient passes as it is);
  * a param dim split over mesh axes that its compute does not keep split
    is gathered (:func:`all_gather`, ZeRO-3's gather); the gradient of a
    gather over batch axes is summed over them (reduce-scatter), and
    every other gradient that rows on other ranks add to is summed after
    the backward pass (:func:`sync_grads`).

The two placement-sensitive ops are written out as in the reference:
``embed_lookup`` is a masked local gather of this rank's vocabulary rows
plus one all-reduce over the model axis (the table is never gathered),
and ``softmax_xent`` keeps the logits vocab-split: max and sum-exp are
all-reduces, the label logit a masked sum, each token chunk checkpointed.

The collectives are ``torch.distributed`` calls on the mesh's per-axis
groups. On gloo (the ranks that share one card, and the CPU) an all-gather
is an all-reduce over a zero buffer with one slot a rank (gloo serves
``all_reduce`` on CUDA tensors; ``x + 0`` is exact), a reduce-scatter an
all-reduce and a slice. Every collective is counted, by kind and bytes, in
:data:`COMM` (``reset_comm`` / ``comm_totals``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as tdist
import torch.utils.checkpoint

__all__ = [
    "DistSpec",
    "local_dist",
    "constrain",
    "embed_lookup",
    "softmax_xent",
    "unembed_logits",
]


def axis_sizes(mesh) -> dict:
    """Mesh axis name -> size, for a ``DeviceMesh`` or any mesh with
    ``axis_names`` and ``axis_sizes`` (``launch.mesh.AbstractMesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(s) for n, s in zip(names, mesh.mesh.shape)}
    return {n: int(s) for n, s in zip(mesh.axis_names, mesh.axis_sizes)}


class DistSpec(NamedTuple):
    """Mesh and logical-axis bindings for one run.

    batch_axes: mesh axes the global batch is split over — ``("data",)``
                one pod, ``("pod", "data")`` several.
    model_axis: mesh axis for tensor/expert/vocab parallelism (None = off).
    """

    mesh: Optional[object] = None
    batch_axes: tuple = ()
    model_axis: Optional[str] = None

    @property
    def batch(self):  # the partition entry of the batch dim
        return self.batch_axes if self.batch_axes else None

    @property
    def tensor_parallel(self) -> bool:
        """True when the model axis is free for TP (not consumed by the
        batch). The fsdp layout spreads the batch over the model axis too;
        heads and experts then stay whole."""
        return self.model_axis is not None and self.model_axis not in self.batch_axes

    @property
    def loss_batch(self):
        """The row entry of the vocab-split ops (embedding lookup, xent):
        the batch axes less the model axis, which the vocabulary holds."""
        axes = tuple(a for a in self.batch_axes if a != self.model_axis)
        return axes if axes else None

    @property
    def model_size(self) -> int:
        if self.mesh is None or self.model_axis is None:
            return 1
        return axis_sizes(self.mesh)[self.model_axis]

    @property
    def batch_size(self) -> int:
        if self.mesh is None:
            return 1
        sizes = axis_sizes(self.mesh)
        n = 1
        for a in self.batch_axes:
            n *= sizes[a]
        return n


def local_dist() -> DistSpec:
    """The no-mesh context of the single-device runs."""
    return DistSpec()


def on_mesh(dist) -> bool:
    return dist is not None and dist.mesh is not None


def entry_axes(entry) -> tuple:
    """A partition entry (``None``, an axis, or a tuple of axes) as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axes_size(mesh, axes) -> int:
    """The number of blocks a dim split over ``axes`` has."""
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def coord(dist, axes) -> int:
    """This rank's block index along ``axes`` (row-major, the first axis
    major: the order of a dim split over several axes)."""
    sizes = axis_sizes(dist.mesh)
    c = 0
    for a in axes:
        c = c * sizes[a] + int(dist.mesh.get_local_rank(a))
    return c


# ---------------------------------------------------------------------------
# Collectives (counted), and their autograd forms.

COMM: dict = {}  # kind -> [calls, bytes]


def reset_comm() -> None:
    COMM.clear()


def comm_totals() -> dict:
    """``{kind: {"calls": n, "bytes": b}}`` since the last ``reset_comm``."""
    return {k: {"calls": int(v[0]), "bytes": float(v[1])} for k, v in sorted(COMM.items())}


def _count(kind: str, t: torch.Tensor) -> None:
    rec = COMM.setdefault(kind, [0, 0.0])
    rec[0] += 1
    rec[1] += t.numel() * t.element_size()


def _live(dist, axes) -> tuple:
    sizes = axis_sizes(dist.mesh)
    return tuple(a for a in axes if sizes[a] > 1)


def _reduce_(t: torch.Tensor, dist, axes, op=tdist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over each of ``axes``."""
    for a in _live(dist, axes):
        tdist.all_reduce(t, op=op, group=dist.mesh.get_group(a))
        _count("all-reduce", t)
    return t


def _gather(t: torch.Tensor, dim: int, dist, axes) -> torch.Tensor:
    """Every rank's block of ``dim`` concatenated in block order."""
    sizes = axis_sizes(dist.mesh)
    for a in reversed(_live(dist, axes)):  # the minor axis first
        n, group = sizes[a], dist.mesh.get_group(a)
        moved = t.movedim(dim, 0).contiguous()
        if tdist.get_backend(group) == "gloo":
            buf = moved.new_zeros((n, *moved.shape))
            buf[int(dist.mesh.get_local_rank(a))] = moved
            tdist.all_reduce(buf, group=group)
            _count("all-reduce", buf)
            out = buf.reshape(n * moved.shape[0], *moved.shape[1:])
        else:
            out = moved.new_empty((n * moved.shape[0], *moved.shape[1:]))
            tdist.all_gather_into_tensor(out, moved, group=group)
            _count("all-gather", out)
        t = out.movedim(0, dim)
    return t


def _own(t: torch.Tensor, dim: int, dist, axes) -> torch.Tensor:
    n = t.shape[dim] // axes_size(dist.mesh, axes)
    return t.narrow(dim, coord(dist, axes) * n, n)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, axes):
        return _reduce_(x.clone(), dist, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, axes):
        ctx.dist, ctx.axes = dist, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_(g.clone(), ctx.dist, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, dist, axes, sum_axes):
        ctx.dim, ctx.dist, ctx.axes, ctx.sum_axes = dim, dist, axes, sum_axes
        return _gather(x, dim, dist, axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_axes:
            g = _reduce_(g.contiguous().clone(), ctx.dist, ctx.sum_axes)
        return _own(g, ctx.dim, ctx.dist, ctx.axes).contiguous(), None, None, None, None


def all_reduce(x: torch.Tensor, dist, axes) -> torch.Tensor:
    """Partial values summed over ``axes`` (the result is replicated; its
    gradient reaches every partial as it is)."""
    if not on_mesh(dist) or not _live(dist, axes):
        return x
    return _AllReduce.apply(x, dist, tuple(axes))


def copy_to(x: torch.Tensor, dist, axes) -> torch.Tensor:
    """A replicated value entering rank-specific work: ``x`` itself, whose
    gradient is summed over ``axes``."""
    if not on_mesh(dist) or not _live(dist, axes) or not torch.is_grad_enabled():
        return x
    return _CopyTo.apply(x, dist, tuple(axes))


def all_gather(x: torch.Tensor, dim: int, dist, axes) -> torch.Tensor:
    """``dim``'s blocks over ``axes`` concatenated. The gradient is summed
    over the axes among ``dist.batch_axes`` (rows differ there: a
    reduce-scatter) and sliced over the others (replicated compute)."""
    if not on_mesh(dist) or not _live(dist, axes):
        return x
    axes = tuple(axes)
    sum_axes = tuple(a for a in axes if a in dist.batch_axes)
    if not x.requires_grad:
        return _gather(x, dim, dist, axes)
    return _AllGather.apply(x, dim, dist, axes, sum_axes)


def all_max(x: torch.Tensor, dist, axes) -> torch.Tensor:
    """The max over ``axes`` (no gradient)."""
    out = x.detach().clone()
    if on_mesh(dist):
        _reduce_(out, dist, axes, op=tdist.ReduceOp.MAX)
    return out


def own_block(x: torch.Tensor, dim: int, dist, axes) -> torch.Tensor:
    """This rank's block of a replicated ``x`` along ``dim`` (its gradient
    is summed over ``axes``, then padded by the other blocks' zeros)."""
    if not on_mesh(dist) or not _live(dist, axes):
        return x
    return _own(copy_to(x, dist, axes), dim, dist, axes)


def gather_tree(tree, entries, dist):
    """Every leaf of ``tree`` with each dim whose entry in ``entries`` (a
    tree of per-dim partition entries) names mesh axes gathered over them."""
    if isinstance(tree, torch.Tensor):
        for dim, entry in enumerate(entries):
            if entry is not None:
                tree = all_gather(tree, dim, dist, entry_axes(entry))
        return tree
    if isinstance(tree, dict):
        return {k: gather_tree(v, entries[k], dist) for k, v in tree.items()}
    return type(tree)(gather_tree(v, e, dist) for v, e in zip(tree, entries))


def sync_grads(grads: list, entries: list, dist) -> list:
    """Each leaf's gradient summed over the batch axes it is not split over
    (the rows of other ranks add to it there; over the axes it is split
    over, its gather's reduce-scatter has summed them). ``entries`` holds
    each leaf's partition entries, in the leaves' order."""
    if not on_mesh(dist):
        return grads
    out = []
    for g, ent in zip(grads, entries):
        held = {a for e in ent for a in entry_axes(e)}
        axes = tuple(a for a in dist.batch_axes if a not in held)
        out.append(_reduce_(g.clone(), dist, axes) if _live(dist, axes) else g)
    return out


def constrain(x: torch.Tensor, dist, *spec) -> torch.Tensor:
    """The reference's sharding constraint in local view: without a mesh,
    ``x`` itself. With one, ``x`` holds its rows already split over the
    batch axes; each dim whose entry names mesh axes outside the batch
    axes is cut to this rank's block of them (``own_block``)."""
    if not on_mesh(dist):
        return x
    for dim, entry in enumerate(spec):
        cut = tuple(a for a in entry_axes(entry) if a not in dist.batch_axes)
        if cut:
            x = own_block(x, dim, dist, cut)
    return x


# ---------------------------------------------------------------------------
# Vocab-split embedding lookup.


def _rows_over_model(dist) -> bool:
    """True when the rows are split over the model axis too (fsdp): the
    vocab-split ops then take the rows of the whole model group."""
    return on_mesh(dist) and dist.model_axis is not None and dist.model_axis in dist.batch_axes


def vocab_rows(table: torch.Tensor, ids: torch.Tensor, dist) -> torch.Tensor:
    """Rows ``ids`` (any shape, global ids) of a table whose first dim is
    split over the model axis (a vocabulary, an expert stack): each rank
    takes the ids in its block, zeros for the others, and one all-reduce
    over the model axis sums them."""
    if not on_mesh(dist) or dist.model_axis is None or dist.model_size == 1:
        return table[ids.long()]
    v_local = table.shape[0]
    lo = coord(dist, (dist.model_axis,)) * v_local
    idx = ids.long() - lo
    ok = (idx >= 0) & (idx < v_local)
    rows = table[idx.clamp(0, v_local - 1)]
    ok = ok.reshape(ok.shape + (1,) * (table.dim() - 1))
    rows = torch.where(ok, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return all_reduce(rows, dist, (dist.model_axis,))


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, dist) -> torch.Tensor:
    """tokens ``[B, S]`` int -> rows ``[B, S, D]`` of ``table [V, D]`` (on a
    mesh, this rank's vocab block ``[V/m, D]``): the masked local gather and
    one all-reduce over the model axis; the table is never gathered."""
    if not on_mesh(dist) or dist.model_axis is None:
        return table[tokens.long()]
    if _rows_over_model(dist):
        mdl = (dist.model_axis,)
        rows = vocab_rows(table, _gather(tokens, 0, dist, mdl), dist)
        return own_block(rows, 0, dist, mdl)
    return vocab_rows(table, tokens, dist)


# ---------------------------------------------------------------------------
# Vocab-split LM head and cross-entropy.


def _vocab_cols(table: torch.Tensor, dist, device) -> torch.Tensor:
    """The global vocab index of each of this rank's table rows."""
    lo = 0
    if on_mesh(dist) and dist.model_axis is not None:
        lo = coord(dist, (dist.model_axis,)) * table.shape[0]
    return torch.arange(table.shape[0], device=device) + lo


def unembed_logits(x: torch.Tensor, table: torch.Tensor, dist, vocab_size: int = 0) -> torch.Tensor:
    """``x [..., D] @ table.T`` -> f32 logits ``[..., V]``: bf16 products
    are exact in f32, so the product runs in f32 (the reference's
    ``preferred_element_type``). Rows at or past ``vocab_size`` (table
    padding) are set to -1e30 so samplers never pick them. On a mesh the
    logits are this rank's vocab block ``[..., V/m]`` (the reference's
    V-split logits); ``gather_logits`` assembles them."""
    mdl = (dist.model_axis,) if on_mesh(dist) and dist.model_axis is not None else ()
    if mdl and _rows_over_model(dist):
        x = all_gather(x, 0, dist, mdl)
    elif mdl:
        x = copy_to(x, dist, mdl)
    logits = torch.matmul(x.float(), table.float().t())
    if vocab_size and vocab_size < table.shape[0] * (dist.model_size if mdl else 1):
        cols = _vocab_cols(table, dist, logits.device)
        logits = torch.where(cols >= vocab_size, -1e30, logits)
    return logits


def gather_logits(logits: torch.Tensor, dist) -> torch.Tensor:
    """Vocab-split logits ``[B, V/m]`` -> this rank's rows of all ``V``
    (what a sampler reads)."""
    if not on_mesh(dist) or dist.model_axis is None:
        return logits
    full = _gather(logits, logits.dim() - 1, dist, (dist.model_axis,))
    if _rows_over_model(dist):
        full = _own(full, 0, dist, (dist.model_axis,))
    return full


def _xent_chunk(x, targets, mask, table, dist, vocab_size: int, own=None):
    """Sum of token losses and the masked-token count of one chunk: x ``[C,
    D]``, targets ``[C]`` int, mask ``[C]`` f32, ``table [V, D]`` f32 (on a
    mesh, this rank's vocab block). Logits past ``vocab_size`` are -1e30;
    the label logit is picked by a masked sum, as the reference picks it.
    On a mesh the max and the sum-exp are all-reduces over the model axis
    (in f32), and so is the label logit; ``own`` (fsdp rows) masks the rows
    this rank does not hold."""
    logits = torch.matmul(x.float(), table.t())
    cols = _vocab_cols(table, dist, logits.device)
    split = dist.model_size if on_mesh(dist) else 1
    if vocab_size and vocab_size < table.shape[0] * split:
        logits = torch.where(cols >= vocab_size, -1e30, logits)
    onehot = cols[None, :] == targets[:, None]
    if on_mesh(dist) and dist.model_axis is not None:
        mdl = (dist.model_axis,)
        m = all_max(logits.amax(dim=-1, keepdim=True), dist, mdl)
        lse = torch.log(all_reduce(torch.exp(logits - m).sum(dim=-1), dist, mdl)) + m[:, 0]
        label = all_reduce(torch.where(onehot, logits, 0.0).sum(dim=-1), dist, mdl)
        loss = lse - label
        if own is not None:
            loss = copy_to(loss, dist, mdl)
            mask = mask * own
    else:
        m = logits.amax(dim=-1, keepdim=True)
        lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[:, 0]
        label = torch.where(onehot, logits, 0.0).sum(dim=-1)
        loss = lse - label
    loss = loss * mask
    return loss.sum(), mask.sum()


def softmax_xent(x, table, targets, dist=None, mask=None, num_chunks: int = 8,
                 vocab_size: int = 0) -> torch.Tensor:
    """Mean cross-entropy over masked tokens: x ``[B, S, D]``, table ``[V,
    D]``, targets ``[B, S]``. The tokens are cut into ``num_chunks`` chunks
    (fewer where they do not divide); each chunk's logits are recomputed in
    the backward pass (``torch.utils.checkpoint``), so one chunk of logits
    is live at a time, as under the reference's ``jax.checkpoint``. The
    chunk sums add up in order in f32.

    On a mesh the table is this rank's vocab block and the logits stay
    vocab-split (never gathered); the rows are this rank's, and the sums of
    loss and count are all-reduced over the batch axes, so that every rank
    returns the global mean."""
    b, s, d = x.shape
    mf = torch.ones((b, s), dtype=torch.float32, device=x.device) if mask is None \
        else mask.to(torch.float32)
    own = None
    mesh = on_mesh(dist) and dist.model_axis is not None
    if mesh and _rows_over_model(dist):
        mdl = (dist.model_axis,)
        x = all_gather(x, 0, dist, mdl)
        targets, mf = _gather(targets, 0, dist, mdl), _gather(mf, 0, dist, mdl)
        own = (torch.arange(x.shape[0], device=x.device) // b == coord(dist, mdl)).float()
        own = own[:, None].expand(-1, s)
        b = x.shape[0]
    elif mesh:
        x = copy_to(x, dist, (dist.model_axis,))
    t = b * s
    xf = x.reshape(t, d)
    tf = targets.reshape(t)
    mf = mf.reshape(t)
    own = None if own is None else own.reshape(t)
    num_chunks = min(num_chunks, t)
    while t % num_chunks:
        num_chunks -= 1
    c = t // num_chunks
    table_f = table.float()  # once a call; the chunks read it
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(num_chunks):
        rows = slice(i * c, (i + 1) * c)
        l, n = torch.utils.checkpoint.checkpoint(
            _xent_chunk, xf[rows], tf[rows], mf[rows], table_f, dist, vocab_size,
            None if own is None else own[rows], use_reentrant=False)
        tot, cnt = tot + l, cnt + n
    if on_mesh(dist):
        tot = all_reduce(tot, dist, dist.batch_axes)
        cnt = all_reduce(cnt.detach(), dist, dist.batch_axes)
    return tot / torch.clamp_min(cnt, 1.0)
