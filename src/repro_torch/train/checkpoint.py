"""Sharded, atomic, async checkpoints (counterpart of
``src/repro/train/checkpoint.py``), in the reference's on-disk layout::

    <root>/step_00000123/
        manifest.json          # step, metadata, each leaf's shape and dtype
        <leaf-path>.npy        # one file a leaf
    <root>/LATEST              # the newest step, replaced atomically

A leaf's name joins its path's entries with ``__`` as the reference's
``_leaf_paths`` does: a dict key as itself, a sequence index as its
number, a NamedTuple field as ``str(GetAttrKey)``, that is ``.name`` (so
the optimizer's first moment of ``params["embed"]`` is
``opt__.m__embed``). A JAX checkpoint restores here and one written here
restores in JAX: bf16 leaves are written as the raw 2-byte voids the
reference writes (``'<V2'`` in the ``.npy`` header, ``"bfloat16"`` in the
manifest) and read back through ``int16`` into ``torch.bfloat16``, without
``ml_dtypes``.

  * atomic  — a save goes to ``step_N.tmp-<pid>`` and is renamed into place
    (``os.replace``); ``LATEST`` is written last the same way.
  * sharded — ``shard_filter`` picks the leaves this process writes; the
    manifest lists them all.
  * async   — ``save_async`` copies the tree to host memory now (the live
    params are updated in place by the next step) and writes on a thread.
  * restore returns host (CPU) tensors; the caller moves them.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import tree as tree_lib

__all__ = ["save_checkpoint", "save_async", "restore_checkpoint", "latest_step", "gc_checkpoints"]

_SEP = "__"


def _entry_name(kind: str, val) -> str:
    return f".{val}" if kind == "attr" else str(val)


def _leaf_paths(tree) -> list[tuple[str, Any]]:
    return [(_SEP.join(_entry_name(kind, val) for kind, val in path), leaf)
            for path, leaf in tree_lib.leaves_with_paths(tree)]


def _host(leaf, copy: bool = False) -> torch.Tensor:
    """A leaf on the CPU; with ``copy``, never a view of a live tensor."""
    return torch.as_tensor(leaf).detach().to("cpu", copy=copy)


def _write_npy(path: str, t: torch.Tensor) -> str:
    """Write ``t`` as the reference writes it; returns its manifest dtype."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False, "shape": tuple(t.shape)})
            t.view(torch.int16).numpy().tofile(f)
        return "bfloat16"
    arr = t.numpy()
    np.save(path, arr)
    return str(arr.dtype)


def save_checkpoint(root: str, step: int, tree, metadata: dict | None = None,
                    shard_filter: Callable[[str], bool] | None = None) -> str:
    """Blocking save. Returns the checkpoint directory."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:08d}")
    tmp = f"{final}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for name, leaf in _leaf_paths(tree):
        t = _host(leaf)
        path = os.path.join(tmp, name + ".npy")
        if shard_filter is None or shard_filter(name):
            dtype = _write_npy(path, t)
        else:
            dtype = "bfloat16" if t.dtype == torch.bfloat16 else str(t.numpy().dtype)
        manifest["leaves"][name] = {"shape": list(t.shape), "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):  # an idempotent re-save
        shutil.rmtree(final)
    os.replace(tmp, final)
    latest_tmp = os.path.join(root, f".LATEST.tmp-{os.getpid()}")
    with open(latest_tmp, "w") as f:
        f.write(str(step))
    os.replace(latest_tmp, os.path.join(root, "LATEST"))
    return final


class AsyncSave(NamedTuple):
    thread: threading.Thread

    def wait(self) -> None:
        self.thread.join()


def save_async(root: str, step: int, tree, metadata: dict | None = None) -> AsyncSave:
    """Copy the tree to host memory now, write it on a worker thread."""
    host_tree = tree_lib.tree_map(lambda leaf: _host(leaf, copy=True), tree)
    t = threading.Thread(target=save_checkpoint, args=(root, step, host_tree, metadata), daemon=True)
    t.start()
    return AsyncSave(thread=t)


def latest_step(root: str) -> int | None:
    p = os.path.join(root, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _load(d: str, name: str, want: str) -> torch.Tensor:
    arr = np.load(os.path.join(d, name + ".npy"))
    if want == "bfloat16":  # raw 2-byte voids
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    if str(arr.dtype) != want:
        raise ValueError(f"checkpoint leaf {name}: dtype {arr.dtype}, manifest says {want}")
    return torch.from_numpy(arr)


def restore_checkpoint(root: str, step: int | None = None, template=None):
    """Load a checkpoint as CPU tensors. With ``template`` (a tree of the
    saved structure) the result has that structure; otherwise it is a flat
    ``{leaf-path: tensor}`` dict. The manifest comes back alongside."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {name: _load(d, name, meta["dtype"]) for name, meta in manifest["leaves"].items()}
    if template is None:
        return flat, manifest
    return tree_lib.unflatten(template, [flat[name] for name, _ in _leaf_paths(template)]), manifest


def gc_checkpoints(root: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    if not os.path.isdir(root):
        return
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(root)
                   if n.startswith("step_") and not n.endswith((".tmp", ".npy")) and "tmp" not in n)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"), ignore_errors=True)
