"""Ranks of one program: the transport of the key-sharded engine and of
``core/repartition.py``, and the launcher that starts the ranks (the
counterpart of the reference's ``shard_map`` over a ``Mesh``,
``src/repro/kvsim/simulate.py::_sharded_simulate_jit``).

The port runs SPMD, PyTorch's idiom: each of ``S`` processes of one
``torch.distributed`` group calls the same entry point with the same
arguments, holds its own block of the key axis, and the cross-rank folds
assemble what the reference's ``psum`` assembles.

**The transport is gloo, and every fold is an ``all_reduce(SUM)``.** The
card is one H100 and NCCL takes one rank a device, so on the card the ranks
are processes sharing that one card; gloo takes CUDA tensors for
``all_reduce`` (not reliably for ``all_gather``), and CPU tensors for the
CPU runs. So an all-gather is written as an ``all_reduce`` over a zero
buffer with one slot a rank (:func:`gather_ranks`): each rank writes its
own slot, and ``x + 0`` is exact. Each collective on a CUDA tensor makes
the host wait for the device.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

__all__ = ["BACKEND", "all_sum", "gather_ranks", "rank_of", "world_group", "run_ranks", "call_each"]

BACKEND = "gloo"


def rank_of(group) -> int:
    """This process's rank in ``group`` (0 with ``group=None``)."""
    return 0 if group is None else dist.get_rank(group)


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (a new tensor; ``t`` itself
    with ``group=None``, the one-rank program)."""
    if group is None:
        return t
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def gather_ranks(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (the
    reference's tiled ``all_gather``), as an ``all_reduce`` over a zero
    buffer in which each rank fills its own slot."""
    if group is None:
        return t
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    moved = t.movedim(dim, 0)
    buf = moved.new_zeros((size, *moved.shape))
    buf[rank] = moved
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.reshape(size * moved.shape[0], *moved.shape[1:]).movedim(0, dim)


def world_group(num_ranks: int, caller: str):
    """The default group, which must hold exactly ``num_ranks`` ranks."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"{caller}: num_shards={num_ranks} needs an initialised torch.distributed group of "
            f"{num_ranks} ranks, each calling with the same arguments (spmd.run_ranks starts one); "
            "none is initialised"
        )
    size = dist.get_world_size()
    if size != num_ranks:
        raise ValueError(
            f"{caller}: num_shards={num_ranks} needs a torch.distributed group of {num_ranks} "
            f"ranks, the initialised group has {size}"
        )
    return dist.group.WORLD


def call_each(fn, calls: list) -> list:
    """``[fn(*args, **kwargs) for (args, kwargs) in calls]``: several calls
    in one launch of the ranks."""
    return [fn(*args, **kwargs) for args, kwargs in calls]


def _rank_main(rank: int, num_ranks: int, init_method: str, timeout: float, fn, args, kwargs,
               results) -> None:
    # The first CPU ``exp`` of a process can be off in the last bits (seen
    # with PyTorch 2.13 on x86); ranks draw the same trace only if none of
    # them takes that first call on the trace.
    torch.exp(torch.zeros(1))
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(BACKEND, init_method=init_method, rank=rank, world_size=num_ranks,
                            timeout=timedelta(seconds=timeout))
    try:
        # Pickled here, by value: a tensor put on the queue as it is would
        # be shared through a descriptor that dies with this process.
        results.put((rank, True, pickle.dumps(fn(*args, **kwargs))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, num_ranks: int, *args, timeout: float = 600.0, **kwargs) -> list:
    """Run ``fn(*args, **kwargs)`` on each of ``num_ranks`` spawned
    processes that form one ``torch.distributed`` group (``BACKEND``, its
    store a file in a new temporary directory), and return every rank's
    result in rank order. ``fn`` and its arguments are pickled, so ``fn``
    is a module-level function.

    Everything is bounded by ``timeout`` seconds: the group's collectives
    (``init_process_group(timeout=...)``) and the wait for the results.
    When it expires, or a rank fails or dies, the launcher raises and kills
    every rank still running."""
    ctx = multiprocessing.get_context("spawn")
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, num_ranks, init_method, timeout, fn, args, kwargs, results))
                 for rank in range(num_ranks)]
        for p in procs:
            p.start()
        got: dict = {}
        try:
            while len(got) < num_ranks:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: {num_ranks} ranks not done in {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [i for i, p in enumerate(procs) if i not in got and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"run_ranks: rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result") from None
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} failed:\n{payload}")
                got[rank] = pickle.loads(payload)
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
            results.join_thread()
    return [got[rank] for rank in range(num_ranks)]
