"""Deterministic, exactly replayable data pipeline (counterpart of
``src/repro/data/pipeline.py``).

  * fault tolerance — the stream position is one integer; a batch is a pure
    function of ``(seed, step)``, so a restore replays from the recorded
    step with the same batches.
  * Redynis-relevant traffic — token frequencies are Zipfian, so the
    hot-row embedding cache and the MoE routing skew have something real to
    chase.

Two sources: ``synthetic`` (a Zipfian stream where, with probability 0.5, a
token repeats its left neighbour shifted by one, so the loss can fall) and
``memmap`` (a token file written by ``write_token_file``). The synthetic
draws go through ``kvsim/prng.py`` (``fold_in(PRNGKey(seed), step)``,
``choice`` with ``p`` and ``bernoulli``), so a seed gives the reference's
tokens bit for bit; the memmap source reads the same file the same way.
Batches are made on the pipeline's device (``None`` means CUDA).
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kvsim import prng

__all__ = ["DataConfig", "PipelineState", "Pipeline", "write_token_file"]


class DataConfig(NamedTuple):
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"  # synthetic | memmap
    path: str = ""  # token file for the memmap source
    zipf_a: float = 1.2  # Zipf exponent of the synthetic token frequencies
    pad_id: int = -1


class PipelineState(NamedTuple):
    step: int  # the only state; checkpointable as one int


class Pipeline:
    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._tokens = np.memmap(cfg.path, dtype=np.int32, mode="r") if cfg.source == "memmap" else None
        # The Zipfian unigram table, f32 as the reference's, and its prefix
        # sum as XLA forms it (``prng.xla_cumsum``), once.
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._probs = (p / p.sum()).astype(np.float32)
        self._cuml = torch.from_numpy(prng.xla_cumsum(self._probs)).to(self.device)

    def init_state(self) -> PipelineState:
        return PipelineState(step=0)

    # -- batch generation -----------------------------------------------------
    def _synthetic(self, step: int) -> torch.Tensor:
        cfg = self.cfg
        key = prng.fold_in(prng.prng_key(cfg.seed), step)
        b, s = cfg.global_batch, cfg.seq_len
        pos = torch.arange(b * (s + 1), device=self.device)
        base = prng.choice(key, cfg.vocab_size, pos, cuml=self._cuml).reshape(b, s + 1)
        copy = prng.bernoulli(prng.fold_in(key, 1), 0.5, pos).reshape(b, s + 1)
        shifted = torch.roll(base, 1, dims=1)
        return torch.where(copy, (shifted + 1) % cfg.vocab_size, base).to(torch.int32)

    def _memmap(self, step: int) -> torch.Tensor:
        cfg = self.cfg
        b, s = cfg.global_batch, cfg.seq_len
        need = b * (s + 1)
        total = len(self._tokens) - need
        start = (int(step) * need) % max(total, 1)
        flat = np.array(self._tokens[start : start + need], dtype=np.int32)
        return torch.from_numpy(flat.reshape(b, s + 1)).to(self.device)

    def next(self, state: PipelineState) -> tuple[dict, PipelineState]:
        """Returns ``(batch {tokens, targets}, next_state)``."""
        toks = self._memmap(state.step) if self.cfg.source == "memmap" else self._synthetic(state.step)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}, PipelineState(step=state.step + 1)

    def seek(self, step: int) -> PipelineState:
        """The exact replay position for a restore after a failure."""
        return PipelineState(step=int(step))

    def __iter__(self) -> Iterator[dict]:
        st = self.init_state()
        while True:
            batch, st = self.next(st)
            yield batch


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Persist a tokenised corpus for the memmap source (atomically)."""
    tmp = path + ".tmp"
    np.asarray(tokens, dtype=np.int32).tofile(tmp)
    os.replace(tmp, path)
