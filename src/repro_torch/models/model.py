"""The model facade (counterpart of ``src/repro/models/model.py``): one
``Model`` over the decoder-only families ``dense`` and ``moe``.

  init(gen)                                  — params from a torch.Generator
  loss(params, batch, dist, hot_ids, hot_embed) — the training objective
  init_state(batch, cache_len)               — zeroed decode state (KVCache)
  prefill(params, batch, dist, cache_len)    — full sequence, builds state
  decode_step(params, state, tokens, dist)   — one new token per sequence

A ``Model`` lives on one device (``device=None`` means CUDA and raises
without a card; see ``device.resolve_device``). The families ``ssm``,
``hybrid``, ``audio`` and ``vlm`` and quantized (int8) params raise
``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.hot_embedding import embed_with_cache
from repro_torch.device import resolve_device
from repro_torch.dist import embed_lookup, softmax_xent, unembed_logits
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, norm_specs
from repro_torch.models.params import ParamSpec, count_params, embed_init, init_params

__all__ = ["Model", "build"]

FAMILIES = ("dense", "moe")
_LATER = {
    "ssm": "the RWKV-6 slice",
    "hybrid": "the RecurrentGemma slice",
    "audio": "the encoder-decoder slice",
    "vlm": "the vision-language slice",
}


def _check_not_quantized(tree, path: str = "params") -> None:
    """Raise on an int8 leaf of the reference's ``repro/quant.py`` form
    (a ``{"q", "s"}`` dict)."""
    if isinstance(tree, dict):
        if set(tree) == {"q", "s"}:
            raise NotImplementedError(
                f"quantized params ({path}) are not ported yet: quantized-serving slice")
        for key, val in tree.items():
            _check_not_quantized(val, f"{path}.{key}")


class Model:
    def __init__(self, cfg, device=None):
        if cfg.family not in FAMILIES:
            later = _LATER.get(cfg.family, "a later slice")
            raise NotImplementedError(f"family {cfg.family!r} is not ported yet: {later}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._specs = self._build_specs()

    # ------------------------------------------------------------- params
    def _build_specs(self) -> dict:
        cfg = self.cfg
        d, v = cfg.d_model, cfg.padded_vocab
        specs: dict[str, Any] = {
            "embed": ParamSpec((v, d), embed_init(0.02)),
            "ln_f": norm_specs(d, cfg.norm),
            "blocks": tfm.stacked_block_specs(cfg),
        }
        if not cfg.tie_embeddings:
            specs["head"] = ParamSpec((v, d), embed_init(0.02))
        return specs

    def init(self, gen: torch.Generator) -> dict:
        """Params on the model's device; ``gen`` must live there too."""
        return init_params(self._specs, gen, self.device)

    # ------------------------------------------------------------- embed
    def _head_table(self, params: dict) -> torch.Tensor:
        return params["embed"] if self.cfg.tie_embeddings else params["head"]

    def num_params(self) -> int:
        return count_params(self._specs)

    def active_params(self) -> int:
        """Parameters touched per token (MoE: shared + top_k of routed)."""
        cfg = self.cfg
        total = self.num_params()
        if not cfg.num_experts:
            return total
        expert = 3 * cfg.d_model * cfg.d_ff  # one routed expert's FFN
        return total - cfg.num_layers * (cfg.num_experts - cfg.top_k) * expert

    def embed_tokens(self, params: dict, tokens: torch.Tensor, dist=None,
                     hot_embed=None) -> torch.Tensor:
        """tokens ``[B, S]`` -> bf16 rows ``[B, S, D]``. With ``hot_embed``
        (a ``HotEmbeddingState``) and ``cfg.hot_embed_rows``, the rows come
        through the Redynis hot-row cache (``embed_with_cache``, the
        ``hot_gather`` kernel on the card), whose gradient reaches the live
        table."""
        if hot_embed is not None and self.cfg.hot_embed_rows:
            h, _ = embed_with_cache(params["embed"], tokens, hot_embed, dist)
            return h.to(torch.bfloat16)
        return embed_lookup(params["embed"], tokens, dist).to(torch.bfloat16)

    # ------------------------------------------------------------- train
    def loss(self, params: dict, batch: dict, dist=None, hot_ids: torch.Tensor | None = None,
             hot_embed=None):
        """Mean next-token cross-entropy (plus the MoE aux loss). batch holds
        ``tokens`` and ``targets`` ``[B, S]`` (a target below 0 is masked);
        ``hot_ids [L, R]`` are the expert replica sets, ``hot_embed`` the
        hot-row cache state. Returns ``(loss, metrics)`` with the
        reference's keys: ``xent``, ``loss`` and, for MoE, ``moe_counts
        [L, G, E]``, ``moe_aux``, ``moe_dropped``, ``moe_hot_frac``."""
        _check_not_quantized(params)
        cfg = self.cfg
        tokens, targets = batch["tokens"], batch["targets"]
        h = self.embed_tokens(params, tokens, dist, hot_embed)
        h, _, moe_stats = tfm.run_decoder(params["blocks"], h, cfg, dist, mode="train",
                                          window=cfg.window, attn_chunk=cfg.attn_chunk,
                                          hot_ids=hot_ids)
        h = apply_norm(params["ln_f"], h, cfg.norm)
        mask = targets >= 0
        xent = softmax_xent(h, self._head_table(params), torch.where(mask, targets, 0), dist,
                            mask=mask, num_chunks=cfg.xent_chunks, vocab_size=cfg.vocab_size)
        metrics: dict[str, Any] = {"xent": xent}
        loss = xent
        if moe_stats is not None:
            loss = loss + cfg.moe_aux_weight * moe_stats["aux"]
            metrics.update(moe_counts=moe_stats["counts"], moe_aux=moe_stats["aux"],
                           moe_dropped=moe_stats["dropped"], moe_hot_frac=moe_stats["hot_frac"])
        metrics["loss"] = loss
        return loss, metrics

    # ------------------------------------------------------------- serve
    def init_state(self, batch: int, cache_len: int) -> tfm.KVCache:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        return tfm.KVCache(
            k=torch.zeros(shape, dtype=torch.bfloat16, device=self.device),
            v=torch.zeros(shape, dtype=torch.bfloat16, device=self.device),
            length=torch.zeros(batch, dtype=torch.int32, device=self.device),
        )

    def prefill(self, params: dict, batch: dict, dist=None, cache_len: int | None = None,
                hot_ids: torch.Tensor | None = None):
        """Full-sequence pass building decode state. Returns ``(logits [B, V]
        f32, KVCache)``; ``cache_len`` pads the cache with zeros beyond the
        prompt for generation."""
        _check_not_quantized(params)
        cfg = self.cfg
        tokens = batch["tokens"]
        s = tokens.shape[1]
        cache_len = cache_len or s
        h = self.embed_tokens(params, tokens, dist)
        h, cache, _ = tfm.run_decoder(params["blocks"], h, cfg, dist, mode="prefill",
                                      window=cfg.window, hot_ids=hot_ids)
        if cache_len > s:
            pad = (0, 0, 0, 0, 0, cache_len - s)  # the T dim of [L, B, T, KH, Dh]
            cache = cache._replace(k=torch.nn.functional.pad(cache.k, pad),
                                   v=torch.nn.functional.pad(cache.v, pad))
        h_last = apply_norm(params["ln_f"], h[:, -1:], cfg.norm)[:, 0]
        logits = unembed_logits(h_last, self._head_table(params), dist, cfg.vocab_size)
        return logits, cache

    def decode_step(self, params: dict, state: tfm.KVCache, tokens: torch.Tensor, dist=None,
                    hot_ids: torch.Tensor | None = None):
        """serve_step: one new token per sequence (``tokens [B]``, the most
        recent token of each) against the decode state, whose cache is
        written in place. Returns ``(logits [B, V] f32, state)``."""
        _check_not_quantized(params)
        cfg = self.cfg
        h = embed_lookup(params["embed"], tokens[:, None], dist)[:, 0].to(torch.bfloat16)
        h, state, _ = tfm.run_decode_step(params["blocks"], h, state, cfg, dist,
                                          window=cfg.window, hot_ids=hot_ids)
        h = apply_norm(params["ln_f"], h[:, None, :], cfg.norm)[:, 0]
        return unembed_logits(h, self._head_table(params), dist, cfg.vocab_size), state


def build(cfg, device=None) -> Model:
    return Model(cfg, device)
