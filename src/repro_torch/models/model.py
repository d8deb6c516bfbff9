"""The model facade for the serving path (counterpart of
``src/repro/models/model.py``): one ``Model`` over the decoder-only
families ``dense`` and ``moe``.

  init(gen)                                  — params from a torch.Generator
  init_state(batch, cache_len)               — zeroed decode state (KVCache)
  prefill(params, batch, dist, cache_len)    — full sequence, builds state
  decode_step(params, state, tokens, dist)   — one new token per sequence

A ``Model`` lives on one device (``device=None`` means CUDA and raises
without a card; see ``device.resolve_device``). The families ``ssm``,
``hybrid``, ``audio`` and ``vlm``, the training ``loss`` and quantized
(int8) params raise ``NotImplementedError`` naming the slice that brings
them.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.dist import embed_lookup, unembed_logits
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, norm_specs
from repro_torch.models.params import ParamSpec, embed_init, init_params

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

    def embed_tokens(self, params: dict, tokens: torch.Tensor, dist=None) -> torch.Tensor:
        """tokens ``[B, S]`` -> bf16 rows ``[B, S, D]``. The reference's
        hot-row cache branch serves its training loss and comes with it."""
        return embed_lookup(params["embed"], tokens, dist).to(torch.bfloat16)

    # ------------------------------------------------------------- train
    def loss(self, *args, **kwargs):
        raise NotImplementedError("Model.loss is not ported yet: training slice")

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
