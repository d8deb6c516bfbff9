"""The model facade (counterpart of ``src/repro/models/model.py``): one
``Model`` over the six block families.

  dense | moe | vlm  -> the decoder-only transformer (GQA; the MoE FFN when
                        cfg.num_experts; vlm, the LLaVA vision-language
                        model, prepends stub patch embeddings)
  ssm                -> the RWKV-6 stack (attention-free)
  hybrid             -> the RecurrentGemma stack (RG-LRU and local attention)
  audio              -> the Whisper encoder-decoder (stub frame embeddings)

  init(gen)                                  — params from a torch.Generator
  loss(params, batch, dist, hot_ids, hot_embed) — the training objective
  init_state(batch, cache_len)               — zeroed decode state
  prefill(params, batch, dist, cache_len)    — full sequence, builds state
  decode_step(params, state, tokens, dist)   — one new token per sequence
  input_specs(shape)                         — a cell's batch as meta tensors
  make_batch(shape, key)                     — a synthetic batch of a cell

A ``Model`` lives on one device (``device=None`` means CUDA and raises
without a card; see ``device.resolve_device``). With a ``dist`` on a mesh
each rank runs these methods on its own blocks (``dist.py``, local view;
``launch/sharding.py`` places them): the decoder families (dense, moe,
vlm) split heads, MLP width, experts and vocabulary over the model axis
and gather each layer's FSDP-split params in its body; the ssm, hybrid and
audio stacks gather their params and run whole over the model axis (their
decode state too), the vocabulary still split. Logits come back
vocab-split (``dist.gather_logits`` assembles them). ``loss`` trains all six
families through the reference's branches, the training forwards of each
stack (``train`` mode: blockwise attention under autograd, remat by
``cfg.remat``). int8 params (``repro_torch.quant``) are taken where the
reference takes them, by ``decode_step`` of ``dense``, ``moe`` and
``vlm``: ``embed`` and ``head`` are dequantized once a step, the blocks a
layer at a time. ``prefill`` and ``loss`` raise on them, and so does the
decode step of the other families, as the reference fails there.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.core.hot_embedding import embed_with_cache
from repro_torch.device import resolve_device
from repro_torch.dist import constrain, embed_lookup, gather_tree, on_mesh, softmax_xent, unembed_logits
from repro_torch.kvsim import prng
from repro_torch.models import encdec, rglru, rwkv6
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, norm_specs
from repro_torch.models.params import (ParamSpec, abstract_params, count_params, embed_init,
                                       init_params, map_specs)
from repro_torch.quant import dequant_leaf, has_quantized

__all__ = ["Model", "build"]

DECODER_FAMILIES = ("dense", "moe", "vlm")
FAMILIES = DECODER_FAMILIES + ("ssm", "hybrid", "audio")


def _check_not_quantized(tree, where: str) -> None:
    """Raise on an int8 leaf of the reference's ``repro/quant.py`` form (a
    ``{"q", "s"}`` dict) where the reference takes none."""
    if has_quantized(tree):
        raise NotImplementedError(
            f"quantized params are not taken by {where}: as in the reference (src/repro/quant.py), "
            "int8 params serve Model.decode_step of the dense, moe and vlm families only")


class Model:
    def __init__(self, cfg, device=None):
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._specs = self._build_specs()

    # ------------------------------------------------------------- params
    def _build_specs(self) -> dict:
        cfg = self.cfg
        d, v = cfg.d_model, cfg.padded_vocab
        specs: dict[str, Any] = {
            "embed": ParamSpec((v, d), ("vocab", "embed_rep"), embed_init(0.02)),
            "ln_f": norm_specs(d, cfg.norm),
        }
        if not cfg.tie_embeddings:
            specs["head"] = ParamSpec((v, d), ("vocab", "embed_rep"), embed_init(0.02))
        fam = cfg.family
        if fam in DECODER_FAMILIES:
            specs["blocks"] = tfm.stacked_block_specs(cfg)
        elif fam == "ssm":
            specs["blocks"] = rwkv6.rwkv_block_specs(cfg)
        elif fam == "hybrid":
            specs["blocks"] = rglru.rglru_block_specs(cfg)
        else:
            specs["blocks"] = encdec.encdec_specs(cfg)
        return specs

    def param_specs(self) -> dict:
        return self._specs

    def init(self, gen: torch.Generator) -> dict:
        """Params on the model's device; ``gen`` must live there too."""
        return init_params(self._specs, gen, self.device)

    def abstract_params(self) -> dict:
        """The params as ``meta`` tensors (the dry run; no allocation)."""
        return abstract_params(self._specs)

    # ------------------------------------------------------------- mesh
    def gathers(self, dist):
        """``None`` off a mesh; else the params' partition entries of the
        dims their compute gathers: every split dim but the vocabulary and,
        in the decoder families under TP, the heads, kv heads, MLP width
        and experts, which stay split over the model axis."""
        if not on_mesh(dist):
            return None
        from repro_torch.launch.sharding import param_rules

        rules = param_rules(self.cfg, dist.mesh)
        keep = {"vocab"}
        if dist.tensor_parallel and self.cfg.family in DECODER_FAMILIES:
            keep |= {"heads", "kv_heads", "mlp", "experts"}

        def one(spec):
            ent = tuple(None if ax is None else rules[ax] for ax in spec.axes)
            return tuple(None if (e == dist.model_axis and ax in keep) else e
                         for ax, e in zip(spec.axes, ent))

        return map_specs(one, self._specs)

    def _stack(self, params: dict, dist):
        """``(blocks, stack dist, decoder gathers)``: the decoder families'
        blocks as they are (each layer gathers in its body); the other
        families' blocks gathered whole, their stacks run with no mesh."""
        gathers = self.gathers(dist)
        if gathers is None:
            return params["blocks"], dist, None
        if self.cfg.family in DECODER_FAMILIES:
            return params["blocks"], dist, gathers["blocks"]
        return gather_tree(params["blocks"], gathers["blocks"], dist), None, None

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
        """tokens ``[B, S]`` -> bf16 rows ``[B, S, D]``, with the sinusoidal
        positions added where ``cfg.pos`` says so. With ``hot_embed`` (a
        ``HotEmbeddingState``) and ``cfg.hot_embed_rows``, the rows come
        through the Redynis hot-row cache (``embed_with_cache``, the
        ``hot_gather`` kernel on the card), whose gradient reaches the live
        table."""
        if hot_embed is not None and self.cfg.hot_embed_rows:
            h, _ = embed_with_cache(params["embed"], tokens, hot_embed, dist)
            h = h.to(torch.bfloat16)
        else:
            h = embed_lookup(params["embed"], tokens, dist).to(torch.bfloat16)
        if self.cfg.pos == "sinusoidal":
            s, d = tokens.shape[-1], self.cfg.d_model
            h = h + encdec.sinusoid(s, d, h.device).to(h.dtype)[None]
        return h

    # ------------------------------------------------------------- train
    def loss(self, params: dict, batch: dict, dist=None, hot_ids: torch.Tensor | None = None,
             hot_embed=None):
        """Mean next-token cross-entropy (plus the MoE aux loss). batch holds
        ``tokens`` and ``targets`` ``[B, S]`` (a target below 0 is masked),
        and ``patches [B, P, D]`` (vlm: prepended to the token rows, whose
        outputs alone are scored) or ``frames [B, F, D]`` (audio: the
        encoder's input); ``hot_ids [L, R]`` are the expert replica sets,
        ``hot_embed`` the hot-row cache state. Returns ``(loss, metrics)``
        with the reference's keys: ``xent``, ``loss`` and, for MoE,
        ``moe_counts [L, G, E]``, ``moe_aux``, ``moe_dropped``,
        ``moe_hot_frac``."""
        cfg = self.cfg
        _check_not_quantized(params, "Model.loss")
        tokens, targets = batch["tokens"], batch["targets"]
        h = self.embed_tokens(params, tokens, dist, hot_embed)
        blocks, sdist, gathers = self._stack(params, dist)
        moe_stats = None
        if cfg.family in DECODER_FAMILIES:
            if cfg.family == "vlm":
                h = torch.cat([batch["patches"].to(h.dtype), h], dim=1)
            h, _, moe_stats = tfm.run_decoder(blocks, h, cfg, sdist, mode="train",
                                              window=cfg.window, attn_chunk=cfg.attn_chunk,
                                              hot_ids=hot_ids, gathers=gathers)
            if cfg.family == "vlm":
                h = h[:, batch["patches"].shape[1]:]
        elif cfg.family == "ssm":
            h, _ = rwkv6.rwkv_forward(blocks, h, cfg, sdist, train=True)
        elif cfg.family == "hybrid":
            h, _ = rglru.rglru_forward(blocks, h, cfg, sdist, train=True)
        else:
            memory = encdec.encode(blocks, batch["frames"].to(h.dtype), cfg, sdist, train=True)
            h, _, _ = encdec.decode_prefill(blocks, h, memory, cfg, sdist, train=True)
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
    def init_state(self, batch: int, cache_len: int, abstract: bool = False):
        """The zeroed decode state of ``batch`` sequences: a ``KVCache`` of
        ``cache_len`` slots (dense, moe, vlm), an ``RWKVState``, an
        ``RGLRUState`` (ring buffers of ``cfg.window`` slots, whatever
        ``cache_len``) or an ``EncDecState``. ``abstract`` gives shapes and
        dtypes only (tensors on the ``meta`` device)."""
        cfg = self.cfg
        if cfg.family in DECODER_FAMILIES:
            specs = tfm.init_cache_specs(cfg, batch, cache_len)
            if abstract:
                return specs
            return tfm.KVCache(*(torch.zeros(t.shape, dtype=t.dtype, device=self.device)
                                 for t in specs))
        if cfg.family == "ssm":
            return rwkv6.init_rwkv_state(cfg, batch, abstract, self.device)
        if cfg.family == "hybrid":
            return rglru.init_rglru_state(cfg, batch, abstract, self.device)
        return encdec.init_encdec_state(cfg, batch, cache_len, abstract, self.device)

    def prefill(self, params: dict, batch: dict, dist=None, cache_len: int | None = None,
                hot_ids: torch.Tensor | None = None):
        """Full-sequence pass building decode state. Returns ``(logits [B, V]
        f32, state)``. batch holds ``tokens [B, S]``, and ``patches [B, P,
        D]`` (vlm, prepended to the token rows, so that the cache holds P + S
        positions) or ``frames [B, F, D]`` (audio). ``cache_len`` pads a
        KV cache with zeros beyond the prompt for generation."""
        _check_not_quantized(params, "Model.prefill")
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache_len = cache_len or s
        h = self.embed_tokens(params, tokens, dist)
        blocks, sdist, gathers = self._stack(params, dist)
        if cfg.family in DECODER_FAMILIES:
            if cfg.family == "vlm":
                h = torch.cat([batch["patches"].to(h.dtype), h], dim=1)
            h, state, _ = tfm.run_decoder(blocks, h, cfg, sdist, mode="prefill",
                                          window=cfg.window, hot_ids=hot_ids, gathers=gathers)
            if cache_len > state.max_len:
                pad = (0, 0, 0, 0, 0, cache_len - state.max_len)  # the T dim of [L, B, T, KH, Dh]
                state = state._replace(k=torch.nn.functional.pad(state.k, pad),
                                       v=torch.nn.functional.pad(state.v, pad))
            if tfm.seq_split(cfg, dist):  # the cache's layout: the sequence over model
                if state.max_len % dist.model_size:
                    raise ValueError(f"cache_len {state.max_len} does not split over the model "
                                     f"axis ({dist.model_size}), as the kv heads do not")
                spec = (None, None, dist.model_axis, None, None)
                state = state._replace(k=constrain(state.k, dist, *spec).contiguous(),
                                       v=constrain(state.v, dist, *spec).contiguous())
        elif cfg.family == "ssm":
            h, state = rwkv6.rwkv_forward(blocks, h, cfg, sdist)
        elif cfg.family == "hybrid":
            h, state = rglru.rglru_forward(blocks, h, cfg, sdist, collect_cache=True)
        else:
            memory = encdec.encode(blocks, batch["frames"].to(h.dtype), cfg, sdist)
            h, (sk, sv), (ck, cv) = encdec.decode_prefill(blocks, h, memory, cfg, sdist)
            if cache_len > s:
                pad = (0, 0, 0, 0, 0, cache_len - s)
                sk, sv = torch.nn.functional.pad(sk, pad), torch.nn.functional.pad(sv, pad)
            state = encdec.EncDecState(self_k=sk, self_v=sv, cross_k=ck, cross_v=cv,
                                       length=torch.full((b,), s, dtype=torch.int32, device=h.device))
        h_last = apply_norm(params["ln_f"], h[:, -1:], cfg.norm)[:, 0]
        logits = unembed_logits(h_last, self._head_table(params), dist, cfg.vocab_size)
        return logits, state

    def decode_step(self, params: dict, state, tokens: torch.Tensor, dist=None,
                    hot_ids: torch.Tensor | None = None):
        """serve_step: one new token per sequence (``tokens [B]``, the most
        recent token of each) against the decode state, whose caches are
        written in place. Returns ``(logits [B, V] f32, state)``."""
        cfg = self.cfg
        # The top-level tables dequantize once a step; the blocks stay int8
        # and dequantize a layer at a time (run_decode_step).
        params = {key: (val if key == "blocks" else dequant_leaf(val)) for key, val in params.items()}
        if cfg.family not in DECODER_FAMILIES:
            _check_not_quantized(params["blocks"], f"the {cfg.family!r} family's decode step")
        h = embed_lookup(params["embed"], tokens[:, None], dist)[:, 0].to(torch.bfloat16)
        blocks, sdist, gathers = self._stack(params, dist)
        if cfg.family in DECODER_FAMILIES:
            if cfg.pos == "sinusoidal":
                h = h + encdec.sinusoid_at(state.length, cfg.d_model).to(h.dtype)
            h, state, _ = tfm.run_decode_step(blocks, h, state, cfg, sdist, window=cfg.window,
                                              hot_ids=hot_ids, gathers=gathers)
        elif cfg.family == "ssm":
            h, state = rwkv6.rwkv_decode_step(blocks, h, cfg, state, sdist)
        elif cfg.family == "hybrid":
            h, state = rglru.rglru_decode_step(blocks, h, cfg, state, sdist)
        else:
            h = h + encdec.sinusoid_at(state.length, cfg.d_model).to(h.dtype)
            h, state = encdec.encdec_decode_step(blocks, h, state, cfg, sdist)
        h = apply_norm(params["ln_f"], h[:, None, :], cfg.norm)[:, 0]
        return unembed_logits(h, self._head_table(params), dist, cfg.vocab_size), state

    # ------------------------------------------------------------- shapes
    def input_specs(self, shape: ShapeConfig) -> dict:
        """One batch of the cell ``shape`` as tensors on the ``meta`` device
        (shapes and dtypes only), by the reference's rules: a decode cell
        gives ``tokens [B]``; vlm ``tokens [B, max(S - P, 1)]`` and bf16
        ``patches [B, P, D]``; audio ``tokens [B, S]`` and bf16 ``frames
        [B, F, D]``; the others ``tokens [B, S]``; a train cell adds
        ``targets`` shaped as ``tokens``."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def tok(*sh):
            return torch.empty(sh, dtype=torch.int32, device="meta")

        def emb(*sh):
            return torch.empty(sh, dtype=torch.bfloat16, device="meta")

        if shape.kind == "decode":
            return {"tokens": tok(b)}
        if cfg.family == "vlm":
            out = {"tokens": tok(b, max(s - cfg.num_patches, 1)),
                   "patches": emb(b, cfg.num_patches, cfg.d_model)}
        elif cfg.family == "audio":
            out = {"tokens": tok(b, s), "frames": emb(b, cfg.num_frames, cfg.d_model)}
        else:
            out = {"tokens": tok(b, s)}
        if shape.kind == "train":
            out["targets"] = tok(*out["tokens"].shape)
        return out

    def make_batch(self, shape: ShapeConfig, key: tuple[int, int]) -> dict:
        """A synthetic batch matching ``input_specs`` on the model's device,
        drawn as the reference draws it from the same key (a
        ``kvsim.prng.prng_key``): one ``split`` a field in the specs' order,
        int32 fields by ``randint(0, vocab_size)`` (the reference's values
        bit for bit), bf16 fields by ``normal`` in f32, then cast (``normal``
        is within a few f32 ulps of the reference's, so the cast leaves a
        few values one bf16 ulp apart)."""
        out = {}
        for name, spec in self.input_specs(shape).items():
            key, sub = prng.split(key)
            pos = torch.arange(spec.numel(), device=self.device)
            if spec.dtype == torch.int32:
                vals = prng.randint(sub, pos, 0, self.cfg.vocab_size)
            else:
                vals = prng.normal(sub, pos).to(spec.dtype)
            out[name] = vals.reshape(spec.shape)
        return out


def build(cfg, device=None) -> Model:
    return Model(cfg, device)
