"""Encoder-decoder transformer — the Molecular Transformer (Schwaller 2019),
the port of ``repro.models.seq2seq`` (dense and paged decoder caches).

Pre-LN residual blocks with GELU, as in the JAX package. Params are the JAX
package's tree with the stacked layer axis split into Python lists
(``enc_blocks`` / ``dec_blocks``), so ``lax.scan`` over layers becomes a
loop. ``repro_torch.bridge`` carries a JAX param tree across.

The decoder cache is ``{"self": KVCache | PagedKVCache, "cross": {"mk",
"mv"}}`` (plus ``"mmask"`` when the memory mask rides in the cache) with
every leaf stacked on a leading layer axis, batch on axis 1 (the JAX layout
that ``repro_torch.core.tree_batch`` maps over).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import (KVCache, PagedKVCache, attention,
                                          cached_attention, cross_attention)
from repro_torch.models.layers import (apply_norm, embed, embed_init, ffn,
                                       ffn_init, logits_init, norm_init,
                                       sinusoidal_positions, vocab_logits)

# ---------------------------------------------------------------------------
# init


def init(gen: torch.Generator, cfg: ModelConfig, *, device=None) -> dict:
    """Random params drawn from ``gen`` (a CPU generator, so the same seed
    gives the same weights on every device), placed on ``device``;
    ``device="meta"`` draws nothing (``gen`` may be None): shapes only."""
    assert cfg.family == "seq2seq" and cfg.n_encoder_layers > 0
    dev = resolve_device(device)
    d, kind = cfg.d_model, cfg.norm
    ffn_kw = dict(use_bias=cfg.use_bias, gated=cfg.gated_ffn, device=dev)

    def enc_block():
        return {"norm1": norm_init(d, kind, dev),
                "attn": attn_mod.attn_init(gen, cfg, device=dev),
                "norm2": norm_init(d, kind, dev),
                "ffn": ffn_init(gen, d, cfg.d_ff, **ffn_kw)}

    def dec_block():
        return {"norm1": norm_init(d, kind, dev),
                "self_attn": attn_mod.attn_init(gen, cfg, device=dev),
                "norm_x": norm_init(d, kind, dev),
                "cross_attn": attn_mod.attn_init(gen, cfg, cross=True,
                                                 device=dev),
                "norm2": norm_init(d, kind, dev),
                "ffn": ffn_init(gen, d, cfg.d_ff, **ffn_kw)}

    return {
        "tok": embed_init(gen, cfg.vocab_size, d, dev),   # shared enc/dec
        "enc_blocks": [enc_block() for _ in range(cfg.n_encoder_layers)],
        "enc_norm": norm_init(d, kind, dev),
        "dec_blocks": [dec_block() for _ in range(cfg.n_layers)],
        "dec_norm": norm_init(d, kind, dev),
        "lm_head": logits_init(gen, d, cfg.vocab_size, dev),
    }


def _embed_pos(params, cfg: ModelConfig, tokens, positions):
    x = embed(params["tok"], tokens) * math.sqrt(cfg.d_model)
    pe = sinusoidal_positions(cfg.max_len, cfg.d_model, device=x.device,
                              dtype=x.dtype)
    return x + pe[positions.clamp(min=0).long()]


# ---------------------------------------------------------------------------
# encoder


def encode(params, cfg: ModelConfig, src, *, src_mask=None):
    """src: (B, S) token ids; src_mask: (B, S) True=valid (default: != pad 0).

    Returns (memory (B, S, d), src_mask)."""
    if src_mask is None:
        src_mask = src != 0
    B, S = src.shape
    positions = torch.arange(S, dtype=torch.int32, device=src.device).expand(
        B, S)
    x = _embed_pos(params, cfg, src, positions)
    for p in params["enc_blocks"]:
        x = x + attention(p["attn"], cfg, apply_norm(p["norm1"], x, cfg.norm),
                          causal=False, padding_mask=src_mask)
        x = x + ffn(p["ffn"], apply_norm(p["norm2"], x, cfg.norm))
    return apply_norm(params["enc_norm"], x, cfg.norm), src_mask


# ---------------------------------------------------------------------------
# decoder (full sequence, teacher forced)


def decode(params, cfg: ModelConfig, tgt_in, memory, src_mask, *,
           lengths=None):
    """Teacher-forced decoder pass. tgt_in: (B, T). Returns logits (B, T, V)."""
    B, T = tgt_in.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=tgt_in.device).expand(B, T)
    x = _embed_pos(params, cfg, tgt_in, positions)
    pad_mask = (None if lengths is None else
                torch.arange(T, device=tgt_in.device) < lengths[:, None])
    for p in params["dec_blocks"]:
        x = x + attention(p["self_attn"], cfg,
                          apply_norm(p["norm1"], x, cfg.norm),
                          causal=True, padding_mask=pad_mask)
        x = x + cross_attention(p["cross_attn"], cfg,
                                apply_norm(p["norm_x"], x, cfg.norm), memory,
                                memory_mask=src_mask)
        x = x + ffn(p["ffn"], apply_norm(p["norm2"], x, cfg.norm))
    x = apply_norm(params["dec_norm"], x, cfg.norm)
    return vocab_logits(params["lm_head"], x)


def apply(params, cfg: ModelConfig, src, tgt_in, *, src_mask=None,
          lengths=None):
    """Full forward: returns (logits, aux={})."""
    memory, src_mask = encode(params, cfg, src, src_mask=src_mask)
    return decode(params, cfg, tgt_in, memory, src_mask, lengths=lengths), {}


# ---------------------------------------------------------------------------
# cached decode (serving)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, memory=None,
               params=None, dtype=torch.float32, memory_len=None,
               memory_mask=None, paged=None, device=None) -> dict:
    """Self-attn KV caches + precomputed cross K/V (if memory given), every
    leaf stacked on a leading layer axis.

    ``memory_len``: cross K/V width when ``memory`` is absent (the
    streaming engine allocates empty rows up front and scatters each
    request's memory K/V in at admission). ``memory_mask``: (batch, M)
    True=valid; when given it is stored INSIDE the cache (leaf (1, batch,
    M), batch on axis 1 like every other leaf), so batch-row ops carry each
    row's mask along and ``decode_step`` needs no closed-over mask.
    ``paged``: ``(n_pages, page_size)`` allocates the self-attn cache as a
    ``PagedKVCache`` (one pool per decoder layer, every layer's block table
    identical) whose pages the caller maps; the cross K/V stays dense."""
    R = cfg.n_layers
    dev = memory.device if memory is not None else resolve_device(device)

    def stack(a):
        return a.expand(R, *a.shape).contiguous()

    if paged is not None:
        n_pages, page_size = paged
        one = attn_mod.init_paged_kv_cache(
            cfg, batch, max_len, n_pages=n_pages, page_size=page_size,
            device=dev, dtype=dtype)
        self_cache = PagedKVCache(
            k_pool=stack(one.k_pool), v_pool=stack(one.v_pool),
            pos=stack(one.pos), block_tables=stack(one.block_tables))
    else:
        one = attn_mod.init_kv_cache(cfg, batch, max_len, device=dev,
                                     dtype=dtype)
        self_cache = KVCache(k=stack(one.k), v=stack(one.v),
                             pos=stack(one.pos))
    if memory is not None and params is not None:
        mkv = [attn_mod.memory_kv(p["cross_attn"], cfg, memory)
               for p in params["dec_blocks"]]
        cross = {"mk": torch.stack([m["mk"] for m in mkv]),
                 "mv": torch.stack([m["mv"] for m in mkv])}
    else:
        M = (memory_len if memory_len is not None
             else (1 if memory is None else memory.shape[1]))
        shape = (R, batch, M, cfg.n_heads, cfg.head_dim)
        cross = {"mk": torch.zeros(shape, dtype=dtype, device=dev),
                 "mv": torch.zeros(shape, dtype=dtype, device=dev)}
    cache = {"self": self_cache, "cross": cross}
    if memory_mask is not None:
        cache["mmask"] = torch.as_tensor(memory_mask, dtype=torch.bool,
                                         device=dev)[None]
    return cache


def _layer(c_self, i: int):
    """Layer ``i`` of the stacked self-attention cache (views, written in
    place by ``cached_attention``)."""
    if isinstance(c_self, PagedKVCache):
        return PagedKVCache(c_self.k_pool[i], c_self.v_pool[i],
                            c_self.pos[i], c_self.block_tables[i])
    return KVCache(c_self.k[i], c_self.v[i], c_self.pos[i])


def decode_step(params, cfg: ModelConfig, cache, tokens, positions, *,
                memory_mask=None):
    """Feed T new tokens (T = DL+1 for verification). Returns (logits, cache);
    the self-attention cache is updated in place.

    ``positions``: (B, T) absolute target positions (rows may differ). When
    no explicit ``memory_mask`` is passed the per-row mask stored in the
    cache (if any) applies."""
    if memory_mask is None and "mmask" in cache:
        memory_mask = cache["mmask"][0]
    x = _embed_pos(params, cfg, tokens, positions)
    c_self = cache["self"]
    for i, p in enumerate(params["dec_blocks"]):
        a, _ = cached_attention(p["self_attn"], cfg,
                                apply_norm(p["norm1"], x, cfg.norm),
                                _layer(c_self, i), positions)
        x = x + a
        cross = {"mk": cache["cross"]["mk"][i], "mv": cache["cross"]["mv"][i]}
        x = x + attn_mod.cached_cross_attention(
            p["cross_attn"], cfg, apply_norm(p["norm_x"], x, cfg.norm), cross,
            memory_mask=memory_mask)
        x = x + ffn(p["ffn"], apply_norm(p["norm2"], x, cfg.norm))
    x = apply_norm(params["dec_norm"], x, cfg.norm)
    return vocab_logits(params["lm_head"], x), cache


def commit_cache(cfg: ModelConfig, cache, n_keep):
    """KV caches need no rollback: stale slots are overwritten before any
    query can see them."""
    return cache
