"""Decoder-only transformer, the port of ``repro.models.transformer`` for
the dense ``("attn",)`` pattern: GQA with RoPE, optional qk-norm and
sliding window, RMSNorm or LayerNorm, SwiGLU or GELU FFN, tied or separate
output head (SmolLM, Qwen3, StarCoder2, Command-R).

Params follow the JAX package's tree with its stacked repeat axis split
into Python lists: ``params["blocks"]`` is a tuple with one entry per
pattern position, each a list of per-layer dicts, so the JAX
``lax.scan`` over repeats becomes a loop (``repro_torch.bridge`` carries a
JAX tree across). The cache is a tuple with one entry per pattern
position, a ``KVCache`` or ``PagedKVCache`` whose leaves are stacked on a
leading repeat axis with batch on axis 1, as the seq2seq cache's are, so
``repro_torch.core.tree_batch``, the page plan and ``unmap_cache_rows``
serve both.

Serving needs no full-sequence attention: ``prefill`` writes the prompt
into the cache through ``cached_attention``, as the JAX package's does.
``multidraft_verify_step`` / ``commit_multidraft`` verify every draft in
one row per sequence over a dense cache (``repro_torch.core.multidraft``).
The full-sequence ``apply`` (training) and the other layer patterns (MoE,
Mamba, RWKV, cross-attention) are refused by name (ROADMAP.md Queue 1
item 6).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import (KVCache, PagedKVCache,
                                          cached_attention)
from repro_torch.models.layers import (apply_norm, embed, embed_init, ffn,
                                       ffn_init, logits_init, norm_init,
                                       rope_tables, unembed)

_ITEM = {"moe": "6.3", "mamba": "6.4", "rwkv": "6.4", "xattn": "6.4"}


def check_serves(cfg: ModelConfig) -> None:
    """Refuse, by name, a pattern the port does not serve yet."""
    if cfg.family in ("seq2seq", "audio"):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a "
                         f"decoder-only language model")
    for kind, ffn_kind in zip(cfg.layer_pattern, cfg.ffn_pattern):
        for k in (kind, ffn_kind):
            if k not in ("attn", "dense"):
                raise NotImplementedError(
                    f"{cfg.name}: layer kind {k!r} is not ported yet "
                    f"(ROADMAP.md Queue 1 item {_ITEM.get(k, '6')})")


# ---------------------------------------------------------------------------
# init


def init(gen: torch.Generator, cfg: ModelConfig, *, device=None) -> dict:
    """Random params drawn from ``gen`` (a CPU generator, so the same seed
    gives the same weights on every device), placed on ``device``: the JAX
    init's distributions, not its numbers."""
    check_serves(cfg)
    dev = resolve_device(device)
    d, kind = cfg.d_model, cfg.norm

    def block():
        return {"norm1": norm_init(d, kind, dev),
                "attn": attn_mod.attn_init(gen, cfg, device=dev),
                "norm2": norm_init(d, kind, dev),
                "ffn": ffn_init(gen, d, cfg.d_ff, use_bias=cfg.use_bias,
                                gated=cfg.gated_ffn, device=dev)}

    params = {"tok": embed_init(gen, cfg.vocab_size, d, dev),
              "blocks": tuple([block() for _ in range(cfg.n_repeats)]
                              for _ in cfg.layer_pattern),
              "final_norm": norm_init(d, kind, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = logits_init(gen, d, cfg.vocab_size, dev)
    return params


# ---------------------------------------------------------------------------
# caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, paged=None, device=None) -> tuple:
    """One cache per pattern position, stacked over repeats (leading axis).

    ``paged``: ``(n_pages, page_size)`` allocates each position's cache as a
    ``PagedKVCache`` (one pool per layer, every layer's block table
    identical, one page-id space) whose pages the caller maps."""
    check_serves(cfg)
    dev = resolve_device(device)
    R = cfg.n_repeats

    def stack(a):
        return a.expand(R, *a.shape).contiguous()

    caches = []
    for _ in cfg.layer_pattern:
        if paged is not None:
            n_pages, page_size = paged
            one = attn_mod.init_paged_kv_cache(
                cfg, batch, max_len, n_pages=n_pages, page_size=page_size,
                device=dev, dtype=dtype)
            caches.append(PagedKVCache(
                k_pool=stack(one.k_pool), v_pool=stack(one.v_pool),
                pos=stack(one.pos), block_tables=stack(one.block_tables)))
        else:
            one = attn_mod.init_kv_cache(cfg, batch, max_len, device=dev,
                                         dtype=dtype)
            caches.append(KVCache(k=stack(one.k), v=stack(one.v),
                                  pos=stack(one.pos)))
    return tuple(caches)


def commit_cache(cfg: ModelConfig, cache: tuple, n_keep) -> tuple:
    """Attention caches need no rollback: stale slots (rejected drafts) are
    overwritten before any query can see them."""
    return cache


def _layer(c, r: int):
    """Repeat ``r`` of a stacked cache (views, written in place)."""
    if isinstance(c, PagedKVCache):
        return PagedKVCache(c.k_pool[r], c.v_pool[r], c.pos[r],
                            c.block_tables[r])
    return KVCache(c.k[r], c.v[r], c.pos[r])


# ---------------------------------------------------------------------------
# stack


def _run_stack(params, cfg: ModelConfig, x, cache, positions):
    """Every layer in order (repeat-major, as the JAX scan runs them), each
    writing its K/V into the cache in place. The rotary tables of the
    positions are made once for all layers."""
    positions = positions.to(torch.int32).contiguous()
    rope = (rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.pos == "rope" else None)
    for r in range(cfg.n_repeats):
        for i in range(len(cfg.layer_pattern)):
            p = params["blocks"][i][r]
            a, _ = cached_attention(p["attn"], cfg,
                                    apply_norm(p["norm1"], x, cfg.norm),
                                    _layer(cache[i], r), positions,
                                    rope=rope)
            x = x + a
            x = x + ffn(p["ffn"], apply_norm(p["norm2"], x, cfg.norm))
    return x


def _logits_out(params, cfg: ModelConfig, x):
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if cfg.tie_embeddings:
        return unembed(params["tok"], x)
    return x @ params["lm_head"]["w_vocab"]


# ---------------------------------------------------------------------------
# public API


def apply(params, cfg: ModelConfig, tokens, **kw):
    raise NotImplementedError(
        "transformer.apply (the full-sequence forward of LM training) is "
        "not ported yet (ROADMAP.md Queue 1 item 6.5)")


def prefill(params, cfg: ModelConfig, cache, tokens, *, lengths=None,
            logits_mode: str = "all"):
    """Write the prompt into the cache. Returns (logits, cache).

    tokens: (B, T); ``lengths`` (B,) valid tokens per row (default T):
    positions past a row's length are -1, so their K/V land in the
    throwaway slot. ``logits_mode="last"`` gives (B, V) at each row's last
    valid position instead of (B, T, V)."""
    if logits_mode not in ("all", "last"):
        raise ValueError(f"logits_mode {logits_mode!r}")
    B, T = tokens.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32,
                             device=tokens.device)
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=tokens.device)
    pos = torch.arange(T, dtype=torch.int32, device=tokens.device)[None, :]
    positions = torch.where(pos < lengths[:, None], pos, -1)
    x = _run_stack(params, cfg, embed(params["tok"], tokens), cache,
                   positions)
    if logits_mode == "last":
        last = (lengths - 1).clamp(0, T - 1).long()
        x = x[torch.arange(B, device=x.device), last]
    return _logits_out(params, cfg, x), cache


def decode_step(params, cfg: ModelConfig, cache, tokens, positions, *,
                memory_mask=None):
    """Feed T new tokens per row (T = 1 for greedy, DL+1 to verify) at
    ``positions`` (B, T) (rows may differ; -1 = a pad token). Returns
    (logits (B, T, V), cache) with the cache written in place."""
    if memory_mask is not None:
        raise NotImplementedError("memory_mask: cross-attention layers are "
                                  "not ported yet (ROADMAP.md Queue 1 item "
                                  "6.4)")
    x = _run_stack(params, cfg, embed(params["tok"], tokens), cache,
                   positions)
    return _logits_out(params, cfg, x), cache


def write_prompt(params, cfg: ModelConfig, cache, tokens, positions):
    """``decode_step`` without the output head: write the K/V of
    ``tokens`` at ``positions`` into the cache (a chunked prefill, whose
    logits nobody reads). Returns the cache, written in place."""
    _run_stack(params, cfg, embed(params["tok"], tokens), cache, positions)
    return cache


def multidraft_verify_step(params, cfg: ModelConfig, cache, tokens,
                           positions, local_mask):
    """Single-pass verification of ALL drafts (``attention.
    multidraft_attention``) over a dense cache. tokens: (B, 1 + N_d·DL) =
    [last committed, draft 0 ..., draft N_d-1 ...]; positions: their
    absolute positions; local_mask: the (T, T) segment mask.

    Returns (logits (B, T, V), local_kv): local_kv holds, per pattern
    position, the fed tokens' (k, v) stacked over repeats, for
    ``commit_multidraft``. The cache is not modified."""
    check_serves(cfg)
    positions = positions.to(torch.int32).contiguous()
    rope = (rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.pos == "rope" else None)
    x = embed(params["tok"], tokens)
    kvs = [([], []) for _ in cfg.layer_pattern]
    for r in range(cfg.n_repeats):
        for i in range(len(cfg.layer_pattern)):
            p = params["blocks"][i][r]
            a, (k, v) = attn_mod.multidraft_attention(
                p["attn"], cfg, apply_norm(p["norm1"], x, cfg.norm),
                _layer(cache[i], r), positions, local_mask, rope=rope)
            x = x + a
            x = x + ffn(p["ffn"], apply_norm(p["norm2"], x, cfg.norm))
            kvs[i][0].append(k)
            kvs[i][1].append(v)
    local_kv = tuple((torch.stack(k), torch.stack(v)) for k, v in kvs)
    return _logits_out(params, cfg, x), local_kv


def commit_multidraft(cfg: ModelConfig, cache, local_kv, best, n_acc,
                      start_pos, *, draft_len: int):
    """Write the winning draft's accepted K/V into the cache, in place.

    best: (B,) winning draft index; n_acc: (B,) accepted draft tokens;
    start_pos: (B,) position of the fed last committed token. Commits the
    last token and the ``n_acc`` accepted draft tokens (``n_keep = 1 +
    n_acc``), as the expanded-batch path keeps them."""
    B, DL = best.shape[0], draft_len
    dev = best.device
    rel = torch.arange(DL + 1, dtype=torch.int32, device=dev)
    # local indices: 0 (the last token), then the winner's segment
    take_idx = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                          1 + best.to(torch.int32)[:, None] * DL
                          + rel[None, :-1]], dim=1)
    positions = start_pos.to(torch.int32)[:, None] + rel[None, :]
    n_keep = 1 + n_acc
    for c, (k, v) in zip(cache, local_kv):
        for r in range(cfg.n_repeats):
            attn_mod.commit_verified_kv(_layer(c, r), k[r], v[r], take_idx,
                                        positions, n_keep)
    return cache
