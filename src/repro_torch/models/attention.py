"""Grouped-query attention with a position-tagged KV cache, dense or paged:
the port of ``repro.models.attention`` (the Molecular Transformer's and the
decoder-only transformer's: RoPE, qk-norm, sliding window, cross-attention
to a frontend memory of ``memory_dim``).

Dense cache (as in the JAX package): ``(B, S, n_kv, head_dim)`` K/V buffers
plus a ``(B, S)`` int32 ``pos`` array holding the absolute position stored in
each slot (-1 = empty). Writes go to ``slot = position % S``; masking is on
stored positions, so a ring buffer (sliding window, ``S = window``) and a
linear cache are one code path.

Paged cache (``PagedKVCache``): a page pool shared by all batch rows plus
per-row block tables, so batch-row ops (winner sync, beam reorder, slot
recycling) touch only the tables.

Unlike the JAX package, the port writes either cache IN PLACE (no copy of
the buffers per step); ``cached_attention`` returns the same cache object.
Each cache type has one read path: the ``decode_gqa`` kernel for the dense
cache, the ``paged_decode_gqa`` kernel for the paged one (their plain
versions on the CPU). Full-sequence self-attention (the MT's encoder, the
teacher-forced decoders of training, the decoder-only ``apply`` with its
GQA heads and positions) has one path too: the ``flash_attention``
kernels, forward and backward. Cross-attention and the single-pass
multi-draft verification read (``multidraft_attention``) stay einsums, as
in the JAX package, which has no kernel for them.

On a residual stream split along T (sequence sharding) every mode runs
on the gathered sequence, so the keys, the cache writes and the kernels'
shapes are those of the whole stream; ``wo``'s sum is a reduce-scatter
along T, a whole ``wo``'s output cut to the rank's positions
(``layers.dense_row``).

Masks use -1e30, not -inf, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_gqa.ops import (decode_gqa_attention,
                                               paged_decode_gqa_attention)
from repro_torch.kernels.flash_attention.ops import flash_attention_bshd
from repro_torch.kernels.flash_attention.ref import visible_mask
from repro_torch.models.layers import (apply_norm, apply_rope, dense,
                                       dense_init, dense_row)
from repro_torch.sharding import ctx

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# params


def attn_init(gen, cfg: ModelConfig, *, device, cross: bool = False) -> dict:
    """Attention projections. ``cross=True`` reads K/V from ``memory_dim``
    (the model width when it is 0) with one kv head per query head."""
    d, hd = cfg.d_model, cfg.head_dim
    kv_src = cfg.memory_dim if (cross and cfg.memory_dim) else d
    n_kv = cfg.n_heads if cross else cfg.n_kv_heads  # cross-attn: MHA
    kw = dict(use_bias=cfg.use_bias, device=device)
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, **kw),
        "wk": dense_init(gen, kv_src, n_kv * hd, **kw),
        "wv": dense_init(gen, kv_src, n_kv * hd, **kw),
        "wo": dense_init(gen, cfg.n_heads * hd, d, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones((hd,), device=device)}
        p["k_norm"] = {"scale": torch.ones((hd,), device=device)}
    return p


# ---------------------------------------------------------------------------
# cache


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor    # (..., B, S, n_kv, head_dim)
    v: torch.Tensor    # (..., B, S, n_kv, head_dim)
    pos: torch.Tensor  # (..., B, S) int32, absolute position in slot, -1 empty


def _cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Slots a row keeps: the window when there is one (a ring buffer)."""
    w = cfg.sliding_window
    return max_len if w == 0 else min(max_len, w)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
                  dtype=torch.float32) -> KVCache:
    size = _cache_len(cfg, max_len)
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, size), -1, dtype=torch.int32, device=device),
    )


def _write_cache(cache: KVCache, k_new, v_new, positions) -> KVCache:
    """Scatter new K/V at ``slot = position % S`` in place; positions (B, T).
    torch's ``%`` takes the divisor's sign, so position -1 lands in slot
    S-1 exactly as in the JAX package (``fmod`` would not)."""
    B, S = cache.pos.shape
    b_idx = torch.arange(B, device=positions.device)[:, None]
    slots = (positions % S).long()
    cache.k[b_idx, slots] = k_new.to(cache.k.dtype)
    cache.v[b_idx, slots] = v_new.to(cache.v.dtype)
    cache.pos[b_idx, slots] = positions.to(torch.int32)
    return cache


# ---------------------------------------------------------------------------
# paged cache

TRASH_PAGE = 0  # reserved: writes with no mapped target land here, pos = -1


@dataclasses.dataclass
class PagedKVCache:
    """Block-table KV cache: a global page pool shared by all batch rows.

    ``block_tables[b, j]`` maps logical block ``j`` of row ``b`` to a page in
    the pool (-1 = unmapped). Logical position ``p`` of row ``b`` lives at
    ``(page=block_tables[b, (p // ps) % n_blocks], slot=p % ps)``. The pool
    (and stored positions) carry no batch axis, so batch-row ops touch ONLY
    the block tables; page contents are shared by aliasing. The host or
    device page planner keeps the invariant that pages overlapping a row's
    write window ``[pos, pos+DL]`` are privately owned (copy-on-write at the
    draft boundary; ``repro_torch.core.session``). Attention masks on STORED
    positions, so which page backs a block never changes the output.
    """

    k_pool: torch.Tensor        # (..., P, ps, n_kv, head_dim)
    v_pool: torch.Tensor        # (..., P, ps, n_kv, head_dim)
    pos: torch.Tensor           # (..., P, ps) int32, position stored, -1 empty
    block_tables: torch.Tensor  # (..., B, n_blocks) int32 page id, -1 unmapped

    @property
    def page_size(self) -> int:
        return self.k_pool.shape[-3]

    @property
    def n_blocks(self) -> int:
        return self.block_tables.shape[-1]


def init_paged_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                        n_pages: int, page_size: int, device,
                        dtype=torch.float32) -> PagedKVCache:
    """Empty pool + unmapped tables. ``n_blocks`` covers the same logical
    length the dense cache would reserve per row (a ring over blocks when a
    sliding window applies); page 0 is the reserved trash page."""
    if n_pages < 2:
        raise ValueError("n_pages must be >= 2 (page 0 is the trash page)")
    n_blocks = -(-_cache_len(cfg, max_len) // page_size)
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return PagedKVCache(
        k_pool=torch.zeros(shape, dtype=dtype, device=device),
        v_pool=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((n_pages, page_size), -1, dtype=torch.int32,
                       device=device),
        block_tables=torch.full((batch, n_blocks), -1, dtype=torch.int32,
                                device=device),
    )


def _lookup_pages(cache: PagedKVCache, positions):
    """positions (B, T) -> (page (B, T), slot (B, T), mapped (B, T))."""
    ps, nb = cache.page_size, cache.n_blocks
    blocks = torch.div(positions, ps, rounding_mode="floor") % nb
    page = cache.block_tables.gather(1, blocks.long())
    mapped = (page >= 0) & (positions >= 0)
    return (torch.where(mapped, page, TRASH_PAGE), positions % ps, mapped)


def _write_cache_paged(cache: PagedKVCache, k_new, v_new, positions
                       ) -> PagedKVCache:
    """Scatter new K/V through the block table in place; positions (B, T).
    Invalid targets (position -1 or an unmapped block) go to the trash page
    with stored position -1: unreadable, like the dense pad convention."""
    page, slot, mapped = _lookup_pages(cache, positions)
    page, slot = page.long(), slot.long()
    cache.k_pool[page, slot] = k_new.to(cache.k_pool.dtype)
    cache.v_pool[page, slot] = v_new.to(cache.v_pool.dtype)
    cache.pos[page, slot] = torch.where(mapped, positions, -1).to(torch.int32)
    return cache


def paged_view(cache: PagedKVCache):
    """Materialize the dense per-row view (k, v, kpos): (B, n_blocks*ps,
    n_kv, hd) x2 + (B, n_blocks*ps) positions; unmapped blocks read the
    trash page, masked to position -1. The port reads through the
    ``paged_decode_gqa`` kernel instead; this gather is its plain version's
    first half and the library yardstick's."""
    B, nb = cache.block_tables.shape
    ps = cache.page_size
    mapped = cache.block_tables >= 0
    pages = torch.where(mapped, cache.block_tables, TRASH_PAGE).long()
    k = cache.k_pool[pages].reshape(B, nb * ps, *cache.k_pool.shape[2:])
    v = cache.v_pool[pages].reshape(B, nb * ps, *cache.v_pool.shape[2:])
    kpos = torch.where(mapped[..., None], cache.pos[pages], -1)
    return k, v, kpos.reshape(B, nb * ps)


# ---------------------------------------------------------------------------
# core score/combine


def _gqa_attend(q, k, v, mask, *, q_per_kv: int):
    """q: (B,T,Hq,hd); k,v: (B,S,Kv,hd); mask: broadcastable (B,1,1,T,S)."""
    B, T, Hq, hd = q.shape
    Kv = k.shape[2]
    q = q.reshape(B, T, Kv, q_per_kv, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", q, k).float() / math.sqrt(hd)
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", w.to(v.dtype), v)
    return out.reshape(B, T, Hq, hd)


def _own_kv_heads(cfg: ModelConfig, n_q: int, k, v, *, cross: bool):
    """``k`` / ``v`` (B, S, heads, hd) cut to the kv heads a mesh rank's
    ``n_q`` query heads read, where ``wk`` / ``wv`` stay whole beside a
    split ``wq``; as they are otherwise."""
    tp = ctx.current()
    n_kv = cfg.n_heads if cross else cfg.n_kv_heads
    if tp is not None and n_q < cfg.n_heads and k.shape[2] == n_kv:
        lo, hi = ctx.kv_heads_for(tp.rank, n_q, cfg.n_heads, n_kv)
        k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    return k, v


def _project_qkv(p: dict, cfg: ModelConfig, x, kv_input, *, cross: bool):
    """q, k, v with the heads the weights hold: every head, or this rank's
    under a tensor-parallel mesh (a whole ``wk`` / ``wv`` beside a split
    ``wq`` is cut to the kv heads the rank's query heads read)."""
    B, T = x.shape[:2]
    hd = cfg.head_dim
    wk, wv = p["wk"], p["wv"]
    qn, kn = p.get("q_norm"), p.get("k_norm")
    if p["wq"]["w"].shape[1] < cfg.n_heads * hd:
        # the rank's heads: its inputs, a whole wk / wv cut to its kv heads
        # and the qk norms get only its part of their gradients
        same = kv_input is x
        x = ctx.enter(x)
        kv_input = x if same else ctx.enter(kv_input)
        if wk["w"].shape[1] == (cfg.n_heads if cross else
                                cfg.n_kv_heads) * hd:
            wk, wv = ctx.enter_tree(wk), ctx.enter_tree(wv)
        if cfg.qk_norm:
            qn, kn = ctx.enter_tree(qn), ctx.enter_tree(kn)
    q = dense(p["wq"], x).reshape(B, T, -1, hd)
    k = dense(wk, kv_input).reshape(B, kv_input.shape[1], -1, hd)
    v = dense(wv, kv_input).reshape(B, kv_input.shape[1], -1, hd)
    k, v = _own_kv_heads(cfg, q.shape[2], k, v, cross=cross)
    if cfg.qk_norm:
        q = apply_norm(qn, q, "rmsnorm")
        k = apply_norm(kn, k, "rmsnorm")
    return q, k, v


# ---------------------------------------------------------------------------
# modes


def attention(p: dict, cfg: ModelConfig, x, *, positions=None,
              causal: bool = True, padding_mask=None,
              rope=None) -> torch.Tensor:
    """Full-sequence self-attention (no cache): the MT's encoder and
    teacher-forced decoder, and the decoder-only ``transformer.apply``.
    Runs ``flash_attention_bshd`` (the kernels on the card, their plain
    versions on the CPU) over the GQA heads, differentiable.

    x: (B, T, d); positions: (B, T) absolute, or None for ``arange(T)``
    (the kernels then mask by index and skip the key tiles a causal row
    cannot see); padding_mask: (B, T) True = valid key. With ``cfg.pos ==
    "rope"`` q and k are rotated at the positions (``rope``: their
    ``rope_tables``, when the caller made them for every layer).
    ``cfg.sliding_window`` applies when ``causal``.

    A query row that sees no key (a row of length 0 under
    ``padding_mask``) gets 0 from the kernels; the JAX model's einsum gives
    it the mean of V over the row's keys. On a pattern with MoE FFNs that
    row's hidden state takes expert capacity, so there it gets the JAX
    model's mean of V, as ``cached_attention`` does.
    """
    B, T = x.shape[:2]
    q, k, v = _project_qkv(p, cfg, x, x, cross=False)
    if positions is not None:
        positions = positions.to(torch.int32).contiguous()
    if cfg.pos == "rope":
        rp = (positions if positions is not None else
              torch.arange(T, dtype=torch.int32, device=x.device)[None])
        q = apply_rope(q, rp, cfg.rope_theta, tables=rope)
        k = apply_rope(k, rp, cfg.rope_theta, tables=rope)
    window = cfg.sliding_window
    out = flash_attention_bshd(q, k, v, causal=causal, window=window,
                               key_mask=padding_mask, positions=positions)
    if "moe" in cfg.ffn_pattern and (padding_mask is not None
                                     or positions is not None):
        blind = ~visible_mask(T, causal=causal, window=window,
                              key_mask=padding_mask, q_pos=positions,
                              k_pos=positions, device=x.device).any(-1)[:, 0]
        mean_v = v.float().mean(1).repeat_interleave(
            q.shape[2] // v.shape[2], dim=1)
        out = torch.where(blind[:, :, None, None],
                          mean_v[:, None].to(out.dtype), out)
    return dense_row(p["wo"], out.reshape(B, T, -1))


def cross_attention(p: dict, cfg: ModelConfig, x, memory, *,
                    memory_mask=None) -> torch.Tensor:
    """x: (B, T, d) queries; memory: (B, M, memory_dim or d);
    memory_mask: (B, M) True = valid."""
    B, T = x.shape[:2]
    q, k, v = _project_qkv(p, cfg, x, memory, cross=True)
    mask = torch.ones((B, T, memory.shape[1]), dtype=torch.bool,
                      device=x.device)
    if memory_mask is not None:
        mask = mask & memory_mask[:, None, :]
    out = _gqa_attend(q, k, v, mask[:, None, None], q_per_kv=1)
    return dense_row(p["wo"], out.reshape(B, T, -1))


def memory_kv(p: dict, cfg: ModelConfig, memory) -> dict:
    """Precompute cross-attention K/V from the encoder's or the frontend's
    memory (prefill time): every head, or on a mesh rank the heads of its
    share of ``wq`` (``cached_cross_attention`` reads them with those
    query heads and reduces ``wo``)."""
    B, M = memory.shape[:2]
    hd = cfg.head_dim
    k = dense(p["wk"], memory).reshape(B, M, -1, hd)
    v = dense(p["wv"], memory).reshape(B, M, -1, hd)
    k, v = _own_kv_heads(cfg, p["wq"]["w"].shape[1] // hd, k, v, cross=True)
    if cfg.qk_norm:
        k = apply_norm(p["k_norm"], k, "rmsnorm")
    return {"mk": k, "mv": v}


def cached_cross_attention(p: dict, cfg: ModelConfig, x, cache: dict, *,
                           memory_mask=None) -> torch.Tensor:
    """Cross-attention against precomputed memory K/V (decode time)."""
    B, T = x.shape[:2]
    q = dense(p["wq"], x).reshape(B, T, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, "rmsnorm")
    mask = torch.ones((B, T, cache["mk"].shape[1]), dtype=torch.bool,
                      device=x.device)
    if memory_mask is not None:
        mask = mask & memory_mask[:, None, :]
    out = _gqa_attend(q, cache["mk"], cache["mv"], mask[:, None, None],
                      q_per_kv=1)
    return dense_row(p["wo"], out.reshape(B, T, -1))


def cached_attention(p: dict, cfg: ModelConfig, x, cache, positions, *,
                     rope=None) -> tuple[torch.Tensor, object]:
    """Cached causal decode over a dense ``KVCache`` or a ``PagedKVCache``.

    x: (B, T, d) new tokens; positions: (B, T) absolute positions of those
    tokens (rows may differ — the speculative decoder relies on this).
    ``positions == -1`` marks invalid tokens: their K/V land in a throwaway
    slot (dense: slot S-1; paged: the trash page) with stored position -1,
    which every query masks. With ``cfg.pos == "rope"`` q and the new k are
    rotated at their positions before the write (``rope``: the positions'
    ``rope_tables``, when the caller made them for every layer);
    ``cfg.sliding_window`` masks keys older than the window. Returns (B, T,
    d) and the cache, updated in place.

    Fully masked query rows: the read goes through the ``decode_gqa`` /
    ``paged_decode_gqa`` kernel (its plain version on the CPU), which
    returns 0 for a query with no visible key, as the JAX package's own
    kernel oracles do. The JAX model's einsum read returns the uniform mean
    of V over the row's view there instead (its softmax over all-masked
    scores). A query sees no key exactly when its position is -1 (its own
    key is written before it is read). Such a row's output reaches no
    committed state through attention or a recurrent mixer, whose rows are
    independent; but an MoE FFN sizes its expert buffers from the call's
    whole token count, so pad and idle rows take capacity, and which
    choices they take depends on their hidden state. So for a pattern
    with MoE FFNs those rows get the JAX model's mean of V, and the port
    drops what the JAX package drops.
    """
    B, T = x.shape[:2]
    q, k_new, v_new = _project_qkv(p, cfg, x, x, cross=False)
    positions = positions.to(torch.int32).contiguous()
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, tables=rope)
        k_new = apply_rope(k_new, positions, cfg.rope_theta, tables=rope)
    window = cfg.sliding_window
    if isinstance(cache, PagedKVCache):
        cache = _write_cache_paged(cache, k_new, v_new, positions)
        out = paged_decode_gqa_attention(q.contiguous(), cache.k_pool,
                                         cache.v_pool, cache.pos,
                                         cache.block_tables.contiguous(),
                                         positions, window=window)
    else:
        # a strided row view (a chunked prefill's slot-leading rows) reads
        # its stored positions through a compact copy
        cache = _write_cache(cache, k_new, v_new, positions)
        out = decode_gqa_attention(q.contiguous(), cache.k, cache.v,
                                   cache.pos.contiguous(), positions,
                                   window=window)
    if "moe" in cfg.ffn_pattern:
        # per kv head the cache holds (a mesh rank's own), over its group
        mean_v = _row_mean_v(cache)
        out = torch.where((positions < 0)[:, :, None, None],
                          mean_v.repeat_interleave(
                              out.shape[2] // mean_v.shape[1],
                              dim=1)[:, None].to(out.dtype), out)
    return dense_row(p["wo"], out.reshape(B, T, -1)), cache


def _row_mean_v(cache) -> torch.Tensor:
    """(B, n_kv, hd): the mean of V over each row's view (every slot of a
    dense row; every block's page of a paged row, the trash page for an
    unmapped block), as ``paged_view`` lays it out."""
    if isinstance(cache, KVCache):
        return cache.v.float().mean(1)
    B, nb = cache.block_tables.shape
    pages = torch.where(cache.block_tables >= 0, cache.block_tables,
                        TRASH_PAGE).long()
    page_sum = cache.v_pool.float().sum(1)                    # (P, n_kv, hd)
    return page_sum[pages].sum(1) / (nb * cache.page_size)


def multidraft_attention(p: dict, cfg: ModelConfig, x, cache: KVCache,
                         positions, local_mask, *, rope=None):
    """Single-pass multi-draft verification attention over a dense cache.

    One row per sequence feeds every draft: x is (B, T, d) with T = 1 +
    N_d·DL (the last committed token, then the drafts back to back), and
    ``local_mask`` (T, T) is the segment mask (token (j, i) sees token 0
    and its own draft's prefix). The fed tokens attend with ONE softmax
    over two parts: the committed cache, read once per sequence instead of
    once per draft row, and the local K/V of their own segment. The two
    parts share one max and one denominator and are never concatenated
    (the JAX package's formulation, as plain torch: it has no kernel
    there either). Nothing is written to the cache; ``commit_verified_kv``
    writes the winning draft's accepted K/V afterwards.

    Returns (out (B, T, d), (k_new, v_new)), the local K/V for the commit.
    """
    if isinstance(cache, PagedKVCache):
        raise TypeError("multidraft_attention reads a dense KVCache (its "
                        "k / v / pos buffers); a PagedKVCache is not "
                        "supported")
    B, T = x.shape[:2]
    q, k_new, v_new = _project_qkv(p, cfg, x, x, cross=False)
    positions = positions.to(torch.int32)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, tables=rope)
        k_new = apply_rope(k_new, positions, cfg.rope_theta, tables=rope)
    # the cache holds committed tokens only, all before the fed positions
    kp = cache.pos[:, None, :]
    qp = positions[:, :, None]
    cache_mask = (kp >= 0) & (kp <= qp)
    if cfg.sliding_window > 0:
        cache_mask &= kp > qp - cfg.sliding_window
    Kv, hd = cache.k.shape[2], cfg.head_dim
    G = q.shape[2] // Kv
    qh = q.reshape(B, T, Kv, G, hd)
    scale = 1.0 / math.sqrt(hd)
    s_c = torch.einsum("btkgh,bskh->bkgts", qh, cache.k).float() * scale
    s_l = torch.einsum("btkgh,bskh->bkgts", qh, k_new).float() * scale
    s_c = s_c.masked_fill(~cache_mask[:, None, None], _NEG_INF)
    s_l = s_l.masked_fill(~local_mask[None, None, None], _NEG_INF)
    m = torch.maximum(s_c.amax(-1, keepdim=True), s_l.amax(-1, keepdim=True))
    p_c = torch.exp(s_c - m)
    p_l = torch.exp(s_l - m)
    denom = p_c.sum(-1, keepdim=True) + p_l.sum(-1, keepdim=True)
    p_c = (p_c / denom).to(cache.v.dtype)
    p_l = (p_l / denom).to(v_new.dtype)
    out = (torch.einsum("bkgts,bskh->btkgh", p_c, cache.v)
           + torch.einsum("bkgts,bskh->btkgh", p_l, v_new)).reshape(B, T, -1)
    return dense_row(p["wo"], out), (k_new, v_new)


def commit_verified_kv(cache: KVCache, k_new, v_new, take_idx, positions,
                       n_keep) -> KVCache:
    """Write the winning draft's accepted K/V into a dense cache, in place.

    take_idx: (B, W) local indices of [last token, winning draft tokens];
    positions: (B, W) their absolute positions; n_keep: (B,) how many of
    the W are committed. The rest are written with stored position -1
    (invalid: the next commit rewrites their slots before any query can
    see them). Slots are ``position % S``, the dense cache's convention."""
    B, W = take_idx.shape
    b = torch.arange(B, device=take_idx.device)[:, None]
    idx = take_idx.long()
    valid = (torch.arange(W, device=take_idx.device)[None, :]
             < n_keep.to(take_idx.device)[:, None])
    S = cache.k.shape[1]
    positions = positions.to(torch.int32)
    slots = (positions % S).long()
    cache.k[b, slots] = k_new[b, idx].to(cache.k.dtype)
    cache.v[b, slots] = v_new[b, idx].to(cache.v.dtype)
    cache.pos[b, slots] = torch.where(valid, positions, -1).to(torch.int32)
    return cache
