"""Attention of the Molecular Transformer with a dense, position-tagged KV
cache: the dense half of ``repro.models.attention``.

Cache design (as in the JAX package): ``(B, S, n_kv, head_dim)`` K/V buffers
plus a ``(B, S)`` int32 ``pos`` array holding the absolute position stored in
each slot (-1 = empty). Writes go to ``slot = position % S``; masking is on
stored positions, so a ring buffer and a linear cache are one code path.
Unlike the JAX package, the port writes the cache IN PLACE (no copy of the
buffers per step); ``cached_attention`` returns the same cache object.

Masks use -1e30, not -inf, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_gqa.ops import decode_gqa_attention
from repro_torch.models.layers import dense, dense_init

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# params


def attn_init(gen, cfg: ModelConfig, *, device, cross: bool = False) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    n_kv = cfg.n_heads if cross else cfg.n_kv_heads  # cross-attn: MHA
    kw = dict(use_bias=cfg.use_bias, device=device)
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, **kw),
        "wk": dense_init(gen, d, n_kv * hd, **kw),
        "wv": dense_init(gen, d, n_kv * hd, **kw),
        "wo": dense_init(gen, cfg.n_heads * hd, d, **kw),
    }


# ---------------------------------------------------------------------------
# cache


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor    # (..., B, S, n_kv, head_dim)
    v: torch.Tensor    # (..., B, S, n_kv, head_dim)
    pos: torch.Tensor  # (..., B, S) int32, absolute position in slot, -1 empty


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
                  dtype=torch.float32) -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, max_len), -1, dtype=torch.int32,
                       device=device),
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


def _project_qkv(p: dict, cfg: ModelConfig, x, kv_input, *, cross: bool):
    B, T = x.shape[:2]
    hd = cfg.head_dim
    n_kv = cfg.n_heads if cross else cfg.n_kv_heads
    q = dense(p["wq"], x).reshape(B, T, cfg.n_heads, hd)
    k = dense(p["wk"], kv_input).reshape(B, kv_input.shape[1], n_kv, hd)
    v = dense(p["wv"], kv_input).reshape(B, kv_input.shape[1], n_kv, hd)
    return q, k, v


# ---------------------------------------------------------------------------
# modes


def attention(p: dict, cfg: ModelConfig, x, *, positions=None,
              causal: bool = True, padding_mask=None) -> torch.Tensor:
    """Full-sequence self-attention (no cache).

    x: (B, T, d); positions: (B, T) absolute; padding_mask: (B, T) True=valid.
    """
    B, T = x.shape[:2]
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=x.device).expand(B, T)
    q, k, v = _project_qkv(p, cfg, x, x, cross=False)
    mask = (torch.ones((B, 1, T), dtype=torch.bool, device=x.device)
            if padding_mask is None else padding_mask[:, None, :])
    if causal:
        mask = mask & (positions[:, None, :] <= positions[:, :, None])
    out = _gqa_attend(q, k, v, mask[:, None, None], q_per_kv=cfg.q_per_kv)
    return dense(p["wo"], out.reshape(B, T, -1))


def cross_attention(p: dict, cfg: ModelConfig, x, memory, *,
                    memory_mask=None) -> torch.Tensor:
    """x: (B, T, d) queries; memory: (B, M, d)."""
    B, T = x.shape[:2]
    q, k, v = _project_qkv(p, cfg, x, memory, cross=True)
    mask = torch.ones((B, T, memory.shape[1]), dtype=torch.bool,
                      device=x.device)
    if memory_mask is not None:
        mask = mask & memory_mask[:, None, :]
    out = _gqa_attend(q, k, v, mask[:, None, None], q_per_kv=1)
    return dense(p["wo"], out.reshape(B, T, -1))


def memory_kv(p: dict, cfg: ModelConfig, memory) -> dict:
    """Precompute cross-attention K/V from the encoder memory."""
    B, M = memory.shape[:2]
    hd = cfg.head_dim
    k = dense(p["wk"], memory).reshape(B, M, cfg.n_heads, hd)
    v = dense(p["wv"], memory).reshape(B, M, cfg.n_heads, hd)
    return {"mk": k, "mv": v}


def cached_cross_attention(p: dict, cfg: ModelConfig, x, cache: dict, *,
                           memory_mask=None) -> torch.Tensor:
    """Cross-attention against precomputed memory K/V (decode time)."""
    B, T = x.shape[:2]
    q = dense(p["wq"], x).reshape(B, T, cfg.n_heads, cfg.head_dim)
    mask = torch.ones((B, T, cache["mk"].shape[1]), dtype=torch.bool,
                      device=x.device)
    if memory_mask is not None:
        mask = mask & memory_mask[:, None, :]
    out = _gqa_attend(q, cache["mk"], cache["mv"], mask[:, None, None],
                      q_per_kv=1)
    return dense(p["wo"], out.reshape(B, T, -1))


def cached_attention(p: dict, cfg: ModelConfig, x, cache: KVCache, positions
                     ) -> tuple[torch.Tensor, KVCache]:
    """Cached causal decode over a dense cache.

    x: (B, T, d) new tokens; positions: (B, T) absolute positions of those
    tokens (rows may differ — the speculative decoder relies on this).
    ``positions == -1`` marks invalid tokens: their K/V land in slot S-1 with
    stored position -1, which every query masks. Returns (B, T, d) and the
    cache, updated in place.
    """
    B, T = x.shape[:2]
    q, k_new, v_new = _project_qkv(p, cfg, x, x, cross=False)
    positions = positions.to(torch.int32).contiguous()
    cache = _write_cache(cache, k_new, v_new, positions)
    # The read goes through the decode_gqa kernel (its plain version on the
    # CPU). It returns 0 for a query row with no visible key, where the JAX
    # package's einsum returns a uniform mean; the one-shot serving path
    # never feeds such a row (every slot is active, positions are >= 0 and a
    # token's own key is written before it is read), so on that path the two
    # are the same function.
    out = decode_gqa_attention(q.contiguous(), cache.k, cache.v, cache.pos,
                               positions)
    return dense(p["wo"], out.reshape(B, T, -1)), cache
