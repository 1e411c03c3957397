"""Plain PyTorch version of the dense GQA decode attention, a port of
``repro.kernels.decode_gqa.ref.decode_gqa_ref``.

Slot validity comes from the stored-position array (-1 = empty), causality
from ``q_pos >= k_pos``, and the optional sliding window from
``k_pos > q_pos - window``. A query row with no visible key outputs 0.
"""

from __future__ import annotations

import math

import torch


def decode_gqa_ref(q, k_cache, v_cache, k_pos, q_pos, *, window: int = 0):
    """q: (B, T, H, hd); k/v_cache: (B, S, Kv, hd); k_pos: (B, S);
    q_pos: (B, T). Returns (B, T, H, hd) in q's dtype."""
    B, T, H, hd = q.shape
    Kv = k_cache.shape[2]
    G = H // Kv
    qr = q.reshape(B, T, Kv, G, hd).float()
    s = torch.einsum("btkgh,bskh->bkgts", qr, k_cache.float()) / math.sqrt(hd)
    kp = k_pos[:, None, None, None, :]
    qp = q_pos[:, None, None, :, None]
    mask = (kp >= 0) & (kp <= qp)
    if window > 0:
        mask &= kp > qp - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    w = torch.where(mask.any(-1, keepdim=True), w, torch.zeros_like(w))
    out = torch.einsum("bkgts,bskh->btkgh", w, v_cache.float())
    return out.reshape(B, T, H, hd).to(q.dtype)


def paged_decode_gqa_ref(q, k_pool, v_pool, pos_pool, block_tables, q_pos, *,
                         window: int = 0):
    """Plain paged version, a port of
    ``repro.kernels.decode_gqa.ref.paged_decode_gqa_ref``: gather each row's
    mapped pages into the dense view (unmapped blocks read the trash page 0
    and are masked to position -1), then run ``decode_gqa_ref``.

    q: (B, T, H, hd); k/v_pool: (P, ps, Kv, hd); pos_pool: (P, ps);
    block_tables: (B, n_blocks) page ids, -1 unmapped. Returns (B, T, H, hd).
    """
    B, nb = block_tables.shape
    ps = k_pool.shape[1]
    mapped = block_tables >= 0
    pages = torch.where(mapped, block_tables, 0).long()
    k = k_pool[pages].reshape(B, nb * ps, *k_pool.shape[2:])
    v = v_pool[pages].reshape(B, nb * ps, *v_pool.shape[2:])
    kpos = torch.where(mapped[..., None], pos_pool[pages], -1)
    return decode_gqa_ref(q, k, v, kpos.reshape(B, nb * ps), q_pos,
                          window=window)
