"""Plain PyTorch versions of full-sequence (flash) attention, forward and
backward, in the model's ``(B, S, H, hd)`` layout.

``flash_attention_ref`` is the port of
``repro.kernels.flash_attention.ref.flash_attention_ref``, extended with a
per-row key mask (``key_mask`` (B, S), True = valid key: the encoder's
``src != pad`` and the decoder's ``lengths``) and returning the per-row
log-sum-exp that the backward needs. ``flash_attention_bwd_ref`` is the
explicit backward, which the JAX package lacks (JAX differentiates its
einsum): recompute ``P = exp(s·scale − lse)`` from the saved ``lse``, then
``dV = Pᵀ·dO``, ``D = rowsum(dO∘O)``, ``dS = P∘(dO·Vᵀ − D)``,
``dQ = scale·dS·K`` and ``dK = scale·dSᵀ·Q``. On the CPU both are what the
model runs; on the card ``csrc/flash_attention.cu`` computes the same.

Masking: keys where ``key_mask`` is False are invisible; ``causal`` hides
keys after the query, and ``window > 0`` (only with ``causal``, as in the
TPU kernel) hides keys at or before ``query - window``. An invisible key
gets exactly 0 weight. A query row with no visible key outputs 0 and
receives zero gradient, with ``lse = -inf`` (the TPU kernel gives such a
row the mean of V over its padded tile and the JAX einsum the mean of V;
neither path of the port feeds one: every source row holds its EOS and
every causal row sees key 0).
"""

from __future__ import annotations

import math

import torch


def visible_mask(S: int, *, causal: bool, window: int = 0, key_mask=None,
                 device=None) -> torch.Tensor:
    """(B or 1, 1, S, S) bool: may query ``q`` (axis 2) see key ``k``
    (axis 3)?"""
    qi = torch.arange(S, device=device)[:, None]
    ki = torch.arange(S, device=device)[None, :]
    vis = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        vis = ki <= qi
        if window > 0:
            vis = vis & (ki > qi - window)
    vis = vis[None, None]
    if key_mask is not None:
        vis = vis & key_mask.to(torch.bool)[:, None, None, :]
    return vis


def flash_attention_ref(q, k, v, *, causal: bool, window: int = 0,
                        key_mask=None):
    """q, k, v: (B, S, H, hd); key_mask: (B, S) bool or None.

    Returns (out (B, S, H, hd) in q's dtype, lse (B, H, S) float32). Scores
    and sums in fp32."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    vis = visible_mask(q.shape[1], causal=causal, window=window,
                       key_mask=key_mask, device=q.device)
    s = s.masked_fill(~vis, -math.inf)
    # the max is a constant shift of each row: its gradient cancels exactly
    m = s.amax(-1, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)                     # invisible keys -> exactly 0
    l = p.sum(-1, keepdim=True)
    w = p / torch.where(l > 0, l, torch.ones_like(l))
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    lse = (m + torch.log(l)).squeeze(-1)     # -inf on a row with no key
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool,
                            window: int = 0, key_mask=None):
    """Gradients of ``flash_attention_ref``'s output: q, k, v, o, do
    (B, S, H, hd); lse (B, H, S) as the forward returned it. Returns
    (dq, dk, dv) in q's dtype, computed in fp32."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    vis = visible_mask(q.shape[1], causal=causal, window=window,
                       key_mask=key_mask, device=q.device)
    p = torch.where(vis, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    D = (dof * of).sum(-1).transpose(1, 2)               # (B, H, S)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - D[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)
