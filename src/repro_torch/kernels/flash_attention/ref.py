"""Plain PyTorch versions of full-sequence (flash) attention, forward and
backward, in the model's ``(B, S, H, hd)`` layout, with grouped K/V heads.

``flash_attention_ref`` is the port of
``repro.kernels.flash_attention.ref.flash_attention_ref`` and of the JAX
model's ``_masked_attend`` / ``_gqa_attend`` (``repro.models.attention``):
q is (B, S, H, hd), k and v (B, S, Kv, hd) with ``H % Kv == 0``, query head
``h`` reading kv head ``h // (H // Kv)`` (the JAX package's ``(Kv,
q_per_kv)`` split of the heads). It takes a per-row key mask (``key_mask``
(B, S), True = valid key: the encoder's ``src != pad`` and the decoder's
``lengths``) and optional positions ``q_pos`` / ``k_pos`` (B, S) int32, and
returns the per-row log-sum-exp that the backward needs.
``flash_attention_bwd_ref`` is the explicit backward, which the JAX
package lacks (JAX differentiates its einsum): recompute ``P = exp(s·scale
− lse)`` from the saved ``lse``, then ``dV = Pᵀ·dO``, ``D = rowsum(dO∘O)``,
``dS = P∘(dP − D)`` with ``dP = dO·Vᵀ``, ``dQ = scale·dS·K`` and ``dK =
scale·dSᵀ·Q``; dK and dV of a kv head sum over its group's query heads.
On the CPU both are what the model runs; on the card
``csrc/flash_attention{,_bwd}.cu`` compute the same.

Masking, as the JAX model masks: keys where ``key_mask`` is False are
invisible; ``causal`` hides keys whose position is past the query's, and
``window > 0`` (only with ``causal``) hides keys at or before ``query −
window``. Positions default to the indices (``arange(S)``), which is the
TPU kernel's contract. An invisible key gets exactly 0 weight. A query row
with no visible key outputs 0 and receives zero gradient, with ``lse =
-inf`` (the TPU kernel gives such a row the mean of V over its padded tile
and the JAX einsum the mean of V; ``repro_torch.models.attention`` gives
the JAX value where it matters, on MoE patterns).
"""

from __future__ import annotations

import math

import torch


def visible_mask(S: int, *, causal: bool, window: int = 0, key_mask=None,
                 q_pos=None, k_pos=None, device=None) -> torch.Tensor:
    """(B or 1, 1, S, S) bool: may query ``q`` (axis 2) see key ``k``
    (axis 3)? Positions (B, S) default to the indices."""
    if q_pos is None and k_pos is None:
        qp = torch.arange(S, device=device)[None, :, None]
        kp = torch.arange(S, device=device)[None, None, :]
    else:
        ar = torch.arange(S, device=device)[None]
        qp = (ar if q_pos is None else q_pos)[:, :, None]
        kp = (ar if k_pos is None else k_pos)[:, None, :]
    vis = torch.ones((1, S, S), dtype=torch.bool, device=device)
    if causal:
        vis = kp <= qp
        if window > 0:
            vis = vis & (kp > qp - window)
    vis = vis[:, None]
    if key_mask is not None:
        vis = vis & key_mask.to(torch.bool)[:, None, None, :]
    return vis


def _heads(k, H: int):
    """(B, S, Kv, hd) -> (B, S, H, hd): each kv head repeated for its
    ``H // Kv`` query heads (query head h reads kv head h // (H // Kv))."""
    G = H // k.shape[2]
    return k if G == 1 else k.repeat_interleave(G, dim=2)


def flash_attention_ref(q, k, v, *, causal: bool, window: int = 0,
                        key_mask=None, q_pos=None, k_pos=None):
    """q: (B, S, H, hd); k, v: (B, S, Kv, hd); key_mask: (B, S) bool or
    None; q_pos, k_pos: (B, S) int positions or None (the indices).

    Returns (out (B, S, H, hd) in q's dtype, lse (B, H, S) float32). Scores
    and sums in fp32 (fp64, lse too, for fp64 inputs: the exact answer a
    check can hold a kernel and the fp32 version to)."""
    H, hd = q.shape[2], q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc),
                     _heads(k, H).to(acc)) * scale
    vis = visible_mask(q.shape[1], causal=causal, window=window,
                       key_mask=key_mask, q_pos=q_pos, k_pos=k_pos,
                       device=q.device)
    s = s.masked_fill(~vis, -math.inf)
    # the max is a constant shift of each row: its gradient cancels exactly
    m = s.amax(-1, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)                     # invisible keys -> exactly 0
    l = p.sum(-1, keepdim=True)
    w = p / torch.where(l > 0, l, torch.ones_like(l))
    out = torch.einsum("bhqk,bkhd->bqhd", w, _heads(v, H).to(acc))
    lse = (m + torch.log(l)).squeeze(-1)     # -inf on a row with no key
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool,
                            window: int = 0, key_mask=None, q_pos=None,
                            k_pos=None):
    """Gradients of ``flash_attention_ref``'s output: q, o, do (B, S, H,
    hd); k, v (B, S, Kv, hd); lse (B, H, S) as the forward returned it.
    Returns (dq, dk, dv) in q's dtype, computed in fp32 (fp64 for fp64
    inputs); dk and dv (B, S, Kv, hd) sum over each kv head's query
    heads."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, of, dof = (t.to(acc) for t in (q, _heads(k, H), _heads(v, H),
                                               o, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    vis = visible_mask(S, causal=causal, window=window, key_mask=key_mask,
                       q_pos=q_pos, k_pos=k_pos, device=q.device)
    p = torch.where(vis, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    D = (dof * of).sum(-1).transpose(1, 2)               # (B, H, S)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - D[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    if Kv != H:
        dk = dk.reshape(B, S, Kv, H // Kv, hd).sum(3)
        dv = dv.reshape(B, S, Kv, H // Kv, hd).sum(3)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)
