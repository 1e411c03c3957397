"""Plain PyTorch version of the fused verify op, a port of
``repro.kernels.draft_verify.ref.draft_verify_ref``: vocab argmax (first
index wins ties) + accepted-prefix lengths."""

from __future__ import annotations

import torch


def draft_verify_ref(logits, drafts, draft_mask):
    """logits: (N, T, V); drafts: (N, T-1); draft_mask: (N,) bool.

    Returns (greedy_tokens (N, T) int32, n_acc (N,) int32)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if drafts.shape[-1] == 0:
        n_acc = torch.zeros((logits.shape[0],), dtype=torch.int32,
                            device=logits.device)
    else:
        match = (drafts == greedy[:, :-1]).to(torch.int32)
        n_acc = torch.cumprod(match, dim=-1).sum(-1).to(torch.int32)
    return greedy, torch.where(draft_mask, n_acc, torch.zeros_like(n_acc))
