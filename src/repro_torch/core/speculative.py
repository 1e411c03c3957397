"""Speculative greedy decoding with source-copy drafts (paper §2.1, Fig. 2).

Every iteration verifies all N_d drafts of every sequence in ONE decoder
pass over the draft-expanded batch (B*N_d rows), accepts the longest
argmax-matching prefix of the best draft plus one bonus token, and commits.
The generated sequence is IDENTICAL to token-by-token greedy decoding.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.handles import DecoderHandle
from repro_torch.core.session import SessionSpec, init_state, run_session
from repro_torch.core.tree_batch import expand_batch


class SpeculativeResult(NamedTuple):
    tokens: torch.Tensor           # (B, max_new)
    lengths: torch.Tensor          # (B,)
    n_calls: int                   # decoder forward passes
    accepted_tokens: torch.Tensor  # (B,) total draft tokens accepted
    acceptance_rate: torch.Tensor  # (B,) accepted / generated


def speculative_greedy_decode(
    handle: DecoderHandle, cache: Any, last_token: torch.Tensor,
    start_pos: torch.Tensor, drafts: torch.Tensor, draft_mask: torch.Tensor,
    *, max_new: int, eos_id: int, pad_id: int = 0,
) -> SpeculativeResult:
    """drafts: (B, N_d, DL) int32 source-copy drafts; draft_mask: (B, N_d).
    The cache must cover start_pos + max_new + DL + 1."""
    B, N_d, DL = drafts.shape
    spec = SessionSpec(n_slots=B, n_beams=1, n_drafts=N_d, draft_len=DL,
                       max_new=max_new, eos_id=eos_id, pad_id=pad_id,
                       kind="greedy")
    dev = last_token.device
    state = init_state(spec, expand_batch(cache, N_d))._replace(
        last=last_token.to(torch.int32)[:, None],
        pos=start_pos.to(torch.int32)[:, None],
        finished=torch.zeros((B, 1), dtype=torch.bool, device=dev),
        active=torch.ones((B,), dtype=torch.bool, device=dev),
        drafts=drafts.to(torch.int32),
        draft_mask=draft_mask.to(torch.bool),
    )
    state, i = run_session(spec, handle, state)
    n_out = state.n_out[:, 0]
    rate = state.accepted / n_out.clamp(min=1)
    return SpeculativeResult(tokens=state.tokens[:, 0], lengths=n_out,
                             n_calls=i, accepted_tokens=state.accepted,
                             acceptance_rate=rate)
