"""Speculative beam search (SBS) — the paper's Algorithm 1 / Appendix B.

Per iteration every beam × every draft is one row of a single decoder pass;
per beam the draft with the most accepted tokens wins; candidates of unequal
lengths beam ++ draft[:a] ++ w compete for the global top-n by cumulative
log-probability. With DL=0 (one empty draft) each iteration is exactly one
standard beam-search step (the paper's "SBS, DL=0" control).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.beam import _beam_state, _sorted_beams
from repro_torch.core.handles import DecoderHandle
from repro_torch.core.session import SessionSpec, _cache_device, run_session
from repro_torch.core.tree_batch import expand_batch


class SBSResult(NamedTuple):
    tokens: torch.Tensor           # (n, max_new)
    lengths: torch.Tensor          # (n,)
    logprobs: torch.Tensor         # (n,)
    n_calls: int
    accepted_tokens: torch.Tensor  # () committed draft tokens (best beam path)


class BatchedSBSResult(NamedTuple):
    tokens: torch.Tensor           # (B, n, max_new)
    lengths: torch.Tensor          # (B, n)
    logprobs: torch.Tensor         # (B, n)
    n_calls: int
    accepted_tokens: torch.Tensor  # (B,)


def batched_speculative_beam_search(
    handle: DecoderHandle, cache: Any, bos_token: int,
    start_pos: torch.Tensor, drafts: torch.Tensor, draft_mask: torch.Tensor,
    *, n_beams: int, max_new: int, eos_id: int, pad_id: int = 0,
) -> BatchedSBSResult:
    """B independent queries. drafts: (B, N_d, DL); cache: B-row prefix
    cache (expanded to B * n_beams * N_d rows); start_pos: (B,)."""
    B, N_d, DL = drafts.shape
    spec = SessionSpec(n_slots=B, n_beams=n_beams, n_drafts=N_d,
                       draft_len=DL, max_new=max_new, eos_id=eos_id,
                       pad_id=pad_id, kind="beam")
    state = _beam_state(spec, expand_batch(cache, n_beams * N_d), bos_token,
                        start_pos)
    state = state._replace(drafts=drafts.to(torch.int32),
                           draft_mask=draft_mask.to(torch.bool))
    state, i = run_session(spec, handle, state)
    tokens, lengths, logp = _sorted_beams(state)
    return BatchedSBSResult(tokens=tokens, lengths=lengths, logprobs=logp,
                            n_calls=i, accepted_tokens=state.accepted)


def speculative_beam_search(
    handle: DecoderHandle, cache: Any, bos_token: int, start_pos: int,
    drafts: torch.Tensor, draft_mask: torch.Tensor, *, n_beams: int,
    max_new: int, eos_id: int, pad_id: int = 0,
) -> SBSResult:
    """drafts: (N_d, DL) source-copy drafts for THIS query (B=1, the paper's
    serving regime); cache: single-row prefix cache."""
    res = batched_speculative_beam_search(
        handle, cache, bos_token,
        torch.full((1,), start_pos, dtype=torch.int32,
                   device=_cache_device(cache)),
        drafts[None], draft_mask[None], n_beams=n_beams, max_new=max_new,
        eos_id=eos_id, pad_id=pad_id)
    return SBSResult(tokens=res.tokens[0], lengths=res.lengths[0],
                     logprobs=res.logprobs[0], n_calls=res.n_calls,
                     accepted_tokens=res.accepted_tokens[0])
