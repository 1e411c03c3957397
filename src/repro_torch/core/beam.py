"""Standard beam search — the paper's Table 3/4 baseline: n beams, EOS as
an absorbing state, no length penalty. The DL=0 case of the shared
beam-family session step."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.handles import DecoderHandle
from repro_torch.core.session import (SessionSpec, _cache_device, init_state,
                                      run_session)
from repro_torch.core.tree_batch import expand_batch

_NEG = -1e30


class BeamResult(NamedTuple):
    tokens: torch.Tensor    # (n, max_new)
    lengths: torch.Tensor   # (n,)
    logprobs: torch.Tensor  # (n,)
    n_calls: int


class BatchedBeamResult(NamedTuple):
    tokens: torch.Tensor    # (B, n, max_new) — per query, best first
    lengths: torch.Tensor   # (B, n)
    logprobs: torch.Tensor  # (B, n)
    n_calls: int


def _beam_state(spec: SessionSpec, cache, bos_token, start_pos):
    B, K = spec.n_slots, spec.n_beams
    dev = start_pos.device
    logp0 = torch.full((K,), _NEG, device=dev)
    logp0[0] = 0.0
    return init_state(spec, cache)._replace(
        logp=logp0.expand(B, K).clone(),
        last=torch.full((B, K), bos_token, dtype=torch.int32, device=dev),
        pos=start_pos.to(torch.int32)[:, None].expand(B, K).clone(),
        finished=torch.zeros((B, K), dtype=torch.bool, device=dev),
        active=torch.ones((B,), dtype=torch.bool, device=dev),
        draft_mask=torch.ones((B, spec.n_drafts), dtype=torch.bool,
                              device=dev),
    )


def _sorted_beams(state):
    order = torch.argsort(-state.logp, dim=1, stable=True)      # (B, K)
    tokens = state.tokens.gather(
        1, order[..., None].expand(*order.shape, state.tokens.shape[-1]))
    return (tokens, state.n_out.gather(1, order), state.logp.gather(1, order))


def batched_beam_search(handle: DecoderHandle, cache: Any, bos_token: int,
                        start_pos: torch.Tensor, *, n_beams: int,
                        max_new: int, eos_id: int,
                        pad_id: int = 0) -> BatchedBeamResult:
    """B independent queries, n beams each. ``cache``: B-row cache, expanded
    to B*n rows internally. ``start_pos``: (B,)."""
    B = start_pos.shape[0]
    spec = SessionSpec(n_slots=B, n_beams=n_beams, n_drafts=1, draft_len=0,
                       max_new=max_new, eos_id=eos_id, pad_id=pad_id,
                       kind="beam")
    state = _beam_state(spec, expand_batch(cache, n_beams), bos_token,
                        start_pos)
    state, i = run_session(spec, handle, state)
    tokens, lengths, logp = _sorted_beams(state)
    return BatchedBeamResult(tokens=tokens, lengths=lengths, logprobs=logp,
                             n_calls=i)


def beam_search(handle: DecoderHandle, cache: Any, bos_token: int,
                start_pos: int, *, n_beams: int, max_new: int, eos_id: int,
                pad_id: int = 0) -> BeamResult:
    """``cache`` is a single-row (B=1) cache, expanded to n_beams rows."""
    res = batched_beam_search(
        handle, cache, bos_token,
        torch.full((1,), start_pos, dtype=torch.int32,
                   device=_cache_device(cache)),
        n_beams=n_beams, max_new=max_new, eos_id=eos_id, pad_id=pad_id)
    return BeamResult(tokens=res.tokens[0], lengths=res.lengths[0],
                      logprobs=res.logprobs[0], n_calls=res.n_calls)
