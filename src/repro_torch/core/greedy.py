"""Standard token-by-token greedy decoding (the paper's Table 2 baseline),
the DL=0, N_d=1 case of the shared greedy-family session step."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.handles import DecoderHandle
from repro_torch.core.session import SessionSpec, init_state, run_session


class GreedyResult(NamedTuple):
    tokens: torch.Tensor    # (B, max_new) generated tokens (pad after EOS)
    lengths: torch.Tensor   # (B,) generated token counts (incl. EOS)
    n_calls: int            # decoder forward passes


def greedy_decode(handle: DecoderHandle, cache: Any, last_token: torch.Tensor,
                  start_pos: torch.Tensor, *, max_new: int, eos_id: int,
                  pad_id: int = 0) -> GreedyResult:
    """last_token: (B,) last committed (unprocessed) token; start_pos: (B,)
    its absolute position. One model call per generated token."""
    B = last_token.shape[0]
    spec = SessionSpec(n_slots=B, n_beams=1, n_drafts=1, draft_len=0,
                       max_new=max_new, eos_id=eos_id, pad_id=pad_id,
                       kind="greedy")
    dev = last_token.device
    state = init_state(spec, cache)._replace(
        last=last_token.to(torch.int32)[:, None],
        pos=start_pos.to(torch.int32)[:, None],
        finished=torch.zeros((B, 1), dtype=torch.bool, device=dev),
        active=torch.ones((B,), dtype=torch.bool, device=dev),
        draft_mask=torch.ones((B, 1), dtype=torch.bool, device=dev),
    )
    state, i = run_session(spec, handle, state)
    return GreedyResult(tokens=state.tokens[:, 0], lengths=state.n_out[:, 0],
                        n_calls=i)
