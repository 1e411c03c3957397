"""Source-copy drafting (the paper's §2.1 / Figure 2).

Draft sequences are substrings of the *query* token sequence, extracted with
a sliding window of length ``draft_len`` and stride 1, capped at ``n_drafts``
(the paper's N_d ≈ 25). No draft model, no extra heads: the cost of drafting
is negligible next to a decoder forward pass.

For decoder-only LMs the same extraction applied to the prompt is
"prompt-lookup" drafting (``prompt_lookup_drafts``).

``dilations``: the paper (§3.1) suggests adding source subsequences "dilated
by one token" to raise the acceptance rate; ``dilations=(1, 2)`` adds
every-other-token windows.

Host-side numpy, an own copy of ``repro.core.drafting`` (the port imports
nothing of the JAX package); ``tests/test_torch_core.py`` holds the two
copies to identical output.
"""

from __future__ import annotations

import numpy as np


def extract_drafts(
    tokens: np.ndarray | list[int],
    draft_len: int,
    n_drafts: int,
    *,
    pad_id: int = 0,
    dilations: tuple[int, ...] = (1,),
) -> tuple[np.ndarray, np.ndarray]:
    """Sliding-window substrings of ``tokens`` (pad tokens excluded).

    Returns (drafts (n_drafts, draft_len) int32, mask (n_drafts,) bool).
    Short/missing windows are padded with ``pad_id`` and masked out.
    """
    toks = np.asarray(tokens, dtype=np.int32)
    toks = toks[toks != pad_id]
    windows: list[np.ndarray] = []
    for d in dilations:
        span = (draft_len - 1) * d + 1
        n_win = max(0, len(toks) - span + 1)
        for s in range(n_win):
            windows.append(toks[s : s + span : d])
        if n_win == 0 and len(toks) > 0 and d == 1:
            w = toks[:draft_len]
            windows.append(np.pad(w, (0, draft_len - len(w)),
                                  constant_values=pad_id))
    drafts = np.full((n_drafts, draft_len), pad_id, dtype=np.int32)
    mask = np.zeros((n_drafts,), dtype=bool)
    for i, w in enumerate(windows[:n_drafts]):
        drafts[i, : len(w)] = w
        mask[i] = True
    return drafts, mask


def prompt_lookup_drafts(prompt_tokens, draft_len: int, n_drafts: int, *,
                         pad_id: int = 0,
                         dilations: tuple[int, ...] = (1,)):
    """Decoder-only analogue: drafts are substrings of the prompt."""
    return extract_drafts(prompt_tokens, draft_len, n_drafts, pad_id=pad_id,
                          dilations=dilations)


def batch_drafts(token_rows: np.ndarray, draft_len: int, n_drafts: int, *,
                 pad_id: int = 0, dilations: tuple[int, ...] = (1,)):
    """Vectorized over a batch of query rows -> (B, n_drafts, DL), (B, n_drafts).

    Output-identical to ``extract_drafts`` per row, but one
    ``sliding_window_view`` per dilation instead of a Python loop over
    B × N_d windows — this is the continuous-batching scheduler's
    per-admission host cost, so it must stay O(1) Python ops per batch.
    """
    toks = np.atleast_2d(np.asarray(token_rows, dtype=np.int32))
    B, T = toks.shape
    # stable-compact non-pad tokens to the row front (extract_drafts strips
    # pads anywhere, not just trailing); tails stay pad_id
    order = np.argsort(toks == pad_id, axis=1, kind="stable")
    comp = np.take_along_axis(toks, order, axis=1)
    lens = (toks != pad_id).sum(axis=1).astype(np.int64)

    drafts = np.full((B, n_drafts, draft_len), pad_id, dtype=np.int32)
    mask = np.zeros((B, n_drafts), dtype=bool)
    offset = np.zeros((B,), np.int64)  # next free draft slot per row
    for d in dilations:
        span = (draft_len - 1) * d + 1
        comp_p = (comp if T >= span else
                  np.pad(comp, ((0, 0), (0, span - T)),
                         constant_values=pad_id))
        view = np.lib.stride_tricks.sliding_window_view(
            comp_p, span, axis=1)[:, :, ::d]        # (B, n_starts, draft_len)
        n_win = np.maximum(lens - span + 1, 0)      # valid starts per row
        # valid windows sit at contiguous starts 0..n_win-1, so the target
        # slot is simply offset + start
        r_idx, s_idx = np.nonzero(np.arange(view.shape[1])[None, :]
                                  < n_win[:, None])
        slot = offset[r_idx] + s_idx
        keep = slot < n_drafts
        r_idx, s_idx, slot = r_idx[keep], s_idx[keep], slot[keep]
        drafts[r_idx, slot] = view[r_idx, s_idx]
        mask[r_idx, slot] = True
        if d == 1:
            # too-short rows still contribute one truncated stride-1 window
            short = (n_win == 0) & (lens > 0) & (offset < n_drafts)
            r_s = np.nonzero(short)[0]
            drafts[r_s, offset[r_s]] = comp_p[r_s, :draft_len]
            mask[r_s, offset[r_s]] = True
            offset = offset + np.where((n_win == 0) & (lens > 0), 1, 0)
        offset = offset + n_win
    return drafts, mask
