"""Single-pass multi-draft speculative greedy decoding, the port of
``repro.core.multidraft`` (beyond the paper).

The paper's verify pass inflates the batch to B·N_d rows, so every draft
row re-reads the whole KV cache. Here all N_d drafts ride ONE row per
sequence: T = 1 + N_d·DL fed tokens under a segment mask
(``build_local_mask``), so the cache is read once per sequence. The output
equals the expanded-batch speculative decoder's, and so plain greedy's.
Attention-only patterns (dense or MoE FFNs, the VLM's cross-attention
positions under ``memory_mask``) on a dense cache; a pattern with a
recurrent (Mamba / RWKV) position is refused by name, since its mixer runs
the fed tokens in order and drafts cannot share a row.

The JAX package runs the loop as a ``lax.while_loop``; here it is a host
loop with one device read per iteration for its exit test, as
``run_session`` is. The accept step is a plain ``argmax`` and
``_accept_lengths``, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.session import _accept_lengths
from repro_torch.core.speculative import SpeculativeResult
from repro_torch.models import transformer as tr

_I32 = torch.int32


def build_local_mask(n_drafts: int, draft_len: int) -> np.ndarray:
    """(T, T) segment mask, T = 1 + n_drafts·draft_len: token 0 (the last
    committed token) is visible to every token; draft token (j, i) also
    sees its own segment's prefix."""
    T = 1 + n_drafts * draft_len
    m = np.zeros((T, T), dtype=bool)
    m[:, 0] = True
    for j in range(n_drafts):
        s = 1 + j * draft_len
        for i in range(draft_len):
            m[s + i, s:s + i + 1] = True
    return m


def multidraft_speculative_decode(
    params, cfg: ModelConfig, cache, last_token, start_pos, drafts,
    draft_mask, *, max_new: int, eos_id: int, pad_id: int = 0,
    memory_mask=None,
) -> SpeculativeResult:
    """``speculative_greedy_decode``'s contract with one decoder row per
    sequence. drafts: (B, N_d, DL); the dense cache (one row per sequence)
    must cover start_pos + max_new + DL + 1 and is written in place;
    ``memory_mask`` (B, M) masks the cross-attention memory."""
    tr.refuse_recurrent(cfg, "multi-draft verification")
    B, N_d, DL = drafts.shape
    dev = last_token.device
    local_mask = torch.from_numpy(build_local_mask(N_d, DL)).to(dev)
    drafts = drafts.to(device=dev, dtype=_I32)
    draft_mask = draft_mask.to(device=dev, dtype=torch.bool)
    if memory_mask is not None:
        memory_mask = memory_mask.to(device=dev, dtype=torch.bool)
    out = torch.full((B, max_new + 1), pad_id, dtype=_I32, device=dev)
    rel = torch.arange(DL + 1, dtype=_I32, device=dev)
    drafts_flat = drafts.reshape(B, N_d * DL)
    # logits layout: index 0 predicts pos + 1 from the last token; index
    # 1 + j*DL + i predicts the token after draft j's prefix of i + 1
    seg_off = 1 + torch.arange(N_d, dtype=_I32, device=dev)[:, None] * DL
    idx = torch.cat([torch.zeros((N_d, 1), dtype=_I32, device=dev),
                     seg_off + rel[None, :-1]], dim=1).long()  # (N_d, DL+1)
    last = last_token.to(device=dev, dtype=_I32)
    pos = start_pos.to(device=dev, dtype=_I32)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    n_out = torch.zeros((B,), dtype=_I32, device=dev)
    n_accepted = torch.zeros((B,), dtype=_I32, device=dev)
    bi = torch.arange(B, device=dev)
    n_calls = 0
    while bool((~finished.all()) & (n_out < max_new).any()):
        toks = torch.cat([last[:, None], drafts_flat], dim=1)
        d_pos = (pos[:, None] + 1 + rel[None, :-1]).repeat(1, N_d)
        positions = torch.cat([pos[:, None], d_pos], dim=1)
        logits, local_kv = tr.multidraft_verify_step(
            params, cfg, cache, toks, positions, local_mask,
            memory_mask=memory_mask)
        greedy_all = logits.argmax(-1).to(_I32)                    # (B, T)
        greedy_tok = greedy_all[:, idx]                    # (B, N_d, DL+1)
        n_acc = _accept_lengths(greedy_tok, drafts, draft_mask)
        best = n_acc.argmax(-1)
        n_acc_b = n_acc[bi, best]
        new_toks = greedy_tok[bi, best]                        # (B, DL+1)

        within = rel[None, :] <= n_acc_b[:, None]
        is_eos = (new_toks == eos_id) & within
        any_eos = is_eos.any(1)
        first_eos = is_eos.to(_I32).argmax(1).to(_I32)
        n_prop = torch.where(any_eos, first_eos + 1, n_acc_b + 1)
        budget = max_new - n_out
        n_app = torch.where(finished, 0, torch.minimum(n_prop, budget))
        hit_eos = any_eos & (first_eos + 1 <= budget) & ~finished

        # out-of-budget writes land in the extra trash column
        write = rel[None, :] < n_app[:, None]
        w_idx = torch.where(write, n_out[:, None] + rel[None, :], max_new)
        out[bi[:, None], w_idx.long()] = new_toks

        # commit the winner's accepted K/V: the last token and the
        # n_app - 1 accepted draft tokens
        tr.commit_multidraft(cfg, cache, local_kv, best.to(_I32),
                             (n_app - 1).clamp(min=0), pos, draft_len=DL)

        last_idx = (n_app - 1).clamp(0, DL).long()
        last = torch.where(n_app > 0, new_toks[bi, last_idx], last)
        pos = pos + n_app
        n_out = n_out + n_app
        finished = finished | hit_eos | (n_out >= max_new)
        n_accepted = n_accepted + torch.minimum(n_acc_b, n_app)
        n_calls += 1
    rate = n_accepted / n_out.clamp(min=1)
    return SpeculativeResult(tokens=out[:, :max_new], lengths=n_out,
                             n_calls=n_calls, accepted_tokens=n_accepted,
                             acceptance_rate=rate)
