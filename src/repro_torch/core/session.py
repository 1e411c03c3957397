"""DecodeSession — the fixed-slot decoding core every mode shares, the
one-shot half of ``repro.core.session``.

Every decoding mode (greedy, speculative greedy, beam, speculative beam) is
one step function over the same fixed-slot state: ``session_step`` runs ONE
verify/commit iteration for every slot. ``run_session`` drains the slots
with a host loop (one device-to-host read per iteration for its exit test)
where the JAX package runs a ``lax.while_loop``.

Slot layout: ``n_slots`` (S) requests, each owning ``n_beams`` (K) beam rows
× ``n_drafts`` (N_d) draft rows of the model cache — cache row
``(s*K + k)*N_d + d``. Greedy-family modes are K=1; non-speculative modes are
N_d=1, DL=0.

On the greedy-family path the vocab argmax and the accepted-prefix match go
through the ``draft_verify`` kernel (its plain version on the CPU). The beam
step's argmax is over log-probs with the pad column masked, which is not
that kernel's function, so it stays plain torch.

JAX's ``.at[].set(mode="drop")`` drops out-of-range writes in silence; torch
raises, so the token writes scatter into one extra trash column instead.
``jax.lax.top_k`` breaks ties toward the lower index and the candidate array
holds many exact -1e30 ties, so top-k here is a stable descending sort.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.handles import DecoderHandle
from repro_torch.core.tree_batch import gather_rows, sync_winner
from repro_torch.kernels.draft_verify.ops import draft_verify
from repro_torch.models.attention import KVCache

_NEG = -1e30
_I32 = torch.int32


class SessionSpec(NamedTuple):
    """Static shape/mode bundle."""

    n_slots: int                 # S — concurrent requests
    n_beams: int                 # K — rows per request (1 = greedy family)
    n_drafts: int                # N_d — drafts verified per row per step
    draft_len: int               # DL — tokens per draft
    max_new: int
    eos_id: int
    pad_id: int = 0
    kind: str = "greedy"         # "greedy" (argmax accept) | "beam" (top-k)


class SessionState(NamedTuple):
    """Per-slot decode state. Leading dims: (S, K) unless noted."""

    tokens: torch.Tensor      # (S, K, max_new) committed output, pad after EOS
    logp: torch.Tensor        # (S, K) cumulative log-prob (beam family)
    last: torch.Tensor        # (S, K) last committed, not-yet-fed token
    pos: torch.Tensor         # (S, K) absolute position of `last`
    n_out: torch.Tensor       # (S, K) committed token count
    finished: torch.Tensor    # (S, K) bool
    active: torch.Tensor      # (S,) bool — slot holds a live request
    drafts: torch.Tensor      # (S, N_d, DL) per-request source-copy drafts
    draft_mask: torch.Tensor  # (S, N_d) bool
    accepted: torch.Tensor    # (S,) committed draft tokens (beam-0 path)
    cache: Any                # model cache, batch rows = S*K*N_d


def _cache_device(cache) -> torch.device:
    if isinstance(cache, dict):
        return _cache_device(next(iter(cache.values())))
    if isinstance(cache, KVCache):
        return cache.k.device
    return cache.device


def init_state(spec: SessionSpec, cache: Any) -> SessionState:
    """All slots free. ``cache`` must have S*K*N_d batch rows and length
    >= max_new + DL + 2 (every step writes at pos .. pos+DL)."""
    S, K = spec.n_slots, spec.n_beams
    kw = dict(device=_cache_device(cache))
    return SessionState(
        tokens=torch.full((S, K, spec.max_new), spec.pad_id, dtype=_I32, **kw),
        logp=torch.full((S, K), _NEG, dtype=torch.float32, **kw),
        last=torch.zeros((S, K), dtype=_I32, **kw),
        pos=torch.zeros((S, K), dtype=_I32, **kw),
        n_out=torch.zeros((S, K), dtype=_I32, **kw),
        finished=torch.ones((S, K), dtype=torch.bool, **kw),
        active=torch.zeros((S,), dtype=torch.bool, **kw),
        drafts=torch.zeros((S, spec.n_drafts, spec.draft_len), dtype=_I32,
                           **kw),
        draft_mask=torch.zeros((S, spec.n_drafts), dtype=torch.bool, **kw),
        accepted=torch.zeros((S,), dtype=_I32, **kw),
        cache=cache,
    )


def _is_stop_token(spec: SessionSpec, tok: torch.Tensor) -> torch.Tensor:
    """True where ``tok`` ends its sequence: the EOS. (The JAX package's
    per-request stop ids belong to the streaming engine, a later slice.)"""
    return tok == spec.eos_id


def _accept_lengths(greedy_tok: torch.Tensor, drafts: torch.Tensor,
                    draft_mask: torch.Tensor) -> torch.Tensor:
    """greedy_tok: (..., N_d, DL+1) argmax predictions; drafts:
    (..., N_d, DL). Returns (..., N_d): longest prefix where draft token i
    equals the model's argmax prediction for that position."""
    if drafts.shape[-1] == 0:
        return torch.zeros(drafts.shape[:-1], dtype=_I32,
                           device=drafts.device)
    match = (drafts == greedy_tok[..., :-1]).to(_I32)
    n_acc = torch.cumprod(match, dim=-1).sum(-1).to(_I32)
    return torch.where(draft_mask, n_acc, torch.zeros_like(n_acc))


def _stable_topk(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _forward(spec: SessionSpec, handle: DecoderHandle, state: SessionState):
    """One verify pass over all slots × beams × drafts (the paper's
    effective-batch inflation). Inactive slots feed position -1."""
    S, K, N_d, DL = (spec.n_slots, spec.n_beams, spec.n_drafts,
                     spec.draft_len)
    rel = torch.arange(DL + 1, dtype=_I32, device=state.last.device)
    last_e = torch.repeat_interleave(state.last.reshape(S * K), N_d)
    drafts_rows = state.drafts[:, None].expand(S, K, N_d, DL).reshape(
        S * K * N_d, DL)
    toks = torch.cat([last_e[:, None], drafts_rows], dim=1)
    pos_e = (torch.repeat_interleave(state.pos.reshape(S * K), N_d)[:, None]
             + rel[None, :])
    active_e = torch.repeat_interleave(state.active, K * N_d)
    pos_e = torch.where(active_e[:, None], pos_e, -1)
    logits, cache = handle.decode_step(state.cache, toks, pos_e)
    return logits, cache, drafts_rows, rel


def _scatter_tokens(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                    max_new: int) -> torch.Tensor:
    """``out.at[..., idx].set(vals, mode="drop")`` for idx in
    [0, max_new]: index max_new marks a dropped write."""
    padded = F.pad(out, (0, 1), value=0)
    padded.scatter_(-1, idx.clamp(max=max_new).long(), vals.to(out.dtype))
    return padded[..., :max_new]


def _greedy_family_step(spec: SessionSpec, handle: DecoderHandle,
                        state: SessionState) -> SessionState:
    """Speculative greedy (and with DL=0, plain greedy): accept the longest
    argmax-matching draft prefix + one bonus token per slot. K == 1."""
    S, N_d, DL = spec.n_slots, spec.n_drafts, spec.draft_len
    max_new = spec.max_new
    logits, cache, drafts_rows, rel = _forward(spec, handle, state)

    finished = state.finished[:, 0] | ~state.active
    last, pos = state.last[:, 0], state.pos[:, 0]
    n_out, out = state.n_out[:, 0], state.tokens[:, 0]

    # argmax over the vocab + accepted-prefix match, fused in one kernel
    greedy_tok, n_acc = draft_verify(logits.contiguous(),
                                     drafts_rows.contiguous(),
                                     state.draft_mask.reshape(-1).contiguous())
    greedy_tok = greedy_tok.reshape(S, N_d, DL + 1)

    # --- accept / select best draft --------------------------------------
    n_acc = n_acc.reshape(S, N_d)
    best = torch.argmax(n_acc, dim=-1).to(_I32)                  # (S,)
    best = torch.where(state.active, best, 0)
    n_acc_b = n_acc.gather(1, best[:, None].long())[:, 0]
    new_toks = greedy_tok.gather(
        1, best[:, None, None].long().expand(S, 1, DL + 1))[:, 0]  # (S, DL+1)

    # --- EOS/stop + budget truncation -------------------------------------
    within = rel[None, :] <= n_acc_b[:, None]
    is_eos = _is_stop_token(spec, new_toks) & within
    any_eos = is_eos.any(1)
    first_eos = torch.argmax(is_eos.to(_I32), dim=1).to(_I32)
    n_prop = torch.where(any_eos, first_eos + 1, n_acc_b + 1)
    budget = max_new - n_out
    n_app = torch.minimum(n_prop, budget)
    n_app = torch.where(finished, 0, n_app)
    hit_eos = any_eos & (first_eos + 1 <= budget) & ~finished

    # --- write accepted tokens --------------------------------------------
    write = rel[None, :] < n_app[:, None]
    idx = torch.where(write, n_out[:, None] + rel[None, :], max_new)
    out = _scatter_tokens(out, idx, new_toks, max_new)

    # --- commit: winner cache sync -----------------------------------------
    cache = handle.commit_cache(cache, torch.repeat_interleave(n_app, N_d))
    cache = sync_winner(cache, best, N_d)

    last_idx = (n_app - 1).clamp(0, DL)
    new_last = new_toks.gather(1, last_idx[:, None].long())[:, 0]
    last = torch.where(n_app > 0, new_last, last)
    pos = pos + n_app
    n_out = n_out + n_app
    new_finished = finished | hit_eos | (n_out >= max_new)
    acc_used = torch.minimum(n_acc_b, n_app)
    return state._replace(
        tokens=out[:, None], last=last[:, None], pos=pos[:, None],
        n_out=n_out[:, None], finished=new_finished[:, None], cache=cache,
        accepted=state.accepted + acc_used)


def _beam_family_step(spec: SessionSpec, handle: DecoderHandle,
                      state: SessionState) -> SessionState:
    """Speculative beam search, batched over S slots (and with DL=0, plain
    beam search). Per slot: candidates of unequal lengths
    beam ++ draft[:a] ++ w, global top-K (the paper's Alg. 1)."""
    S, K, N_d, DL = (spec.n_slots, spec.n_beams, spec.n_drafts,
                     spec.draft_len)
    A = DL + 1
    max_new, pad_id = spec.max_new, spec.pad_id
    V = handle.vocab_size
    logits, cache, drafts_rows, rel = _forward(spec, handle, state)
    dev = rel.device

    fin = state.finished | ~state.active[:, None]                # (S, K)

    lp_all = torch.log_softmax(logits.float(), dim=-1)
    lp_all[:, :, pad_id] = _NEG          # pad is never a real emission
    lp_all = lp_all.reshape(S, K, N_d, A, V)
    greedy_tok = torch.argmax(lp_all, dim=-1).to(_I32)

    # ---- best draft per beam ---------------------------------------------
    d4 = drafts_rows.reshape(S, K, N_d, DL)
    dm = state.draft_mask[:, None].expand(S, K, N_d)
    n_acc = _accept_lengths(greedy_tok, d4, dm)                  # (S, K, N_d)
    best = torch.argmax(n_acc, dim=-1).to(_I32)                  # (S, K)
    best = torch.where(state.active[:, None], best, 0)

    def take_best(x):
        idx = best.long().reshape(S, K, 1, *([1] * (x.dim() - 3)))
        return x.gather(2, idx.expand(S, K, 1, *x.shape[3:]))[:, :, 0]

    lp_best = take_best(lp_all)                                  # (S, K, A, V)
    draft_best = take_best(d4)                                   # (S, K, DL)
    n_acc_b = n_acc.gather(2, best[..., None].long())[..., 0]

    # ---- candidates of unequal lengths -----------------------------------
    d_lp = lp_best[:, :, :DL, :].gather(
        3, draft_best[..., None].long())[..., 0]                 # (S, K, DL)
    cum = torch.cat([torch.zeros((S, K, 1), device=dev),
                     torch.cumsum(d_lp, dim=-1)], dim=-1)        # (S, K, A)
    topv, topi = _stable_topk(lp_best, K)                        # (S, K, A, K)
    cand_lp = state.logp[:, :, None, None] + cum[..., None] + topv
    valid_a = rel[None, None, :] <= n_acc_b[..., None]           # (S, K, A)
    valid_a &= (state.n_out[..., None] + rel[None, None, :] + 1) <= max_new
    # prefixes may not extend past a draft EOS/stop token
    draft_eos = torch.cumsum(
        _is_stop_token(spec, draft_best).to(_I32), dim=-1)
    no_eos_in_prefix = torch.cat(
        [torch.ones((S, K, 1), dtype=torch.bool, device=dev), draft_eos == 0],
        dim=-1)
    valid_a &= no_eos_in_prefix
    cand_lp = torch.where(valid_a[..., None], cand_lp, _NEG)

    # same-path dedup: (a, w=draft[a]) with a < n_acc is a strict prefix of
    # a longer candidate in this set
    d_pad = F.pad(draft_best, (0, 1), value=-1)
    dup = ((topi == d_pad[..., None])
           & (rel[None, None, :, None] < n_acc_b[..., None, None]))
    cand_lp = torch.where(dup, _NEG, cand_lp)

    # finished beams: single pass-through candidate (a=0, k=0), logp kept
    pass_lp = torch.full((A, K), _NEG, device=dev)
    pass_lp[0, 0] = 0.0
    cand_lp = torch.where(fin[..., None, None],
                          state.logp[:, :, None, None] + pass_lp[None, None],
                          cand_lp)

    # ---- per-slot global top-K -------------------------------------------
    flat = cand_lp.reshape(S, K * A * K)
    new_logp, flat_idx = _stable_topk(flat, K)                   # (S, K)
    parent = (flat_idx // (A * K)).to(_I32)
    k_rank = torch.arange(K, dtype=_I32, device=dev)
    parent = torch.where(state.active[:, None], parent, k_rank[None, :])
    a_len = ((flat_idx // K) % A).to(_I32)
    w_tok = topi.reshape(S, K * A * K).gather(1, flat_idx).to(_I32)
    par = parent.long()
    was_fin = fin.gather(1, par)

    def take_parent(x):
        idx = par.reshape(S, K, *([1] * (x.dim() - 2)))
        return x.gather(1, idx.expand(S, K, *x.shape[2:]))

    # ---- materialize new beams -------------------------------------------
    out_p = take_parent(state.tokens)                            # (S,K,max_new)
    nout_p = state.n_out.gather(1, par)
    drafts_p = take_parent(draft_best)                           # (S, K, DL)
    # committed tokens this round: draft[:a] ++ w  -> length a+1
    seg = torch.where(
        rel[None, None, :] < a_len[..., None], F.pad(drafts_p, (0, 1)),
        torch.where(rel[None, None, :] == a_len[..., None], w_tok[..., None],
                    pad_id))
    n_new = torch.where(was_fin, 0, a_len + 1)
    idx = torch.where(rel[None, None, :] < n_new[..., None],
                      nout_p[..., None] + rel[None, None, :], max_new)
    out_new = _scatter_tokens(out_p, idx, seg, max_new)

    new_finished = (was_fin | _is_stop_token(spec, w_tok)
                    | (nout_p + n_new >= max_new))
    new_last = torch.where(was_fin, state.last.gather(1, par), w_tok)
    new_pos = state.pos.gather(1, par) + n_new
    new_nout = nout_p + n_new

    # ---- cache: winner-draft row of the parent beam ------------------------
    best_p = best.gather(1, par)                                 # (S, K)
    base = (torch.arange(S, dtype=_I32, device=dev) * K)[:, None]
    src = ((base + parent) * N_d + best_p).reshape(-1)
    cache = gather_rows(cache, torch.repeat_interleave(src, N_d))
    n_keep = torch.where(was_fin, 0, a_len + 1)
    cache = handle.commit_cache(
        cache, torch.repeat_interleave(n_keep.reshape(-1), N_d))

    acc = torch.where(state.active & ~was_fin[:, 0], a_len[:, 0], 0)
    return state._replace(
        tokens=out_new, logp=new_logp, last=new_last, pos=new_pos,
        n_out=new_nout, finished=new_finished, cache=cache,
        accepted=state.accepted + acc)


def session_step(spec: SessionSpec, handle: DecoderHandle,
                 state: SessionState) -> SessionState:
    """ONE decode iteration for every slot: verify pass -> accept -> commit."""
    if spec.kind == "greedy":
        if spec.n_beams != 1:
            raise ValueError("greedy-family sessions require n_beams == 1")
        return _greedy_family_step(spec, handle, state)
    if spec.kind == "beam":
        return _beam_family_step(spec, handle, state)
    raise ValueError(f"unknown session kind: {spec.kind!r}")


def run_session(spec: SessionSpec, handle: DecoderHandle,
                state: SessionState) -> tuple[SessionState, int]:
    """Drain all resident requests: a host loop over the shared step with
    one device-to-host read per iteration for the exit test. Returns
    (state, n_iterations)."""
    i = 0
    while i < spec.max_new:
        done = state.finished | ~state.active[:, None]
        if bool(done.all()):
            break
        state = session_step(spec, handle, state)
        i += 1
    return state, i
