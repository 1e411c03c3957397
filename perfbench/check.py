"""The seq2seq family's comparison that decides ``correct``
(``families/seq2seq.py``): what the timed path served, judged by the plain
reference (``reference/model.py``) once the window has closed and the
program's state is freed.

``greedy`` cells (speculative greedy, the greedy family): every query
completed in the window. The reference runs once over each source with the
served tokens fed back (a full forward, no cache), and ``token_gap`` is
the widest gap by which a served token's logit lies below the reference's
best at its position. ``malformed`` counts served sequences whose shape is
wrong: an EOS before the end, an end that is neither EOS nor the budget,
or a token outside the tokenizer's inventory.

``beam`` cells (speculative beam search, the beam family): every query
completed in the window is scored by the reference over each returned
beam: ``logprob_err`` is the widest gap between a beam's served log-prob
and the reference's log-prob of the same tokens. A sample of them drawn
from the seed, with the longest in it, is also searched again by the
reference's own speculative beam search (the paper's Algorithm 1, full
forward passes): ``beam_gap`` is the widest gap by which the
served k-th beam's reference score lies below the reference search's k-th
score. ``malformed`` counts beams out of order or of a wrong shape.

``missing`` counts requests that never came back. The control
(``control=True``) puts the reference in the program's place at TF32: the
greedy numbers read the gap of the token TF32 puts first at each served
position; the beam numbers read TF32's log-probs of the served beams, and
the sample's beams that TF32's own search finds, scored in fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import model as ref


def _served(c, k: int = 0) -> list[int]:
    return [int(x) for x in c.tokens[k][:int(c.lengths[k])]]


def _shape_ok(toks: list[int], tok, max_new: int) -> bool:
    """Served tokens end at EOS or at the budget, and each is one of the
    tokenizer's (the model's reserved ids are never served)."""
    eos = tok.eos_id
    if not toks or max(toks) >= tok.vocab_size:
        return False
    if eos in toks[:-1]:
        return False
    return toks[-1] == eos or len(toks) == max_new


def greedy_numbers(w, cfg, tok, completions, *, max_new: int,
                   control: bool = False) -> dict:
    srcs = [c.src_ids for c in completions]
    tgts = [_served(c) for c in completions]
    malformed = sum(not _shape_ok(t, tok, max_new) for t in tgts)
    gap = 0.0
    with ref.precision(False):
        full = ref.teacher_forced(w, cfg, srcs, tgts, bos=tok.bos_id)
    low = None
    if control:
        with ref.precision(True):
            low = ref.teacher_forced(w, cfg, srcs, tgts, bos=tok.bos_id)
    for i, t in enumerate(tgts):
        if not t:
            continue
        logits = full[i][:len(t)]
        pick = (torch.as_tensor(t, device=logits.device) if low is None
                else low[i][:len(t)].argmax(-1))
        g = logits.max(-1).values - logits.gather(1, pick[:, None])[:, 0]
        gap = max(gap, float(g.max()))
    return {"token_gap": gap, "malformed": float(malformed)}


def _seq_logprob(logits, toks: list[int]) -> float:
    lp = torch.log_softmax(logits[:len(toks)].double(), -1)
    idx = torch.as_tensor(toks, device=lp.device)
    return float(lp.gather(1, idx[:, None]).sum())


def beam_numbers(w, cfg, tok, completions, *, traffic: dict,
                 sample: list[int], control: bool = False) -> dict:
    max_new, n_beams = traffic["max_new"], traffic["n_beams"]
    malformed = 0
    srcs, tgts, served_lp, owner = [], [], [], []
    for i, c in enumerate(completions):
        lp = [float(x) for x in c.logprobs]
        if any(b > a + 1e-6 * max(1.0, abs(a)) for a, b in zip(lp, lp[1:])):
            malformed += 1
        malformed += len(c.lengths) != n_beams
        for k in range(len(c.lengths)):
            t = _served(c, k)
            malformed += not _shape_ok(t, tok, max_new)
            srcs.append(c.src_ids)
            tgts.append(t)
            served_lp.append(lp[k])
            owner.append((i, k))
    with ref.precision(False):
        full = ref.teacher_forced(w, cfg, srcs, tgts, bos=tok.bos_id)
    low = None
    if control:
        with ref.precision(True):
            low = ref.teacher_forced(w, cfg, srcs, tgts, bos=tok.bos_id)
    scores, err = {}, 0.0
    for j, t in enumerate(tgts):
        if not t:
            continue
        mine = _seq_logprob(full[j], t)
        scores[owner[j]] = mine
        other = served_lp[j] if low is None else _seq_logprob(low[j], t)
        err = max(err, abs(other - mine))
    gap = 0.0
    if sample:
        kw = dict(n_beams=n_beams, max_new=max_new,
                  draft_len=traffic["draft_len"], n_drafts=traffic["n_drafts"],
                  bos=tok.bos_id, eos=tok.eos_id, pad=tok.pad_id)
        sample_srcs = [completions[i].src_ids for i in sample]
        with ref.precision(False):
            found = ref.speculative_beam_search(w, cfg, sample_srcs, **kw)
        if control:   # TF32's own search, its beams scored in fp32
            with ref.precision(True):
                theirs = ref.speculative_beam_search(w, cfg, sample_srcs, **kw)
            rows = [(j, k, t) for j, beams in enumerate(theirs)
                    for k, (t, _) in enumerate(beams) if t]
            with ref.precision(False):
                sc = ref.teacher_forced(w, cfg, [sample_srcs[j] for j, _, _
                                                 in rows],
                                        [t for _, _, t in rows],
                                        bos=tok.bos_id)
            for n, (j, k, t) in enumerate(rows):
                scores[(sample[j], k)] = _seq_logprob(sc[n], t)
        for i, beams in zip(sample, found):
            got = [scores.get((i, k), ref.NEG) for k in range(len(beams))]
            for (_, want), have in zip(beams, got):
                gap = max(gap, want - have)
    return {"logprob_err": err, "beam_gap": gap, "malformed": float(malformed)}


def beam_sample(completions, n: int, seed: int) -> list[int]:
    """``n`` completions drawn from the seed, the one with the longest
    first beam always among them."""
    if not completions or n <= 0:
        return []
    longest = max(range(len(completions)),
                  key=lambda i: int(completions[i].lengths[0]))
    rng = np.random.default_rng([seed, 7])
    rest = [i for i in range(len(completions)) if i != longest]
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return sorted([longest] + [rest[j] for j in pick])


def judge(kind: str, w, cfg, tok, completions, *, traffic: dict, seed: int,
          sample_size: int = 0, control: bool = False) -> dict:
    """The cell's numbers, by name (``missing`` is the caller's)."""
    with torch.no_grad():
        if kind == "greedy":
            return greedy_numbers(w, cfg, tok, completions,
                                  max_new=traffic["max_new"], control=control)
        if kind == "beam":
            return beam_numbers(
                w, cfg, tok, completions, traffic=traffic,
                sample=beam_sample(completions, sample_size, seed),
                control=control)
    raise ValueError(f"unknown check kind {kind!r}")


def tap_numbers(w, cfg, tok, taps, served, *, traffic: dict, seed: int,
                slots: int, control: bool = False) -> dict:
    """The logits of the tapped decoder calls against the reference's.

    A tapped call feeds each active slot's ``n_drafts`` rows: the slot's
    last committed token, then one source-copy draft, at the slot's next
    positions. Up to ``slots`` active slots a call, drawn from the seed, are
    matched to the served request they held (by their draft rows, which
    are the source's windows, and their last token, which the served
    tokens must hold at that position); the reference then runs [bos] +
    the committed tokens before it + the fed row, a full forward, and
    ``logit_err`` is the widest gap between a logit the program's step
    produced and the reference's. ``tap_unmatched`` counts slots that no
    served request explains. The control reads TF32's logits instead of
    the program's."""
    DL, N = traffic["draft_len"], traffic["n_drafts"]
    index: dict[bytes, list] = {}
    for c in served:
        d, _ = ref.source_drafts(c.src_ids, DL, N, tok.pad_id)
        index.setdefault(d.numpy().astype(np.int32).tobytes(), []).append(c)
    rng = np.random.default_rng([seed, 5])
    srcs, rows, want, unmatched = [], [], [], 0
    for tokens, positions, logits in taps:
        groups = [g for g in range(tokens.shape[0] // N)
                  if positions[g * N, 0] >= 0]
        pick = rng.choice(len(groups), size=min(slots, len(groups)),
                          replace=False) if groups else []
        for j in sorted(int(x) for x in pick):
            g = groups[j]
            blk = tokens[g * N:(g + 1) * N].astype(np.int32)
            pos, last = int(positions[g * N, 0]), int(blk[0, 0])
            hit = None
            for c in index.get(np.ascontiguousarray(blk[:, 1:]).tobytes(), []):
                toks = _served(c)
                if (pos == 0 and last == tok.bos_id) or (
                        1 <= pos <= len(toks) and toks[pos - 1] == last):
                    hit = c
                    break
            if hit is None:
                unmatched += 1
                continue
            prefix = [tok.bos_id] + _served(hit)[:max(pos - 1, 0)]
            if pos == 0:
                prefix = []
            for r in range(N):
                srcs.append(hit.src_ids)
                rows.append((prefix + blk[r].tolist(), pos))
                want.append(logits[g * N + r])
    if not rows:   # nothing compared: no logit_err, which then fails
        return {"tap_unmatched": float(unmatched)}
    err = 0.0
    with torch.no_grad():
        for lo in range(0, len(rows), 512):
            part = rows[lo:lo + 512]
            src = ref.pad_rows(srcs[lo:lo + 512], w["tok"].device)
            tgt = ref.pad_rows([r for r, _ in part], w["tok"].device)
            with ref.precision(False):
                full = ref.forward(w, cfg, src, tgt)
            if control:
                with ref.precision(True):
                    low = ref.forward(w, cfg, src, tgt)
            for k, (_, pos) in enumerate(part):
                mine = full[k, pos:pos + DL + 1]
                other = (low[k, pos:pos + DL + 1] if control
                         else want[lo + k].to(mine.device))
                err = max(err, float((other - mine).abs().max()))
    return {"logit_err": err, "tap_unmatched": float(unmatched)}
