"""Faults planted under the timed path, to show that the comparison which
decides ``correct`` catches them: a step that returns its state unchanged,
half of the decoder's batch dropped (its logits zeroed: the seq2seq
decoder's step, or the decoder-only model's), a token altered where it is
written, and (beam cells) a beam selection that drops the best candidate,
whose beams are consistent with their log-probs and in order but are not
the best ones. ``calibrate.py --fault`` reads their numbers on
the card at a cell's own size; the CPU tests plant them in small cells.
The benchmark's own runs never plant one.
"""

from __future__ import annotations

import contextlib
import importlib

from perfbench.reference import synthetic


def _unchanged():
    import repro_torch.core.session as session

    return session, "session_step", lambda spec, handle, state: state


def _half_batch_of(module_name: str):
    def fault():
        module = importlib.import_module(module_name)
        step = module.decode_step

        def half(*a, **kw):
            logits, cache = step(*a, **kw)
            logits = logits.clone()
            logits[logits.shape[0] // 2:] = 0.0
            return logits, cache

        return module, "decode_step", half

    return fault


_half_batch = _half_batch_of("repro_torch.models.seq2seq")
_half_batch_decoder = _half_batch_of("repro_torch.models.transformer")


def _token_altered():
    import repro_torch.core.session as session

    scatter = session._scatter_tokens
    n = synthetic.tokenizer().vocab_size

    def altered(out, idx, vals, max_new):
        vals = vals.clone()
        vals.view(-1)[0] = (vals.view(-1)[0] + 1) % n
        return scatter(out, idx, vals, max_new)

    return session, "_scatter_tokens", altered


def _beam_selection():
    import repro_torch.core.session as session

    topk = session._stable_topk

    def second_best_on(x, k):
        if x.dim() != 2:   # the per-row token top-k stays; the beams' goes
            return topk(x, k)
        vals, idx = topk(x, k + 1)
        return vals[..., 1:], idx[..., 1:]

    return session, "_stable_topk", second_best_on


BOTH = ("seq2seq", "decoder_only")
# name -> (the fault, the check kinds and the model families of the cells
# it applies to)
FAULTS = {"state-unchanged": (_unchanged, ("greedy", "beam"), BOTH),
          "half-batch": (_half_batch, ("greedy", "beam"), ("seq2seq",)),
          "half-batch-decoder": (_half_batch_decoder, ("greedy",),
                                 ("decoder_only",)),
          "token-altered": (_token_altered, ("greedy", "beam"), BOTH),
          "beam-selection": (_beam_selection, ("beam",), ("seq2seq",))}


def applicable(kind: str, family: str) -> list[str]:
    """The faults a cell of check kind ``kind`` and model family
    ``family`` can have, by name."""
    return sorted(n for n, (_, kinds, families) in FAULTS.items()
                  if kind in kinds and family in families)


@contextlib.contextmanager
def planted(name: str):
    """The program with fault ``name`` in place, restored on exit."""
    module, attr, op = FAULTS[name][0]()
    old = getattr(module, attr)
    setattr(module, attr, op)
    try:
        yield
    finally:
        setattr(module, attr, old)
