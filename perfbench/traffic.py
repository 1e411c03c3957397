"""The one traffic generator: every mix is a data file under ``traffic/``
that this module reads.

A mix fixes the decode mode, the slots and the closed-loop clients, the
engine's limits (``max_src``, ``max_new``, page size, draft length and
count, beams; a decoder-only model's prefill chunk and its clients'
stagger), the warm-up and the size of the query pool. The queries are
fresh synthetic reactions drawn from the run's seed in the task's
direction (the configuration's ``task``), none of whose sources is in the
training corpus. A model family turns each source into its prompt
(``families/<family>.py``).
"""

from __future__ import annotations

import numpy as np

from perfbench.reference import synthetic

KEYS = {"mode", "slots", "clients", "n_beams", "draft_len", "n_drafts",
        "max_src", "max_new", "page_size", "warmup_iterations", "pool",
        "why"}
# keys a mix of one model family has besides: the decoder-only engine
# writes a prompt into its slot ``prefill_chunk`` tokens an iteration, and
# its clients start ``stagger`` iterations apart (``harness.closed_loop``:
# seeded weights serve every request to its budget, and clients that all
# start together would finish together)
FAMILY_KEYS = {"decoder_only": {"prefill_chunk", "stagger"}}


def validate(mix: dict, name: str, family: str = "seq2seq") -> None:
    keys = KEYS | FAMILY_KEYS.get(family, set())
    missing = keys - set(mix)
    extra = set(mix) - keys
    if missing or extra:
        raise ValueError(f"traffic {name}: missing {sorted(missing)}, "
                         f"unknown {sorted(extra)}")
    if mix["clients"] != mix["slots"]:
        raise ValueError(f"traffic {name}: a closed loop of C clients over "
                         f"C slots, got {mix['clients']} over {mix['slots']}")
    if mix.get("stagger", 0) * (mix["clients"] - 1) > mix["warmup_iterations"]:
        raise ValueError(f"traffic {name}: the last client starts at "
                         f"iteration stagger x (clients - 1), after the "
                         f"warm-up's {mix['warmup_iterations']}")


def queries(mix: dict, task: str, seed: int,
            held_out: set[str]) -> list[tuple[str, str]]:
    """``mix["pool"]`` (source, target) pairs drawn from ``seed``; a pair
    whose source is in ``held_out`` (the training corpus) is drawn again.
    Sources longer than ``max_src`` tokens (with EOS) are drawn again too,
    so no request is cut."""
    rng = np.random.default_rng(seed)
    tok = synthetic.tokenizer()
    out: list[tuple[str, str]] = []
    while len(out) < mix["pool"]:
        r, p = synthetic.reaction(rng)
        src, tgt = (r, p) if task == "forward" else (p, r)
        if src in held_out or len(tok.encode(src)) + 1 > mix["max_src"]:
            continue
        if len(tok.encode(tgt)) + 1 > mix["max_new"]:
            continue
        out.append((src, tgt))
    return out
