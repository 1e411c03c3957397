"""The decoder-only family: a language model of ``repro_torch.models.
transformer`` served through ``StreamingEngine``'s decoder-only backend,
speculative greedy with prompt-lookup drafts.

A configuration file of this family holds, besides ``name``, ``source``,
``task``, ``precision`` and ``tf32``:

- ``family``: ``"decoder_only"``;
- ``model``: the fields of ``repro_torch.configs.base.ModelConfig`` (nested
  ``moe`` and ``mamba`` objects for those layers), every field that the
  reference reads stated, so the program and the reference read one
  configuration;
- ``reference``: the plain reference's module, ``reference/<name>.py``,
  which gives ``weight_shapes``, ``init(cfg, seed, device)``,
  ``each_logits`` and ``query_flops``, and whose flat weights
  ``port_params`` hands to the program;
- ``init_seed``: the seed the weights are drawn from, on the device, by the
  reference's own ``init`` (no training, no cache, no call to the
  program's ``init``).

A query is a synthetic reaction's source in the configuration's ``task``
direction, tokenized by the frozen 28-id tokenizer with its EOS (the ids
are the first of the model's vocabulary, as the Molecular Transformer's
are), and submitted as the prompt's token ids; generation runs to the
tokenizer's EOS or ``max_new``. A traffic mix of this family also names
``prefill_chunk`` and ``stagger``.

Seeded weights almost never serve EOS and accept almost no prompt-lookup
draft (``tokens_per_call`` near 1), so every request runs to ``max_new``
and takes about as many iterations as any other. Clients that started
together would then finish together, in bursts, and ``queries_per_s`` over
a window would read the phase of a burst: the mix's ``stagger`` starts
client k ``stagger`` x k iterations in (``harness.closed_loop``), which
spreads the completions over each round when ``stagger`` x clients is
about a request's iterations. Even so, a rate of such a cell counts
requests of one length at seeded weights, not a trained model's traffic.

The comparison, after the window, with the program's state freed:
``token_gap``, the widest gap by which a served token's logit lies below
the reference's best at its position (a full forward over the prompt and
the served tokens); ``malformed``, served sequences of a wrong shape (an
EOS before the end, an end that is neither EOS nor the budget; seeded
weights may serve any id of the vocabulary, so ids are not judged); and
with a ``tap``, ``logit_err``, the widest gap between a logit that the
tapped ``repro_torch.models.transformer.decode_step`` calls produced and
the reference's, and ``tap_unmatched``. The control reads TF32's logits
and TF32's first token in the program's place.
"""

from __future__ import annotations

import hashlib
import importlib
import re

import numpy as np
import torch

from perfbench import traffic
from perfbench.reference import synthetic
from perfbench.reference.model import source_drafts

KERNELS = ("paged_decode_gqa", "draft_verify")
TAP = ("repro_torch.models.transformer", "decode_step")


def reference(cfg: dict):
    """The configuration's plain reference module."""
    name = cfg["reference"]
    if not re.fullmatch(r"[a-z][a-z0-9_]*", name):
        raise ValueError(f"bad reference name {name!r}")
    return importlib.import_module(f"perfbench.reference.{name}")


def model_cfg(config: dict) -> dict:
    """The reference's view: the ``model`` object, and which reference."""
    return dict(config["model"], reference=config["reference"])


def _fingerprint(w: dict) -> str:
    """sha256 of every weight's name, shape, sum and norm (float64, taken
    on the weights' device: no host copy of the weights)."""
    sums = torch.stack([torch.stack([t.sum(dtype=torch.float64),
                                     torch.linalg.vector_norm(
                                         t, dtype=torch.float64)])
                        for t in w.values()]).cpu().numpy()
    h = hashlib.sha256("".join(f"{k}{tuple(t.shape)}"
                               for k, t in w.items()).encode())
    h.update(sums.tobytes())
    return h.hexdigest()


def load_weights(cell, device, *, log, cache_dir=None) -> dict:
    """Drawn from ``init_seed`` by the reference, on ``device``."""
    cfg = model_cfg(cell.config)
    w = reference(cfg).init(cfg, cell.config["init_seed"], device)
    return {"weights": w, "train_sources": set(), "trained_s": None,
            "hash": f"drawn from init_seed {cell.config['init_seed']}, "
                    f"fingerprint {_fingerprint(w)}"}


def queries(cell, seed: int, got: dict) -> list:
    """(prompt ids, target) pairs: the sources' ids with their EOS."""
    tok = synthetic.tokenizer()
    return [(np.asarray(tok.encode(s, add_eos=True), np.int32), t)
            for s, t in traffic.queries(cell.traffic, cell.config["task"],
                                        seed, got["train_sources"])]


def prompt_ids(query, tok) -> list[int]:
    return [int(x) for x in query]


def query_flops(cfg: dict, completion) -> int:
    return reference(cfg).query_flops(cfg, completion.src_len,
                                      int(completion.lengths[0]))


def port_config(config: dict):
    """``config["model"]`` as the program's ``ModelConfig``."""
    from repro_torch.configs import base

    m = dict(config["model"])
    for key in ("layer_pattern", "ffn_pattern"):
        m[key] = tuple(m[key])
    for key, cls in (("moe", base.MoEConfig), ("mamba", base.MambaConfig)):
        if m.get(key) is not None:
            m[key] = cls(**m[key])
    return base.ModelConfig(**m)


def port_params(w: dict, cfg: dict) -> dict:
    """The reference's flat weights as ``repro_torch.models.transformer``'s
    tree: layer ``l`` is repeat ``l // p`` of pattern position ``l % p``
    (copies: the program may write what it is given)."""
    def t(name):
        return w[name].detach().clone()

    def block(i):
        p = f"blk.{i}"
        return {"norm1": {"scale": t(f"{p}.ln1.g")},
                "attn": {f"w{n}": {"w": t(f"{p}.attn.w{n}")} for n in "qkvo"},
                "norm2": {"scale": t(f"{p}.ln2.g")},
                "ffn": {n: {"w": t(f"{p}.ffn.{n}")}
                        for n in ("w_in", "w_gate", "w_out")}}

    period = len(cfg["layer_pattern"])
    params = {"tok": {"embed": t("tok")},
              "blocks": tuple([block(r * period + i)
                               for r in range(cfg["n_layers"] // period)]
                              for i in range(period)),
              "final_norm": {"scale": t("ln_f.g")}}
    if not cfg["tie_embeddings"]:
        params["lm_head"] = {"w_vocab": t("out")}
    return params


def build_engine(cell, w: dict, tok, device):
    from repro_torch.serving.engine import EngineConfig, StreamingEngine

    mix = cell.traffic
    ecfg = EngineConfig(
        mode=mix["mode"], draft_len=mix["draft_len"],
        n_drafts=mix["n_drafts"], n_beams=mix["n_beams"],
        max_new=mix["max_new"], max_src=mix["max_src"],
        n_slots=mix["slots"], mode_groups={mix["mode"]: mix["slots"]},
        paged=True, page_size=mix["page_size"], backend="decoder_only",
        prefill_chunk=mix["prefill_chunk"], eos_id=tok.eos_id,
        pad_id=tok.pad_id)
    params = port_params(w, model_cfg(cell.config))
    return StreamingEngine(params, port_config(cell.config), None, ecfg,
                           device=device)


# ---------------------------------------------------------------------------
# the comparison


def _served(c) -> list[int]:
    return [int(x) for x in c.tokens[0][:int(c.lengths[0])]]


def _shape_ok(toks: list[int], eos: int, max_new: int) -> bool:
    """Served tokens end at EOS or at the budget, with no EOS before."""
    if not toks or eos in toks[:-1]:
        return False
    return toks[-1] == eos or len(toks) == max_new


def judge(kind: str, w, cfg, tok, completions, *, traffic: dict, seed: int,
          sample_size: int = 0, control: bool = False) -> dict:
    """``token_gap`` and ``malformed`` of every completion in the window
    (``missing`` is the caller's): a full forward a completion over its
    prompt and its served tokens but the last, whose logits at the prompt's
    last position and after choose each served token. The control reads
    the gap of the token that TF32 puts first at each position."""
    if kind != "greedy":
        raise ValueError(f"the decoder-only family checks greedy cells, not "
                         f"{kind!r}")
    ref = reference(cfg)
    tgts = [_served(c) for c in completions]
    malformed = sum(not _shape_ok(t, tok.eos_id, traffic["max_new"])
                    for t in tgts)
    live = [i for i, t in enumerate(tgts) if t]
    rows = [completions[i].src_ids + tgts[i][:-1] for i in live]
    spans = [(completions[i].src_len - 1,
              completions[i].src_len - 1 + len(tgts[i])) for i in live]
    gap = 0.0

    def reduce(k, full, low=None):
        nonlocal gap
        t = torch.as_tensor(tgts[live[k]], device=full.device)
        pick = t if low is None else low.argmax(-1)
        g = full.max(-1).values - full.gather(1, pick[:, None])[:, 0]
        gap = max(gap, float(g.max()))

    ref.each_logits(w, cfg, rows, spans, reduce,
                    tf32=(False, True) if control else (False,))
    return {"token_gap": gap, "malformed": float(malformed)}


def tap_numbers(w, cfg, tok, taps, served, *, traffic: dict, seed: int,
                slots: int, control: bool = False) -> dict:
    """The logits of the tapped decoder calls against the reference's.

    A tapped verify call feeds each active slot's ``n_drafts`` rows: the
    slot's last token (the prompt's last, then the newest served one),
    then one prompt-lookup draft, at the slot's next positions. Up to
    ``slots`` active slots a call, drawn from the seed, are matched to the
    served request they held (by their draft rows, which are the prompt's
    windows, and their last token, which the prompt and the served tokens
    hold at that position); the reference then runs the sequence up to
    that position and the fed row, a full forward, and ``logit_err`` is
    the widest gap between a logit the program's step produced and the
    reference's. ``tap_unmatched`` counts slots that no served request
    explains. The control reads TF32's logits instead of the program's."""
    DL, N = traffic["draft_len"], traffic["n_drafts"]
    index: dict[bytes, list] = {}
    for c in served:
        d, _ = source_drafts(c.src_ids, DL, N, tok.pad_id)
        index.setdefault(d.numpy().astype(np.int32).tobytes(), []).append(c)
    rng = np.random.default_rng([seed, 5])
    # (the sequence before the fed row and the row, the row's first
    # position, the program's logits of the row (DL + 1, V))
    rows, unmatched = [], 0
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
                seq = c.src_ids + _served(c)
                if c.src_len - 1 <= pos < len(seq) and seq[pos] == last:
                    hit = seq
                    break
            if hit is None:
                unmatched += 1
                continue
            rows += [(hit[:pos] + blk[r].tolist(), pos, logits[g * N + r])
                     for r in range(N)]
    if not rows:   # nothing compared: no logit_err, which then fails
        return {"tap_unmatched": float(unmatched)}
    err = 0.0

    def reduce(k, full, low=None):
        nonlocal err
        other = rows[k][2].to(full.device) if low is None else low
        err = max(err, float((other - full).abs().max()))

    reference(cfg).each_logits(
        w, cfg, [r[0] for r in rows],
        [(r[1], r[1] + DL + 1) for r in rows], reduce,
        tf32=(False, True) if control else (False,))
    return {"logit_err": err, "tap_unmatched": float(unmatched)}
