"""Batching pipeline: encode (source, target) string pairs into fixed-shape
numpy batches for training; an own copy of ``repro.data.pipeline``
(``padded_batch``, ``lm_batch``, ``batched_dataset``) over the port's
tokenizer.

Layout per example (seq2seq), padding trailing:
  src:       [tok..., eos, pad...]               (encoder input)
  tgt_in:    [bos, tok..., pad...]               (decoder input)
  tgt_out:   [tok..., eos, pad...]               (labels)
Decoder-only LMs use ``lm_batch`` (tokens / loss mask).
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from repro_torch.data.tokenizer import SmilesTokenizer


def padded_batch(
    tok: SmilesTokenizer,
    pairs: list[tuple[str, str]],
    max_src: int,
    max_tgt: int,
) -> dict[str, np.ndarray]:
    b = len(pairs)
    src = np.full((b, max_src), tok.pad_id, dtype=np.int32)
    tgt_in = np.full((b, max_tgt), tok.pad_id, dtype=np.int32)
    tgt_out = np.full((b, max_tgt), tok.pad_id, dtype=np.int32)
    for i, (s, t) in enumerate(pairs):
        s_ids = tok.encode(s, add_eos=True)[:max_src]
        t_ids = tok.encode(t)[: max_tgt - 1]
        src[i, : len(s_ids)] = s_ids
        tgt_in[i, 0] = tok.bos_id
        tgt_in[i, 1 : 1 + len(t_ids)] = t_ids
        tgt_out[i, : len(t_ids)] = t_ids
        tgt_out[i, len(t_ids)] = tok.eos_id
    return {"src": src, "tgt_in": tgt_in, "tgt_out": tgt_out}


def lm_batch(
    tok: SmilesTokenizer,
    pairs: list[tuple[str, str]],
    max_len: int,
    sep_id: int | None = None,
) -> dict[str, np.ndarray]:
    """Decoder-only layout: [bos, src..., eos, tgt..., eos]; loss only on target."""
    b = len(pairs)
    tokens = np.full((b, max_len), tok.pad_id, dtype=np.int32)
    loss_mask = np.zeros((b, max_len), dtype=np.float32)
    sep = tok.eos_id if sep_id is None else sep_id
    for i, (s, t) in enumerate(pairs):
        ids = [tok.bos_id] + tok.encode(s) + [sep]
        prompt_len = len(ids)
        ids += tok.encode(t) + [tok.eos_id]
        ids = ids[:max_len]
        tokens[i, : len(ids)] = ids
        loss_mask[i, prompt_len : len(ids)] = 1.0
    return {"tokens": tokens, "loss_mask": loss_mask}


def batched_dataset(
    tok: SmilesTokenizer,
    pairs: Iterable[tuple[str, str]],
    batch_size: int,
    max_src: int,
    max_tgt: int,
    *,
    drop_remainder: bool = True,
) -> Iterator[dict[str, np.ndarray]]:
    buf: list[tuple[str, str]] = []
    for p in pairs:
        buf.append(p)
        if len(buf) == batch_size:
            yield padded_batch(tok, buf, max_src, max_tgt)
            buf = []
    if buf and not drop_remainder:
        yield padded_batch(tok, buf, max_src, max_tgt)
