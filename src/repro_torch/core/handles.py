"""Model-agnostic decoder contract used by every decoding algorithm (the
port of ``repro.core.handles``: the seq2seq MT and the decoder-only
transformer).

A ``DecoderHandle`` closes over (params, cfg, memory mask) and exposes:

  decode_step(cache, tokens (B,T), positions (B,T)) -> (logits (B,T,V), cache')
  commit_cache(cache', n_keep (B,)) -> cache

The same two calls are the streaming engine's chunked prefill: feeding a
prompt chunk through ``decode_step`` at its absolute positions writes its
K/V in place (``repro_torch.serving.backend.DecoderOnlyBackend``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import seq2seq as s2s
from repro_torch.models import transformer as tr


@dataclasses.dataclass(frozen=True)
class DecoderHandle:
    decode_step: Callable[[Any, torch.Tensor, torch.Tensor], tuple]
    commit_cache: Callable[[Any, torch.Tensor], Any]
    vocab_size: int


def _expand_mask(memory_mask, batch: int):
    """Draft/beam expansion inflates the batch (B -> B*n); tile the memory
    mask to match (rows of one sequence stay adjacent, as tree_batch does)."""
    if memory_mask is None or memory_mask.shape[0] == batch:
        return memory_mask
    return torch.repeat_interleave(memory_mask, batch // memory_mask.shape[0],
                                   dim=0)


def seq2seq_handle(params, cfg: ModelConfig, *,
                   memory_mask=None) -> DecoderHandle:
    def step(cache, tokens, positions):
        return s2s.decode_step(params, cfg, cache, tokens, positions,
                               memory_mask=_expand_mask(memory_mask,
                                                        tokens.shape[0]))

    return DecoderHandle(
        decode_step=step,
        commit_cache=lambda cache, n_keep: s2s.commit_cache(cfg, cache, n_keep),
        vocab_size=cfg.vocab_size,
    )


def transformer_handle(params, cfg: ModelConfig, *,
                       memory_mask=None) -> DecoderHandle:
    def step(cache, tokens, positions):
        return tr.decode_step(params, cfg, cache, tokens, positions,
                              memory_mask=_expand_mask(memory_mask,
                                                       tokens.shape[0]))

    return DecoderHandle(
        decode_step=step,
        commit_cache=lambda cache, n_keep: tr.commit_cache(cfg, cache, n_keep),
        vocab_size=cfg.vocab_size,
    )
