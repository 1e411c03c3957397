"""The one-shot serving engine (the port of ``repro.serving.engine``'s
``ReactionEngine``): the industrial-application layer the paper targets.

Pipeline per request batch:
  tokenize -> encode once -> extract source-copy drafts (host, numpy)
  -> greedy / speculative greedy / beam / speculative beam -> detokenize.

Decoding modes mirror the paper's experiments:
  greedy               Table 2 baseline
  speculative          Table 2, DL/N_d configurable
  beam                 Table 3/4 baseline
  speculative_beam     Table 3/4, the paper's SBS

On the card the decoder's cached self-attention runs the ``decode_gqa``
kernel and the greedy-family accept op the ``draft_verify`` kernel.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import (batch_drafts, beam_search, extract_drafts,
                              greedy_decode, seq2seq_handle,
                              speculative_beam_search,
                              speculative_greedy_decode)
from repro_torch.data.tokenizer import SmilesTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import seq2seq as s2s

MODES = ("greedy", "speculative", "beam", "speculative_beam")


@dataclasses.dataclass
class EngineConfig:
    """The one-shot fields of ``repro.serving.engine.EngineConfig``."""

    mode: str = "speculative"        # greedy|speculative|beam|speculative_beam
    draft_len: int = 10              # the paper's best DL
    n_drafts: int = 25               # the paper's N_d cap
    n_beams: int = 5
    max_new: int = 96
    max_src: int = 128
    dilations: tuple[int, ...] = (1,)

    def __post_init__(self):
        for name, lo in (("max_new", 1), ("max_src", 1), ("draft_len", 0),
                         ("n_drafts", 1), ("n_beams", 1)):
            if getattr(self, name) < lo:
                raise ValueError(f"EngineConfig.{name}={getattr(self, name)} "
                                 f"must be >= {lo}")
        if self.mode not in MODES:
            raise ValueError(f"unknown decode mode {self.mode!r}")


@dataclasses.dataclass
class Prediction:
    smiles: list[str]                # candidates, best first
    logprobs: list[float]
    n_calls: int
    acceptance_rate: float
    wall_s: float


def _mode_shape(ecfg: EngineConfig,
                mode: str | None = None) -> tuple[str, int, int, int]:
    """mode -> (session kind, beams K, drafts N_d, draft length DL)."""
    return {
        "greedy": ("greedy", 1, 1, 0),
        "speculative": ("greedy", 1, ecfg.n_drafts, ecfg.draft_len),
        "beam": ("beam", ecfg.n_beams, 1, 0),
        "speculative_beam": ("beam", ecfg.n_beams, ecfg.n_drafts,
                             ecfg.draft_len),
    }[ecfg.mode if mode is None else mode]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


class ReactionEngine:
    """Per-request engine: each call runs its batch to completion.

    ``device``: where the model runs; ``None`` means the card, and a missing
    card is an error. Pass ``device="cpu"`` to run the plain versions."""

    def __init__(self, params, cfg: ModelConfig, tokenizer: SmilesTokenizer,
                 engine_cfg: EngineConfig | None = None, *, device=None):
        self.device = resolve_device(device)
        self.params = _to(params, self.device)
        self.cfg = cfg
        self.tok = tokenizer
        self.ecfg = engine_cfg or EngineConfig()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _encode(self, src: torch.Tensor, batch: int, cache_len: int):
        memory, src_mask = s2s.encode(self.params, self.cfg, src)
        handle = seq2seq_handle(self.params, self.cfg, memory_mask=src_mask)
        cache = s2s.init_cache(self.cfg, batch, cache_len, memory=memory,
                               params=self.params)
        return handle, cache

    def _encode_src(self, queries: Sequence[str]) -> np.ndarray:
        rows = [self.tok.encode_padded(q, self.ecfg.max_src, add_eos=True)
                for q in queries]
        return np.stack(rows)

    def predict(self, queries: Sequence[str]) -> list[Prediction]:
        """Batched greedy / speculative-greedy prediction (one best output)."""
        ecfg = self.ecfg
        src_np = self._encode_src(queries)
        src = torch.from_numpy(src_np).to(self.device)
        B = src.shape[0]
        start = torch.zeros((B,), dtype=torch.int32, device=self.device)
        last = torch.full((B,), self.tok.bos_id, dtype=torch.int32,
                          device=self.device)
        self._sync()
        t0 = time.perf_counter()
        if ecfg.mode == "greedy":
            handle, cache = self._encode(src, B, ecfg.max_new + 2)
            res = greedy_decode(handle, cache, last, start,
                                max_new=ecfg.max_new, eos_id=self.tok.eos_id)
            rate = np.zeros((B,))
        elif ecfg.mode == "speculative":
            drafts, mask = batch_drafts(src_np, ecfg.draft_len, ecfg.n_drafts,
                                        dilations=ecfg.dilations)
            handle, cache = self._encode(
                src, B, ecfg.max_new + ecfg.draft_len + 2)
            res = speculative_greedy_decode(
                handle, cache, last, start,
                torch.from_numpy(drafts).to(self.device),
                torch.from_numpy(mask).to(self.device),
                max_new=ecfg.max_new, eos_id=self.tok.eos_id)
            rate = res.acceptance_rate.cpu().numpy()
        else:
            raise ValueError(f"predict() supports greedy/speculative, "
                             f"got {ecfg.mode}")
        tokens = res.tokens.cpu().numpy()
        wall = time.perf_counter() - t0
        return [Prediction(smiles=[self.tok.decode(tokens[b])], logprobs=[0.0],
                           n_calls=int(res.n_calls),
                           acceptance_rate=float(rate[b]), wall_s=wall / B)
                for b in range(B)]

    def predict_topn(self, query: str) -> Prediction:
        """Beam / speculative-beam search for one query (the paper's B=1
        retrosynthesis serving regime)."""
        ecfg = self.ecfg
        src_np = self._encode_src([query])
        src = torch.from_numpy(src_np).to(self.device)
        spec = ecfg.mode == "speculative_beam"
        if not spec and ecfg.mode != "beam":
            raise ValueError(f"predict_topn() supports beam/speculative_beam, "
                             f"got {ecfg.mode}")
        dl = ecfg.draft_len if spec else 0
        drafts, mask = extract_drafts(src_np[0], max(dl, 1), ecfg.n_drafts,
                                      dilations=ecfg.dilations)
        if dl == 0:
            drafts = drafts[:1, :0]
            mask = mask[:1]
        self._sync()
        t0 = time.perf_counter()
        handle, cache = self._encode(src, 1, ecfg.max_new + dl + 2)
        kw = dict(n_beams=ecfg.n_beams, max_new=ecfg.max_new,
                  eos_id=self.tok.eos_id)
        if spec:
            res = speculative_beam_search(
                handle, cache, self.tok.bos_id, 0,
                torch.from_numpy(drafts).to(self.device),
                torch.from_numpy(mask).to(self.device), **kw)
            accepted = int(res.accepted_tokens)
        else:
            res = beam_search(handle, cache, self.tok.bos_id, 0, **kw)
            accepted = 0
        tokens = res.tokens.cpu().numpy()
        logprobs = res.logprobs.cpu().tolist()
        generated = int(res.lengths[0])
        wall = time.perf_counter() - t0
        # true rate: committed draft tokens / generated tokens on the best
        # beam's path, same convention as predict()
        return Prediction(smiles=[self.tok.decode(t) for t in tokens],
                          logprobs=logprobs, n_calls=int(res.n_calls),
                          acceptance_rate=accepted / max(generated, 1),
                          wall_s=wall)
