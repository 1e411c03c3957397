"""ModelBackend — the architecture layer under ``StreamingEngine`` (the port
of ``repro.serving.backend``).

The scheduler and the session step are model-agnostic (they drive a
``DecoderHandle``); what is not is admission: how a request's context
enters its slot's cache rows. A backend owns that surface: cache
construction (``init_cache``), the step handle (``step_handle``), host-side
request preparation (``make_request``: tokenization, drafting, prefill
chunks) and the device-side admission pieces.

``Seq2SeqBackend`` (``chunked = False``): the Molecular Transformer's
admission is monolithic and batched: the engine gathers the queries one
scheduler iteration admits, encodes them in one encoder pass and scatters
each one's cross-attention K/V and memory mask into its slot's rows; the
self-attention cache starts empty (dense rows marked empty, paged rows
unmapped).

``DecoderOnlyBackend`` (``chunked = True``): ragged chunked prefill. The
prompt minus its last token (which seeds decoding) is cut on the host into
fixed-size chunks; each scheduler iteration writes ONE chunk per
mid-prefill slot into the slot's first cache row (through its block table
when paged), interleaved with the decode step, so residents never stall
behind a long admission. When the prompt is written the slot's other rows
adopt row 0: dense rows by a copy, paged rows by aliasing its block table
(the page planner then copy-on-writes the draft-boundary page).
Recurrent state (Mamba, RWKV) rides through each chunk token by token and
is committed at the chunk's valid length, as the JAX package's lane does.
Drafts are prompt-lookup drafts: the paper's source-copy trick applied to
a decoder-only LM.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.drafting import batch_drafts, prompt_lookup_drafts
from repro_torch.core.handles import (DecoderHandle, seq2seq_handle,
                                      transformer_handle)
from repro_torch.core.session import SessionSpec, unmap_cache_rows
from repro_torch.core.tree_batch import set_rows, strided_rows
from repro_torch.models import attention as attn_mod
from repro_torch.models import seq2seq as s2s
from repro_torch.models import transformer as tr
from repro_torch.models.attention import KVCache, PagedKVCache
from repro_torch.serving.api import GenerationParams


@dataclasses.dataclass
class Request:
    """One admission, backend-prepared on the host at ``submit()`` time.

    ``args``: host values for the admit call (seq2seq: source tokens,
    drafts, draft mask) or for the slot's activation once its prompt is
    written (decoder-only: last prompt token, its position, drafts, draft
    mask). ``chunks``: ``[(tokens (C,), pos0, n_valid)]`` fixed-shape
    prefill chunks (empty for the seq2seq backend and one-token prompts).
    ``gen``: the request's slot params for ``reset_slots``
    (``ResolvedParams.device_args``). ``params``: the host-side
    ``ResolvedParams`` (read-out trimming). ``prompt``: the host token array
    the request was built from.
    """

    args: tuple
    chunks: list
    gen: tuple = ()
    params: object = None
    prompt: np.ndarray | None = None


def _pad_drafts(drafts: np.ndarray, dmask: np.ndarray, spec: SessionSpec):
    """Pad a per-request (n_d', dl') draft matrix to the group's (N_d, DL)
    ceiling. Pad rows are masked out and pad columns sit beyond the slot's
    ``eff_dl`` clamp, so the step treats the padded matrix exactly like the
    smaller one."""
    if drafts.shape == (spec.n_drafts, spec.draft_len):
        return drafts, dmask
    out = np.zeros((spec.n_drafts, spec.draft_len), np.int32)
    mask = np.zeros((spec.n_drafts,), bool)
    out[:drafts.shape[0], :drafts.shape[1]] = drafts
    mask[:dmask.shape[0]] = dmask
    return out, mask


def _map_nodes(fn, cache):
    if isinstance(cache, dict):
        return {k: _map_nodes(fn, v) for k, v in cache.items()}
    if isinstance(cache, tuple):
        return tuple(_map_nodes(fn, v) for v in cache)
    return fn(cache)


def _clean_rows(cache, rows):
    """Recycle cache ``rows`` for a fresh request, in place: dense KV rows
    become unreadable (stored position -1), paged rows are unmapped,
    recurrent state resets to its zero initial state."""
    idx = torch.as_tensor(rows, dtype=torch.long)

    def one(x):
        if isinstance(x, PagedKVCache):
            x.block_tables[:, idx.to(x.block_tables.device)] = -1
        elif isinstance(x, KVCache):
            x.pos[:, idx.to(x.pos.device)] = -1
        else:
            x[:, idx.to(x.device)] = 0
        return x

    return _map_nodes(one, cache)


def _adopt_row0(cache, rows):
    """Give every row of a slot the first row's context, in place: dense
    leaves (K/V, stored positions, recurrent state) copy row 0, paged
    leaves alias its block table."""
    idx = torch.as_tensor(rows, dtype=torch.long)

    def copy_row0(t):
        i = idx.to(t.device)
        t[:, i] = t[:, i[:1]].expand_as(t[:, i])

    def one(x):
        if isinstance(x, PagedKVCache):
            copy_row0(x.block_tables)
        elif isinstance(x, KVCache):
            for t in (x.k, x.v, x.pos):
                copy_row0(t)
        else:
            copy_row0(x)
        return x

    return _map_nodes(one, cache)


class Seq2SeqBackend:
    """Encoder–decoder (Molecular Transformer) backend: monolithic admission
    — encode the query, scatter cross-attention K/V + memory mask into the
    slot's cache rows."""

    chunked = False

    def __init__(self, cfg: ModelConfig, ecfg, tokenizer):
        if tokenizer is None:
            raise ValueError("Seq2SeqBackend requires a tokenizer")
        self.cfg = cfg
        self.ecfg = ecfg
        self.tok = tokenizer

    # ---- cache / step ----------------------------------------------------
    def step_handle(self, params) -> DecoderHandle:
        return seq2seq_handle(params, self.cfg)   # mask rides in the cache

    def row_len(self, spec: SessionSpec) -> int:
        return spec.cache_len

    def init_cache(self, n_rows: int, row_len: int, paged=None, *, device,
                   cfg=None, widths=None):
        """``cfg``: the config whose head counts the cache holds (a mesh
        rank's own heads), default the model's; the MT has attention
        positions only, so ``widths`` is unused."""
        return s2s.init_cache(
            cfg or self.cfg, n_rows, row_len, memory_len=self.ecfg.max_src,
            memory_mask=np.zeros((n_rows, self.ecfg.max_src), bool),
            paged=paged, device=device)

    def pageable(self) -> bool:
        return True

    def prefill_blocks(self, page_size: int) -> int:
        return 0   # admission writes no prompt into the self-attn cache

    def per_token_bytes(self) -> int:
        cfg = self.cfg
        return cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 4

    # ---- host-side request prep ------------------------------------------
    def make_request(self, query, spec: SessionSpec, params=None) -> Request:
        """``params`` is a resolved ``GenerationParams`` (defaults = the
        group's ceilings). Drafts are extracted at the REQUEST's draft
        window, then padded to the group's (N_d, DL) shape."""
        ecfg = self.ecfg
        if params is None:
            params = GenerationParams().resolve(spec)
        if isinstance(query, str):
            src = np.asarray(self.tok.encode_padded(query, ecfg.max_src,
                                                    add_eos=True), np.int32)
        else:
            src = np.zeros((ecfg.max_src,), np.int32)
            q = np.asarray(query, np.int32).reshape(-1)
            src[:len(q)] = q[:ecfg.max_src]
        dl, nd = params.draft_len, params.n_drafts
        if dl > 0:
            drafts_b, dmask_b = batch_drafts(src[None], dl, nd,
                                             dilations=ecfg.dilations)
            drafts, dmask = drafts_b[0], dmask_b[0]
        else:
            drafts = np.zeros((nd, 0), np.int32)
            dmask = np.ones((nd,), bool)
        drafts, dmask = _pad_drafts(drafts, dmask, spec)
        return Request(args=(torch.from_numpy(src),
                             torch.from_numpy(np.ascontiguousarray(drafts)),
                             torch.from_numpy(np.ascontiguousarray(dmask))),
                       chunks=[], gen=params.device_args(spec),
                       params=params, prompt=src)

    # ---- device-side admission -------------------------------------------
    def encode_kv(self, params, srcs):
        """The encoder leg of admission for a batch of queries, ``srcs`` (B,
        M) padded to ``max_src``: one encoder pass and one ``memory_kv`` a
        decoder layer, whatever B. Returns the stacked memory K/V ({"mk",
        "mv"}: (R, B, M, H, hd)) and the source mask (B, M)."""
        cfg = self.cfg
        memory, mask = s2s.encode(params, cfg, srcs)
        mkv = [attn_mod.memory_kv(p["cross_attn"], cfg, memory)
               for p in params["dec_blocks"]]
        return ({"mk": torch.stack([m["mk"] for m in mkv]),
                 "mv": torch.stack([m["mv"] for m in mkv])}, mask)

    def admit_cache_precomputed(self, params, cache, rows, mkv, mask):
        """Scatter a batch of encoded sources into their slots' cache rows,
        in place: ``rows`` (B, rows a slot) holds each query's rows, and
        query b's K/V (``mkv`` leaves (R, B, ...)) and mask (``mask`` (B,
        M)) go to all of ``rows[b]``, one indexed write a leaf. Recycled
        rows: the evicted requests' stale K/V must be unreadable (dense: pos
        = -1 marks every slot empty; paged: the rows' block tables are
        unmapped and the page planner maps fresh pages)."""
        set_rows(cache["cross"], rows, {k: v[:, :, None]
                                        for k, v in mkv.items()})
        mm = cache["mmask"]
        mm[:, rows.to(mm.device).long()] = mask[:, None].to(mm.device)
        sc = cache["self"]
        if isinstance(sc, PagedKVCache):
            unmap_cache_rows(cache, rows)
        else:
            sc.pos[:, rows.to(sc.pos.device).long()] = -1
        return cache

    def reset_args(self, src, drafts, dmask):
        """(last_token, start_pos, drafts, dmask) for ``reset_slots``:
        decoding starts from BOS at position 0."""
        return self.tok.bos_id, 0, drafts, dmask


class DecoderOnlyBackend:
    """Decoder-only LM backend (``repro_torch.models.transformer``: dense,
    MoE, Mamba-hybrid, RWKV and VLM patterns): chunked ragged prompt
    prefill with prompt-lookup drafts. Recurrent state and the VLM's memory
    K/V ride dense beside a paged attention cache; an attention-free
    pattern has nothing to page. As in the JAX package, the engine has no
    memory path: a VLM's cross-attention positions read the zero memory
    K/V of ``init_cache``. The audio encoder has no decode step and is
    refused."""

    chunked = True

    def __init__(self, cfg: ModelConfig, ecfg, tokenizer=None):
        if cfg.family == "seq2seq":
            raise ValueError("use Seq2SeqBackend for encoder-decoder models")
        if cfg.family == "audio":
            raise ValueError("encoder-only architecture: no decode step")
        tr.check_serves(cfg)
        self.cfg = cfg
        self.ecfg = ecfg
        self.tok = tokenizer

    # ---- cache / step ----------------------------------------------------
    def step_handle(self, params) -> DecoderHandle:
        return transformer_handle(params, self.cfg)

    def row_len(self, spec: SessionSpec) -> int:
        # the prompt shares the row with the generated tokens
        return self.ecfg.max_src + spec.cache_len

    def init_cache(self, n_rows: int, row_len: int, paged=None, *, device,
                   cfg=None, widths=None):
        """``cfg``: the config whose head counts the cache holds (a mesh
        rank's own heads), default the model's; ``widths``: the recurrent
        and cross-attention widths it holds (``transformer.
        local_widths``), default the model's."""
        if paged is not None and not self.pageable():
            raise ValueError(
                f"{self.cfg.name}: no attention positions to page "
                f"(layer_pattern={self.cfg.layer_pattern}); recurrent state "
                f"is O(1) per row — serve this architecture dense")
        return tr.init_cache(cfg or self.cfg, n_rows, row_len, paged=paged,
                             device=device, widths=widths)

    def pageable(self) -> bool:
        return "attn" in self.cfg.layer_pattern

    def prefill_blocks(self, page_size: int) -> int:
        """Worst-case prompt blocks one admission maps into row 0 before
        the slot's siblings alias them (``PageAllocator`` accounting)."""
        return -(-self.ecfg.max_src // page_size)

    def per_token_bytes(self) -> int:
        cfg = self.cfg
        n_attn = sum(1 for k in cfg.layer_pattern if k == "attn")
        return cfg.n_repeats * n_attn * 2 * cfg.n_kv_heads * cfg.head_dim * 4

    # ---- host-side request prep ------------------------------------------
    def make_request(self, query, spec: SessionSpec, params=None) -> Request:
        ecfg = self.ecfg
        if params is None:
            params = GenerationParams().resolve(spec)
        if isinstance(query, str):
            if self.tok is None:
                raise ValueError("string queries need a tokenizer; submit "
                                 "token arrays instead")
            prompt = np.asarray(self.tok.encode(query), np.int32)
        else:
            prompt = np.asarray(query, np.int32).reshape(-1)
        P = int(prompt.shape[0])
        if not 1 <= P <= ecfg.max_src:
            raise ValueError(f"prompt length {P} outside [1, "
                             f"max_src={ecfg.max_src}]")
        dl, nd = params.draft_len, params.n_drafts
        if dl > 0:
            drafts, dmask = prompt_lookup_drafts(prompt, dl, nd,
                                                 dilations=ecfg.dilations)
        else:
            drafts = np.zeros((nd, 0), np.int32)
            dmask = np.ones((nd,), bool)
        drafts, dmask = _pad_drafts(drafts, dmask, spec)
        # the prompt minus its last token (which seeds decoding as
        # ``last``), in chunks of one fixed shape: a ragged stream of
        # prompt lengths only changes the chunk COUNT, on the host
        return Request(
            args=(int(prompt[P - 1]), P - 1,
                  torch.from_numpy(np.ascontiguousarray(drafts)),
                  torch.from_numpy(np.ascontiguousarray(dmask))),
            chunks=self.suffix_chunks(prompt[:P - 1]),
            gen=params.device_args(spec), params=params, prompt=prompt)

    def prompt_body(self, req: Request) -> np.ndarray:
        """The request's committed prompt body: the prompt minus its last
        token, which seeds decoding and is never written to the cache."""
        return np.asarray(req.prompt, np.int32).reshape(-1)[:-1]

    def suffix_chunks(self, body: np.ndarray, m0: int = 0) -> list:
        """Fixed-shape prefill chunks for ``body[m0:]`` with ABSOLUTE
        positions (chunk c0 starts at token c0 of the full body)."""
        C = max(1, int(self.ecfg.prefill_chunk))
        chunks = []
        for c0 in range(int(m0), len(body), C):
            seg = body[c0:c0 + C]
            padded = np.zeros((C,), np.int32)
            padded[:len(seg)] = seg
            chunks.append((padded, c0, len(seg)))
        return chunks

    # ---- device-side admission pieces -------------------------------------
    def begin_cache(self, cache, rows):
        return _clean_rows(cache, rows)

    def prefill_chunks_cache(self, params, cache, rows0, tokens, pos0,
                             n_valid):
        """Write this iteration's prompt chunk of EVERY slot of a group at
        once, in place: ``rows0`` the group's slot-leading cache rows (a
        host list, evenly spaced), ``tokens`` (S_g, C), ``pos0`` /
        ``n_valid`` (S_g,) device tensors. Pad positions are -1: their
        writes land in the throwaway slot or trash page, and recurrent
        state is kept after each lane's ``n_valid`` tokens (the chunk's
        checkpoint at ``n_valid``, as the JAX package commits it), so an
        idle lane (``n_valid == 0``) leaves its row bitwise as it was. The
        rows are views of the cache (no take / put copies), and the
        logits, which nobody reads, are never computed."""
        step = rows0[1] - rows0[0] if len(rows0) > 1 else 1
        sub = strided_rows(cache, rows0[0], step, len(rows0))
        C = tokens.shape[1]
        rel = torch.arange(C, dtype=torch.int32, device=tokens.device)
        positions = torch.where(rel[None, :] < n_valid[:, None],
                                pos0[:, None] + rel[None, :], -1)
        tr.write_prompt(params, self.cfg, sub, tokens, positions, n_valid)
        return cache

    def finish_cache(self, cache, rows):
        return _adopt_row0(cache, rows)

    def reset_args(self, last, pos, drafts, dmask):
        """Decoding resumes from the prompt's last token at its own
        position."""
        return last, pos, drafts, dmask


def make_backend(cfg: ModelConfig, ecfg, tokenizer=None):
    """Default backend for a config: ``EngineConfig.backend`` may name one
    ("seq2seq" | "decoder_only"); "auto" keys off the model family."""
    kind = getattr(ecfg, "backend", "auto")
    if kind == "auto":
        kind = "seq2seq" if cfg.family == "seq2seq" else "decoder_only"
    if kind == "seq2seq":
        return Seq2SeqBackend(cfg, ecfg, tokenizer)
    if kind == "decoder_only":
        return DecoderOnlyBackend(cfg, ecfg, tokenizer)
    raise ValueError(f"unknown backend {kind!r}")
