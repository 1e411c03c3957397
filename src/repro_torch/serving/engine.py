"""Serving engines (the port of ``repro.serving.engine``): the
industrial-application layer the paper targets.

Pipeline per request batch:
  tokenize -> encode once -> extract source-copy drafts (host, numpy)
  -> greedy / speculative greedy / beam / speculative beam -> detokenize.

Decoding modes mirror the paper's experiments:
  greedy               Table 2 baseline
  speculative          Table 2, DL/N_d configurable
  beam                 Table 3/4 baseline
  speculative_beam     Table 3/4, the paper's SBS

Two engines share these modes:

``ReactionEngine`` — the per-request reference: runs each request batch to
completion (every request waits for the slowest member of its batch).

``StreamingEngine`` — the production path: S fixed decode slots in per-mode
slot groups (``EngineConfig.mode_groups``) over one model cache, driven by
``repro_torch.serving.scheduler.ContinuousScheduler``. Finished sequences
leave at once and queued requests take their slots; beams are batched
across slots. With ``EngineConfig(paged=True)`` the self-attention cache is
a ``PagedKVCache``: admission is gated on free pages, each iteration plans
its page maintenance on the card (``device_page_plan``), and an iteration
the pool cannot cover changes nothing, so the host preempts the youngest
resident and replays it. The request front door is
``repro_torch.serving.api``: ``submit()`` returns a ``RequestHandle`` with
``.result()`` / ``.stream()`` / ``.cancel()``. Outputs are token-identical
to ``ReactionEngine`` and to the JAX package's ``StreamingEngine``.

JAX's one donated jitted megastep becomes an eager PyTorch function over
tensors the engine updates in place. A steady-state iteration of a paged
session reads the card twice: the plan's exhaustion flag (and copy count)
before the plan is applied, and the iteration's small output bundle after
the step; a dense session reads once.

``EngineConfig(mesh=make_serving_mesh((data, model)))`` shards the session
over a world of ranks (``repro_torch.launch``), as the JAX package's
sharded engine shards it over devices: rank ``(d, m)`` holds data shard
``d``'s slots (each group's local slots ``[d * per, (d + 1) * per)``),
their cache rows and the page pool's segment ``d`` (global pages ``[d *
pps, (d + 1) * pps)``, plus a trash page of its own), and model shard
``m`` of the weights (``serving_param_shardings``: the layers reduce over
the model axis, ``repro_torch.sharding.ctx``). Every rank runs the same
host scheduler and the same device page plan over replicated block
tables (index rows pin pages of every shard); a rank runs the step over
its own rows only, through a view of the tables in its segment's local
page ids. After the step the small per-slot bundle and the rank's rows'
tables are gathered over the data axis on the host, once an iteration,
so every rank's scheduler sees every slot. Admissions write on the ranks
of the owning shard; every rank edits the replicated tables. A finished
slot is read on its owner and broadcast. The realtime clock is rank 0's,
broadcast at each read. Tokens equal the unsharded engine's, except
where an MoE FFN drops choices: there a row's output depends on the other
rows of its call, and a mesh places requests on the least-loaded shard,
so the tokens are those of the JAX package's sharded engine (the MoE
router keeps the global call's places and capacity,
``repro_torch.models.moe``). Every decoder-only family serves on a mesh:
MoE by expert shard, Mamba by ``d_inner`` channel, RWKV and
cross-attention by head (``launch.shardings.serving_param_shardings``);
the cache holds a rank's own heads and channels. Every rank must make the
same engine calls in the same order: ``FrontDoorServer`` over a mesh
engine runs its socket on rank 0 and hands each iteration's calls to the
other ranks (``repro_torch.serving.server``). Streams are a rank's own:
a stream sink reads only the bundle every rank gathers, and a late
subscriber catches up from the committed row-0 tokens the host keeps
from those bundles, so subscribing on one rank calls no collective.
Unlike the JAX package's, a radix prefix
match is cut at its first page from another shard (a rank reads only
its own segment): the cut suffix is prefilled, and the tokens are the
cold run's; and the seq2seq encoder-output LRU is a rank's own (a rank
encodes its shard's admissions only), so are its ``prefix_stats()``.

The decoder-only backend (``DecoderOnlyBackend``, a dense GQA language
model served with ``tokenizer=None`` and ``EngineConfig.eos_id``) admits by
ragged chunked prefill: admission only recycles the slot's rows; each
iteration's step first writes one ``prefill_chunk``-token chunk of every
mid-prefill slot's prompt into the slot's first row (the paged plan maps
the chunk's pages in the same pass), and the iteration whose bundle shows
a slot's last chunk written activates the slot: its other rows adopt row
0 and decoding starts from the prompt's last token.

``EngineConfig(overload=OverloadPolicy(...))`` drives the scheduler's
priority aging, deadline-aware preemption and load shedding.
``EngineConfig(prefix_cache=True)`` reuses shared prefixes. On the seq2seq
backend it keeps an LRU of encoder outputs keyed by the source tokens: a
repeated source skips the encoder, and hit and miss admit alike
(``Seq2SeqBackend.admit_cache_precomputed``), so reuse never changes a
token. On a paged decoder-only engine it keeps a radix tree over committed
prompt pages (``RadixPageCache``): an admitted prompt is matched against
the tree, the matched pages are aliased into the slot's block table and
only the suffix is prefilled. The match is cut to whole multiples of
lcm(page_size, prefill_chunk) tokens, so the suffix is written by the same
chunk launches as in a cold run and the tokens are the cold run's.
Retained pages stay allocated through index rows appended to the block
table after the group rows; under pool pressure the least recently used
are evicted before a resident is preempted. ``submit_child`` /
``cancel_subtree`` serve a tree of requests, as a retrosynthesis planner
expands and prunes one; pruning drops the subtree's cached pages. A
pattern with a recurrent (Mamba / RWKV) position refuses
``prefix_cache``: the tree holds attention pages only, and a shared
prefix would leave the recurrent state without it.

On the card the decoder's cached self-attention runs the ``decode_gqa``
kernel (dense cache) or the ``paged_decode_gqa`` kernel (paged cache), and
the greedy-family accept op the ``draft_verify`` kernel.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
import warnings
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import (batch_drafts, beam_search, extract_drafts,
                              greedy_decode, seq2seq_handle,
                              speculative_beam_search,
                              speculative_greedy_decode)
from repro_torch.core.session import (GroupedState, PageAllocator,
                                      PoolExhausted, RadixPageCache,
                                      SessionSpec, ShardedPageAllocator,
                                      alias_prefix_pages, apply_page_plan,
                                      apply_page_plan_segment,
                                      clear_index_cells, device_free_pages,
                                      device_free_pages_by_shard,
                                      device_page_plan, global_pages,
                                      grouped_init_state, grouped_step,
                                      paged_cache_entries,
                                      radix_cell_coords, read_row_pages,
                                      release_slot, reset_slot,
                                      segment_pages, unmap_cache_rows,
                                      write_index_cells)
from repro_torch.data.tokenizer import SmilesTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import seq2seq as s2s
from repro_torch.models import transformer as tr
from repro_torch.models.attention import PagedKVCache
from repro_torch.serving.api import (MAX_STOP_IDS, GenerationParams,
                                     RequestCancelled, RequestHandle,
                                     RequestRejected, RequestSpec,
                                     RequestStatus)
from repro_torch.serving.backend import make_backend
from repro_torch.serving.scheduler import (ContinuousScheduler,
                                           OverloadPolicy, SlotResult)
from repro_torch.sharding import ctx as shard_ctx

MODES = ("greedy", "speculative", "beam", "speculative_beam")


@dataclasses.dataclass
class EngineConfig:
    """The fields of ``repro.serving.engine.EngineConfig`` the port serves:
    the one-shot decode knobs and the ``StreamingEngine``'s slots, mode
    groups, paged cache, prefix reuse, overload policy and mesh."""

    mode: str = "speculative"        # greedy|speculative|beam|speculative_beam
    draft_len: int = 10              # the paper's best DL
    n_drafts: int = 25               # the paper's N_d cap
    n_beams: int = 5
    max_new: int = 96
    max_src: int = 128
    dilations: tuple[int, ...] = (1,)
    n_slots: int = 2                 # StreamingEngine decode slots
    # in-flight mode mixing (StreamingEngine): per-mode slot groups sharing
    # one cache/pool/step, e.g. {"greedy": 4, "speculative": 4, "beam": 2};
    # None = one group of ``mode`` x ``n_slots``
    mode_groups: dict[str, int] | tuple | None = None
    # paged KV cache (StreamingEngine): admission is gated on free pages
    paged: bool = False
    page_size: int = 16              # tokens per page
    n_pages: int | None = None       # pool size; None = worst case
    # model backend: "auto" routes on cfg.family (seq2seq -> monolithic
    # admission, a dense decoder-only LM -> chunked prefill), or name one:
    # "seq2seq" | "decoder_only"
    backend: str = "auto"
    # chunked ragged prefill (decoder-only): prompt tokens written per
    # scheduler iteration while a prompt streams into its slot's rows
    prefill_chunk: int = 32
    # decoder-only sessions have no chemistry tokenizer: special ids come
    # from here when StreamingEngine is built with tokenizer=None
    eos_id: int | None = None
    pad_id: int = 0
    # prefix reuse. seq2seq: an LRU of encoder outputs (cross-attention
    # K/V + mask) keyed by the source tokens, ``prefix_cache_entries`` of
    # them; paged decoder-only: the radix tree over committed prompt pages,
    # ``prefix_cache_pages`` retained pages (None = 2 x slots x a prompt's
    # worst-case pages)
    prefix_cache: bool = False
    prefix_cache_pages: int | None = None
    prefix_cache_entries: int = 128
    # priority aging, deadline-aware preemption, load shedding; None = off
    overload: OverloadPolicy | None = None
    # sharded serving (StreamingEngine): a ("data", "model") DeviceMesh
    # (repro_torch.launch.mesh.make_serving_mesh) over the world this rank
    # belongs to. Slots and page-pool segments split over "data", params
    # over "model"; tokens equal the unsharded engine's. None = one device.
    mesh: object | None = None

    def __post_init__(self):
        for name, lo in (("max_new", 1), ("max_src", 1), ("draft_len", 0),
                         ("n_drafts", 1), ("n_beams", 1), ("n_slots", 1),
                         ("prefill_chunk", 1), ("page_size", 1)):
            if getattr(self, name) < lo:
                raise ValueError(f"EngineConfig.{name}={getattr(self, name)} "
                                 f"must be >= {lo}")
        if self.prefix_cache_pages is not None and self.prefix_cache_pages < 1:
            raise ValueError(
                f"EngineConfig.prefix_cache_pages={self.prefix_cache_pages} "
                f"must be >= 1 (it is the radix cache's retained-page "
                f"capacity)")
        if self.prefix_cache_entries < 1:
            raise ValueError(
                f"EngineConfig.prefix_cache_entries="
                f"{self.prefix_cache_entries} must be >= 1")
        if self.n_pages is not None and self.n_pages < 2:
            raise ValueError(
                f"EngineConfig.n_pages={self.n_pages}: a paged pool needs at "
                f"least the reserved trash page plus one usable page")
        if self.mode not in MODES:
            raise ValueError(f"unknown decode mode {self.mode!r}")
        for mode, n in (dict(self.mode_groups) if self.mode_groups
                        else {}).items():
            if mode not in MODES:
                raise ValueError(f"unknown decode mode {mode!r}")
            if int(n) < 1:
                raise ValueError(f"mode group {mode!r} needs >= 1 slot, "
                                 f"got {n}")


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
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


class ReactionEngine:
    """Per-request engine: each call runs its batch to completion.

    ``device``: where the model runs; ``None`` means the card, and a missing
    card is an error. Pass ``device="cpu"`` to run the plain versions.
    ``predict`` / ``predict_topn`` run under ``torch.no_grad()``, so params
    that require grad (a trainer's) build no graph."""

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

    @torch.no_grad()
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

    @torch.no_grad()
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


_I32 = torch.int32


class _PlanInputs(NamedTuple):
    """A group's page-plan inputs for every slot (a mesh rank's view)."""
    pos: torch.Tensor      # (S, K)
    active: torch.Tensor   # (S,)


class StreamingEngine:
    """Continuous-batching engine: S decode slots in per-mode slot groups
    over one model cache (dense rows or a paged pool), one step per
    scheduler iteration.

    ``device``: where the model runs; ``None`` means the card, and a missing
    card is an error. Pass ``device="cpu"`` to run the plain versions.
    Every scheduler iteration (the one pump behind ``serve``, ``wait``,
    ``stream``, ``drain`` and ``predict``) runs under ``torch.no_grad()``,
    so params that require grad build no graph through the in-place cache
    writes; so do ``_cancel`` and ``begin_drain``, which evict slots
    outside the pump."""

    # terminal records kept for RequestHandle.result()/.status after their
    # serve() epoch: bounded, oldest insertions evict first
    _DONE_CAP = 4096

    def __init__(self, params, cfg: ModelConfig,
                 tokenizer: SmilesTokenizer | None = None,
                 engine_cfg: EngineConfig | None = None, *,
                 backend=None, device=None):
        self.ecfg = ecfg = engine_cfg or EngineConfig()
        # sharded serving: n_shards data shards each own a contiguous local
        # slot range of every group and a contiguous page-pool segment;
        # params shard over the mesh's model axis
        self.mesh = ecfg.mesh
        self.n_shards, self._shard, self._tp = 1, 0, None
        if self.mesh is not None:
            self._join_mesh(cfg)
        self.device = resolve_device(device)
        self.params = (_to(params, self.device) if self.mesh is None
                       else self._lay_out_params(params, cfg))
        self.cfg = cfg
        self.tok = tokenizer
        self.backend = backend or make_backend(cfg, ecfg, tokenizer)
        eos_id = tokenizer.eos_id if tokenizer is not None else ecfg.eos_id
        pad_id = tokenizer.pad_id if tokenizer is not None else ecfg.pad_id
        if eos_id is None:
            raise ValueError(
                "StreamingEngine built with tokenizer=None needs "
                "EngineConfig.eos_id so sequences can terminate")
        if ecfg.prefix_cache and self.backend.chunked and tr.recurrent(cfg):
            # the radix tree keeps attention pages only: a shared child
            # would skip the prefix's prefill and start its recurrent
            # state from zero (ROADMAP.md Queue 3)
            raise ValueError(
                f"{cfg.name}: prefix_cache shares attention pages only, and "
                f"layer_pattern {cfg.layer_pattern} holds recurrent "
                f"positions whose state a shared prefix would skip; serve "
                f"it with prefix_cache=False")
        # prefix reuse: the radix page tree on a paged decoder-only engine
        # (prompts live in pages), the encoder-output LRU on seq2seq (the
        # source IS the prefix); a dense decoder-only engine has nothing to
        # reuse (the JAX package's flag is a no-op there too)
        self._prefix_sharing = bool(ecfg.prefix_cache and ecfg.paged
                                    and self.backend.chunked)
        self._encode_reuse = bool(ecfg.prefix_cache
                                  and not self.backend.chunked)
        group_slots = (dict(ecfg.mode_groups) if ecfg.mode_groups
                       else {ecfg.mode: ecfg.n_slots})
        self._groups: dict[str, SessionSpec] = {}
        for mode, n_slots in group_slots.items():
            kind, K, N_d, DL = _mode_shape(ecfg, mode)
            self._groups[mode] = SessionSpec(
                n_slots=int(n_slots), n_beams=K, n_drafts=N_d, draft_len=DL,
                max_new=ecfg.max_new, eos_id=eos_id,
                pad_id=pad_id, kind=kind, n_stop=MAX_STOP_IDS)
        self.mode_names = list(self._groups)
        self.default_mode = (ecfg.mode if ecfg.mode in self._groups
                             else self.mode_names[0])
        self.spec = self._groups[self.default_mode]   # primary group
        # group g owns cache rows [row_lo[g], row_lo[g] + n_rows_g) and
        # global scheduler slots [slot_base[g], slot_base[g] + n_slots_g)
        self._row_lo, self._slot_base, self._slot_map = {}, {}, []
        rows = slots = 0
        for mode, spec in self._groups.items():
            self._row_lo[mode], self._slot_base[mode] = rows, slots
            self._slot_map += [(mode, i) for i in range(spec.n_slots)]
            rows += spec.n_rows
            slots += spec.n_slots
        self.n_rows, self.n_slots = rows, slots
        self.cache_len = max(self.backend.row_len(s)
                             for s in self._groups.values())
        # retained radix pages stay allocated through reserved INDEX ROWS
        # appended to the block table after the group rows: one (row,
        # block) cell per radix node holds the node's page id, so both page
        # planners see a live reference, and no decode lane reads the row
        self._n_index_rows = self._n_cells = 0
        if self._prefix_sharing:
            ps = ecfg.page_size
            # worst-case prompt pages of one slot (the alias / retain pad)
            self._prefix_pad = self.backend.prefill_blocks(ps)
            # matches are cut to whole multiples of lcm(page_size,
            # prefill_chunk) tokens, so the suffix prefill falls on the cold
            # run's chunk grid: the same chunk launches write the same K/V
            chunk = max(1, int(ecfg.prefill_chunk))
            self._align_pages = chunk // math.gcd(ps, chunk)
            self._table_blocks = -(-self.cache_len // ps)
            self._n_cells = (ecfg.prefix_cache_pages
                             if ecfg.prefix_cache_pages is not None
                             else 2 * self.n_slots * self._prefix_pad)
            self._n_index_rows = -(-self._n_cells // self._table_blocks)
        # shard maps: global slot -> data shard, table row -> data shard
        # (index rows stay on shard 0: their cells only pin pages, the page
        # plan never allocates for them). Shard s owns local slots [s*per,
        # (s+1)*per) of each group.
        self._shard_of_slot: dict[int, int] = {}
        self._row_shard: np.ndarray | None = None
        if self.n_shards > 1:
            rs = np.zeros((self.n_rows + self._n_index_rows,), np.int32)
            for mode, spec in self._groups.items():
                if spec.n_slots % self.n_shards:
                    raise ValueError(
                        f"mode group {mode!r}: n_slots={spec.n_slots} must "
                        f"divide evenly over the mesh's {self.n_shards} "
                        f"data shards")
                per = spec.n_slots // self.n_shards
                base, lo = self._slot_base[mode], self._row_lo[mode]
                for i in range(spec.n_slots):
                    sh = i // per
                    self._shard_of_slot[base + i] = sh
                    r0 = lo + i * spec.rows_per_slot
                    rs[r0:r0 + spec.rows_per_slot] = sh
            self._row_shard = rs
        if self.mesh is not None:
            self._local_geometry()
        # loop instrumentation: steps issued, per-iteration counts, and host
        # step gaps (seconds between consecutive bundle reads), bounded
        self.n_dispatches = 0
        self.n_host_reads = 0   # blocking device reads of the step path
        self._disp_mark = 0
        self._dispatch_samples: list[int] = []
        self._step_gaps: list[float] = []
        self.allocator: PageAllocator | None = None
        # request-level front door state: terminal records by rid, the
        # current serve() epoch's records, live stream cursors, and the
        # single step pump every blocking call drives
        self._done: dict[int, SlotResult] = {}
        self._epoch: dict[int, SlotResult] = {}
        self._streams: dict[int, dict] = {}
        self._pump = None
        self._pump_realtime = False
        self.scheduler = self._new_scheduler()

    # -- the mesh --------------------------------------------------------------
    def _join_mesh(self, cfg: ModelConfig) -> None:
        """Take this rank's place: its data shard, its model rank, and the
        groups it talks over (the model axis's for the layers'
        collectives, the data axis's for the MoE router's global counts,
        gloo groups for the host's). A mesh serves every family the
        unsharded engine serves; what that refuses, the backend refuses
        here too."""
        names = tuple(getattr(self.mesh, "mesh_dim_names", None) or ())
        if names != ("data", "model") or not hasattr(self.mesh, "get_group"):
            raise TypeError(
                "EngineConfig.mesh must be a ('data', 'model') DeviceMesh "
                "over the initialised world "
                "(repro_torch.launch.mesh.make_serving_mesh)")
        import torch.distributed as dist

        from repro_torch.launch.mesh import mesh_tensor_parallel
        from repro_torch.launch.world import host_group

        self._tp = mesh_tensor_parallel(self.mesh)
        self.n_shards, self._shard = self._tp.data_size, self._tp.data_rank
        self._data_host = host_group(self.mesh.get_group("data"))
        self._data_ranks = dist.get_process_group_ranks(
            self.mesh.get_group("data"))
        self._world_host = host_group(None)
        self.n_bundle_gathers = 0
        self.n_host_collectives = 0

    def _lay_out_params(self, params, cfg: ModelConfig) -> dict:
        """This rank's shard of every weight on the device, the split
        weights recorded in its ``TensorParallel``
        (``launch.shardings.lay_out_params``), and the widths this rank's
        cache holds (attention heads in ``_local_cfg``; Mamba's
        ``d_inner``, RWKV's and the cross-attention positions' heads in
        ``_local_widths``)."""
        from repro_torch.launch.shardings import (lay_out_params,
                                                  local_cache_cfg)

        out = lay_out_params(params, cfg, self.mesh, self._tp, self.device)
        # the cache holds this rank's heads and channels only
        self._local_cfg = local_cache_cfg(cfg, self._tp)
        self._local_widths = (tr.local_widths(out, cfg)
                              if "blocks" in out else None)
        return out

    def _local_geometry(self) -> None:
        """This rank's slots and rows: each group's local slots ``[d * per,
        (d + 1) * per)`` (state indices ``0 .. per``), their cache rows
        (the rank's cache holds only these, group by group), and those
        rows' places in the replicated block tables."""
        d = self._shard
        self._local_specs: dict[str, SessionSpec] = {}
        self._local_row_lo: dict[str, int] = {}
        rows, mine = 0, []
        for mode, spec in self._groups.items():
            per = spec.n_slots // self.n_shards
            self._local_specs[mode] = spec._replace(n_slots=per)
            self._local_row_lo[mode] = rows
            n = per * spec.rows_per_slot
            g0 = self._row_lo[mode] + d * n
            mine += range(g0, g0 + n)
            rows += n
        self._n_rows_local = rows
        self._my_rows = torch.as_tensor(mine, dtype=torch.long,
                                        device=self.device)

    def _here(self, mode: str, local: int):
        """``(state index, cache rows)`` of a group's local slot on this
        rank, or None when another data shard owns it."""
        if self.mesh is None:
            return local, self._slot_rows(mode, local)
        per = self._local_specs[mode].n_slots
        if local // per != self._shard:
            return None
        i = local % per
        rps = self._groups[mode].rows_per_slot
        lo = self._local_row_lo[mode] + i * rps
        return i, torch.arange(lo, lo + rps, device=self.device)

    def _state_spec(self, mode: str) -> SessionSpec:
        return (self._groups if self.mesh is None
                else self._local_specs)[mode]

    def _tables(self, state=None):
        """The cache whose paged nodes hold the block tables the page plan
        and the host edits read: the session's own (``state``'s, default
        the scheduler's), or on a mesh the replicated global tables."""
        if self.mesh is not None:
            return self._gtables
        return (self.scheduler.state if state is None else state).cache

    def _init_mesh_cache(self, paged):
        """This rank's cache: its rows only, its heads only, and (paged)
        its pool segment plus a trash page of its own; beside it the
        replicated global block tables and every slot's plan inputs."""
        lp = None if paged is None else (paged[0] // self.n_shards + 1,
                                         paged[1])
        cache = self.backend.init_cache(self._n_rows_local, self.cache_len,
                                        paged=lp, device=self.device,
                                        cfg=self._local_cfg,
                                        widths=self._local_widths)
        self._gtables = None
        if paged is not None:
            nb = paged_cache_entries(cache)[0].block_tables.shape[-1]
            self._pps = paged[0] // self.n_shards
            self._gtables = PagedKVCache(
                k_pool=None, v_pool=None, pos=None,
                block_tables=torch.full(
                    (1, self.n_rows + self._n_index_rows, nb), -1,
                    dtype=_I32, device=self.device))
            self._gpos = [torch.zeros((s.n_slots, s.n_beams), dtype=_I32,
                                      device=self.device)
                          for s in self._groups.values()]
            self._gact = [torch.zeros((s.n_slots,), dtype=torch.bool,
                                      device=self.device)
                          for s in self._groups.values()]
        return cache

    def _mirror_slot(self, mode: str, local: int, pos0=None) -> None:
        """Keep every slot's page-plan inputs on every rank: a slot goes
        live at ``pos0`` (None: it is released)."""
        if self.mesh is None or self._gtables is None:
            return
        gi = self.mode_names.index(mode)
        if pos0 is None:
            self._gact[gi][local] = False
        else:
            self._gpos[gi][local] = int(pos0)
            self._gact[gi][local] = True

    def _refresh_view(self, cache) -> None:
        """Point this rank's paged nodes at its rows of the global tables,
        in its segment's local page ids."""
        view = segment_pages(self._gtables.block_tables[0][self._my_rows],
                             self._shard, self._pps)
        for node in paged_cache_entries(cache):
            node.block_tables.copy_(view.expand_as(node.block_tables))

    def _host_all_gather(self, flat: np.ndarray) -> list[np.ndarray]:
        """One host all-gather of an int32 vector over the data axis."""
        import torch.distributed as dist

        t = torch.from_numpy(np.ascontiguousarray(flat, np.int32))
        out = [torch.empty_like(t) for _ in range(self.n_shards)]
        dist.all_gather(out, t, group=self._data_host)
        self.n_host_collectives += 1
        return [o.numpy() for o in out]

    def _owner_broadcast(self, slot: int, value):
        """``value`` as the rank of ``slot``'s data shard computed it (the
        ranks of other shards pass None)."""
        import torch.distributed as dist

        obj = [value]
        dist.broadcast_object_list(
            obj, src=self._data_ranks[self._shard_of_slot.get(slot, 0)],
            group=self._data_host)
        self.n_host_collectives += 1
        return obj[0]

    def _sync_clock(self, t: float) -> float:
        """Rank 0's serving clock on every rank (realtime drives)."""
        import torch.distributed as dist

        x = torch.tensor([t], dtype=torch.float64)
        dist.broadcast(x, src=0, group=self._world_host)
        self.n_host_collectives += 1
        return float(x[0])

    def _megastep_mesh(self, gstate, prefill=None):
        """``_megastep`` on a mesh rank: the page plan over the replicated
        tables and every slot's inputs (the same on every rank), applied to
        the global tables and this rank's segment; the chunk writes and
        the step over this rank's rows; then the bundle, read in one go
        and gathered over the data axis (``_gather_bundle``). The plan's
        counts are read with its flag: the rank's cache cannot count the
        other shards' pages after the step. Returns ``(gstate, host
        bundle)``."""
        n_out0 = self._slot_counts(gstate)
        plan = None
        if self.ecfg.paged:
            view = GroupedState(
                groups=tuple(_PlanInputs(p, a)
                             for p, a in zip(self._gpos, self._gact)),
                cache=self._gtables)
            shards = ((self.n_shards, self._row_shard)
                      if self.n_shards > 1 else None)
            dplan, flags = self._plan_pages(view, prefill, shards)
            G, n_sh = len(self._groups), self.n_shards
            plan = dict(n_free=int(flags[2]), need=flags[3:3 + G])
            if shards is not None:
                at = 3 + G
                plan.update(need_sh=flags[at:at + n_sh],
                            n_free_sh=flags[at + n_sh:at + 2 * n_sh],
                            exhausted_sh=flags[at + 2 * n_sh:].astype(bool))
            if flags[0]:
                return gstate, dict(
                    exhausted=True, n_free_alloc=plan["n_free"],
                    need=plan["need"],
                    **({"exhausted_sh": plan["exhausted_sh"]}
                       if shards is not None else {}))
            apply_page_plan_segment(self._gtables, gstate.cache, dplan,
                                    self._shard, self._pps, int(flags[1]))
            self._refresh_view(gstate.cache)
        self._write_chunks(gstate, prefill)
        handle = self.backend.step_handle(self.params)
        gstate = grouped_step(tuple(self._local_specs.values()), handle,
                              gstate)
        return gstate, self._gather_bundle(gstate, n_out0, plan)

    def _gather_bundle(self, gstate, n_out0, plan) -> dict:
        """The step's bundle on the host, every slot's: this rank's slots'
        counters (and, paged, their positions and rows' tables) read in one
        go, gathered over the data axis in one host collective, and laid
        out in global slot and row order. Paged: the gathered rows go back
        into the replicated tables (and positions into the plan inputs),
        and the free counts and prompt pages are counted from them on the
        host: a rank's cache holds only its own rows, so
        ``_make_bundle``'s device counts would miss the other shards'."""
        lspecs = list(self._local_specs.values())
        b = self._make_bundle(gstate, n_out0, None, specs=lspecs)
        del b["exhausted"]
        keys = ["finished", "n_out", "n_new", "delta"]
        units = {"finished": [1] * len(lspecs), "n_out": [1] * len(lspecs),
                 "n_new": [1] * len(lspecs),
                 "delta": [b["delta"].shape[1]] * len(lspecs)}
        if plan is not None:
            nb = self._gtables.block_tables.shape[-1]
            b["pos"] = torch.cat([gs.pos.reshape(-1) for gs in gstate.groups])
            node = paged_cache_entries(gstate.cache)[0]
            b["tables"] = global_pages(node.block_tables[0], self._shard,
                                       self._pps)
            b["index_rows"] = self._gtables.block_tables[0, self.n_rows:]
            keys += ["pos", "tables"]
            units.update(pos=[s.n_beams for s in lspecs],
                         tables=[s.rows_per_slot * nb for s in lspecs])
        local = self._read_bundle(b)
        flat = np.concatenate([np.asarray(local[k], np.int32).reshape(-1)
                               for k in keys])
        parts = self._host_all_gather(flat)
        self.n_bundle_gathers += 1
        out = {}
        at = 0
        for k in keys:
            n = int(np.asarray(local[k]).size)
            pieces = [p[at:at + n] for p in parts]
            at += n
            whole, lo = [], 0
            for spec, u in zip(lspecs, units[k]):
                m = spec.n_slots * u
                whole += [p[lo:lo + m] for p in pieces]
                lo += m
            out[k] = np.concatenate(whole)
        S = self.n_slots
        out["finished"] = out["finished"].astype(bool)
        out["delta"] = out["delta"].reshape(S, -1)
        out["exhausted"] = False
        if plan is None:
            return out
        n_pages, _ = self._paged_geometry()
        full = np.concatenate([out.pop("tables").reshape(self.n_rows, -1),
                               np.asarray(local["index_rows"], np.int32)])
        self._gtables.block_tables[0].copy_(torch.from_numpy(full))
        pos, lo = out.pop("pos"), 0
        for g, spec in enumerate(self._groups.values()):
            n = spec.n_slots * spec.n_beams
            self._gpos[g].copy_(torch.from_numpy(
                pos[lo:lo + n].reshape(spec.n_slots, spec.n_beams)))
            lo += n
        refs = np.bincount(full[full >= 0].ravel(), minlength=n_pages)
        free = refs == 0
        free[0] = False
        spent = plan["need"].sum()
        out.update(n_free_alloc=plan["n_free"] - int(spent),
                   n_free_final=int(free.sum()), need=plan["need"])
        if "need_sh" in plan:
            out.update(
                need_sh=plan["need_sh"],
                n_free_alloc_sh=plan["n_free_sh"] - plan["need_sh"],
                n_free_final_sh=free.reshape(self.n_shards, -1).sum(1),
                exhausted_sh=plan["exhausted_sh"])
        if self._prefix_sharing:
            out["row0_pages"] = full[np.asarray(
                [self._slot_row_range(s)[0] for s in range(self.n_slots)]),
                :self._prefix_pad]
        return out

    # -- the step ----------------------------------------------------------
    def _megastep(self, gstate, prefill=None):
        """One scheduler iteration on the card: (paged) plan the page
        maintenance on the device, read its exhaustion flag, and — unless
        the pool is exhausted, in which case nothing is applied so the host
        can preempt and replay the iteration exactly — apply the plan,
        write this iteration's prefill chunks (``prefill``: per group
        ``(tokens, pos0, n_valid)``, or None) and run the grouped decode
        step. Returns ``(gstate, bundle)``: the bundle holds everything the
        host reads afterwards."""
        n_out0 = self._slot_counts(gstate)
        plan = None
        if self.ecfg.paged:
            plan, flags = self._plan_pages(gstate, prefill)
            if flags[0]:
                return gstate, dict(exhausted=plan.exhausted,
                                    n_free_alloc=plan.n_free,
                                    need=plan.need_by_group)
            apply_page_plan(gstate.cache, plan, int(flags[1]))
        self._write_chunks(gstate, prefill)
        handle = self.backend.step_handle(self.params)
        gstate = grouped_step(tuple(self._groups.values()), handle, gstate)
        return gstate, self._make_bundle(gstate, n_out0, plan)

    def _plan_pages(self, view, prefill, shards=None):
        """This iteration's device page plan over ``view`` (the session's
        state; on a mesh the replicated tables and every slot's inputs, so
        every rank plans the same), then ONE device read of its exhaustion
        flag and the number of pages to copy (on a mesh rank: into its
        own segment, followed by the plan's free and needed counts, and
        per shard with ``shards``). Returns ``(plan, host int32 vector)``."""
        n_pages, ps = self._paged_geometry()
        blocks = tuple(self.allocator._blocks[m] for m in self.mode_names)
        plan_prefill = None
        if prefill is not None:
            C = max(1, int(self.ecfg.prefill_chunk))
            plan_prefill = tuple(
                (self._chunk_rows0(m), pos0, n_valid, C)
                for m, (_, pos0, n_valid) in zip(self.mode_names, prefill))
        plan = device_page_plan(tuple(self._groups.values()), blocks, ps,
                                n_pages, view, prefill=plan_prefill,
                                shards=shards)
        if self.mesh is None:
            head = [plan.exhausted.to(_I32), plan.copy.sum(dtype=_I32)]
        else:
            mine = (plan.need & plan.copy
                    & (segment_pages(plan.new, self._shard, self._pps) > 0))
            head = [plan.exhausted.to(_I32), mine.sum(dtype=_I32),
                    plan.n_free.to(_I32), plan.need_by_group.to(_I32)]
            if shards is not None:
                head += [plan.need_by_shard, plan.n_free_by_shard,
                         plan.exhausted_by_shard.to(_I32)]
        flags = torch.cat([t.reshape(-1) for t in head]).cpu().numpy()
        self.n_host_reads += 1
        return plan, flags

    def _chunk_rows0(self, mode: str) -> list[int]:
        """Slot-leading cache rows of ``mode``'s group (row 0 of each slot,
        the row a chunked prefill writes)."""
        spec = self._groups[mode]
        lo = self._row_lo[mode]
        return [lo + i * spec.rows_per_slot for i in range(spec.n_slots)]

    def _lane_rows(self, mode: str) -> tuple[list[int], slice]:
        """The chunk lanes of ``mode``'s group this engine writes: their
        slots' row-0 cache rows and the lanes' slice of the group (on a
        mesh rank, its own slots, into its own rows)."""
        if self.mesh is None:
            return self._chunk_rows0(mode), slice(None)
        spec = self._local_specs[mode]
        per, lo = spec.n_slots, self._local_row_lo[mode]
        return ([lo + i * spec.rows_per_slot for i in range(per)],
                slice(self._shard * per, (self._shard + 1) * per))

    def _write_chunks(self, gstate, prefill) -> None:
        """Write the staged prefill chunk lanes of every group, in place
        (idle lanes are ``n_valid == 0`` and write nothing readable)."""
        if prefill is None:
            return
        for mode, (tokens, pos0, n_valid) in zip(self.mode_names, prefill):
            rows, mine = self._lane_rows(mode)
            self.backend.prefill_chunks_cache(
                self.params, gstate.cache, rows, tokens[mine], pos0[mine],
                n_valid[mine])

    def _slot_counts(self, gstate) -> torch.Tensor:
        """(n_slots,) committed-token counts on each slot's row 0, global
        slot order (groups are slot-contiguous in declaration order)."""
        return torch.cat([gs.n_out[:, 0] for gs in gstate.groups])

    def _make_bundle(self, gstate, n_out0, plan, specs=None) -> dict:
        """The step's host bundle: small fixed-shape tensors (the readback
        is O(n_slots), never the session state). ``specs``: the groups of
        ``gstate`` (a mesh rank's own slots), default the engine's."""
        specs = list(self._groups.values()) if specs is None else specs
        maxW = max([s.draft_len + 1 for s in specs if s.kind == "greedy"],
                   default=1)
        finished = torch.cat([gs.finished.all(dim=1) for gs in gstate.groups])
        n_out1 = self._slot_counts(gstate)
        n_new = n_out1 - n_out0
        w = torch.arange(maxW, dtype=_I32, device=n_new.device)
        deltas, lo = [], 0
        for spec, gs in zip(specs, gstate.groups):
            S = spec.n_slots
            if spec.kind == "greedy":
                idx = (n_out0[lo:lo + S, None] + w[None, :]).clamp(
                    0, spec.max_new - 1)
                tok = gs.tokens[:, 0].gather(1, idx.long())
                d = torch.where(w[None, :] < n_new[lo:lo + S, None], tok, 0)
            else:
                # beams reorder mid-flight: only terminal reads are truthful
                d = torch.zeros((S, maxW), dtype=_I32, device=w.device)
            deltas.append(d)
            lo += S
        bundle = dict(finished=finished, n_out=n_out1, n_new=n_new,
                      delta=torch.cat(deltas, dim=0),
                      exhausted=torch.zeros((), dtype=_I32, device=w.device))
        if plan is not None:
            n_pages, _ = self._paged_geometry()
            bundle.update(
                # free pages right after allocation (the peak-usage feed)
                n_free_alloc=plan.n_free - plan.need_by_group.sum(),
                # recounted after the step: winner sync / beam reorder
                # orphan pages inside it, and the mirror must see them free
                n_free_final=device_free_pages(gstate.cache, n_pages),
                need=plan.need_by_group)
            if self._prefix_sharing:
                # every slot's leading row-0 blocks after the step: the
                # host reads a finished prefill's committed prompt pages
                # from here to insert them into the radix tree (no read of
                # its own)
                bundle["row0_pages"] = read_row_pages(
                    gstate.cache, self._rows0, self._prefix_pad)
        return bundle

    def _read_bundle(self, bundle: dict) -> dict:
        """The bundle on the host in ONE device read: every tensor is
        packed into one int32 vector and split again here."""
        self.n_host_reads += 1
        keys = list(bundle)
        flat = torch.cat([bundle[k].reshape(-1).to(_I32) for k in keys])
        host = flat.cpu().numpy()
        out, at = {}, 0
        for k in keys:
            t = bundle[k]
            n = t.numel()
            a = host[at:at + n].reshape(tuple(t.shape))
            out[k] = a.astype(bool) if t.dtype == torch.bool else a
            at += n
        return out

    # -- admission / eviction ----------------------------------------------
    def _slot_rows(self, mode: str, local: int) -> torch.Tensor:
        spec = self._groups[mode]
        lo = self._row_lo[mode] + local * spec.rows_per_slot
        return torch.arange(lo, lo + spec.rows_per_slot, device=self.device)

    def _admit(self, gstate, mode: str, local: int, req):
        """Admit ``req`` into local slot ``local`` of ``mode``'s group, in
        place: encode the query, scatter its cross-attn K/V + memory mask
        into the slot's rows (recycling their self-attn rows), and reset the
        slot's decode state. On a mesh every rank unmaps the slot's rows in
        the replicated tables and marks the slot live for the page plan;
        only the owning shard's ranks encode and write."""
        be = self.backend
        if self.mesh is not None and self.ecfg.paged:
            unmap_cache_rows(self._gtables, self._slot_rows(mode, local))
        self._mirror_slot(mode, local, pos0=0)
        here = self._here(mode, local)
        if here is None:
            return gstate
        i, rows = here
        gi = self.mode_names.index(mode)
        args = tuple(a.to(self.device) for a in req.args)
        if self._encode_reuse:   # seq2seq: the whole source is the prefix
            mkv, mask = self._encode_cached(req.prompt, args[0])
            be.admit_cache_precomputed(self.params, gstate.cache, rows, mkv,
                                       mask)
        else:
            be.admit_cache(self.params, gstate.cache, rows, *args)
        last, pos0, drafts, dmask = be.reset_args(*args)
        max_out, stop_ids, eff_dl, eff_beams = req.gen
        reset_slot(self._state_spec(mode), gstate.groups[gi], i, last, pos0,
                   drafts, dmask, max_out=max_out, stop_ids=stop_ids,
                   eff_dl=eff_dl, eff_beams=eff_beams)
        return gstate

    def _encode_cached(self, prompt: np.ndarray, src: torch.Tensor):
        """The encoder leg of an admission through the encoder-output LRU,
        keyed by the source's token bytes: a hit skips the encoder."""
        key = np.asarray(prompt, np.int32).tobytes()
        c = self._prefix_counters
        c["lookups"] += 1
        c["lookup_tokens"] += int(np.size(prompt))
        ent = self._encode_lru.pop(key, None)
        if ent is None:
            ent = self.backend.encode_kv(self.params, src)
            self.n_dispatches += 1
        else:
            c["hit_tokens"] += int(np.size(prompt))
        self._encode_lru[key] = ent
        while len(self._encode_lru) > self.ecfg.prefix_cache_entries:
            self._encode_lru.popitem(last=False)
        return ent

    def _finish(self, gstate, mode: str, local: int, req):
        """A slot's prompt is written: its other rows adopt row 0's context
        (dense: a copy; paged: the block table) and the slot goes live."""
        be = self.backend
        last, pos0, drafts, dmask = be.reset_args(*req.args)
        if self.mesh is not None and self.ecfg.paged:
            be.finish_cache(self._gtables, self._slot_rows(mode, local))
        self._mirror_slot(mode, local, pos0=pos0)
        here = self._here(mode, local)
        if here is None:
            return gstate
        i, rows = here
        gi = self.mode_names.index(mode)
        be.finish_cache(gstate.cache, rows)
        max_out, stop_ids, eff_dl, eff_beams = req.gen
        reset_slot(self._state_spec(mode), gstate.groups[gi], i, last, pos0,
                   drafts, dmask, max_out=max_out, stop_ids=stop_ids,
                   eff_dl=eff_dl, eff_beams=eff_beams)
        return gstate

    def _release(self, gstate, mode: str, local: int):
        """Evict a local slot of ``mode``'s group, in place, and (paged)
        unmap its rows so the page planners see its pages free."""
        if self.ecfg.paged:
            unmap_cache_rows(gstate.cache if self.mesh is None
                             else self._gtables,
                             self._slot_rows(mode, local))
        self._mirror_slot(mode, local)
        here = self._here(mode, local)
        if here is not None:
            release_slot(gstate.groups[self.mode_names.index(mode)], here[0])
        return gstate

    def _slot_of(self, slot: int) -> tuple[str, int]:
        """Global scheduler slot -> (mode, local slot in its group)."""
        return self._slot_map[slot]

    def _paged_geometry(self) -> tuple[int, int]:
        """(n_pages, page_size); the default pool is the worst case for all
        rows of all groups (the paged layout with no oversubscription). Set
        ``n_pages`` lower to oversubscribe (admission then defers on pool
        pressure)."""
        ecfg = self.ecfg
        if self.cfg.sliding_window:
            raise NotImplementedError(
                "paged serving sessions require sliding_window == 0: the "
                "page allocator maps a linear block space, not the window's "
                "block ring")
        if not self.backend.pageable():
            raise ValueError(
                f"{self.cfg.name}: backend has nothing to page — serve dense")
        ps = ecfg.page_size
        if ecfg.n_pages is not None:
            if ecfg.n_pages % self.n_shards:
                raise ValueError(
                    f"EngineConfig.n_pages={ecfg.n_pages} must divide into "
                    f"{self.n_shards} equal per-shard pool segments")
            return ecfg.n_pages, ps
        worst = sum(s.n_rows * (-(-self.backend.row_len(s) // ps))
                    for s in self._groups.values())
        # prefix sharing retains up to n_cells pages beyond the rows' worst
        # case, so the default pool grows by that many; sharded, it rounds
        # up to equal segments (the trash page sits in shard 0's)
        n_pages = worst + self._n_cells + 1
        return self.n_shards * (-(-n_pages // self.n_shards)), ps

    def _finished_mask(self, gstate) -> np.ndarray:
        """(n_slots,) bool by global slot id. Mid-prefill slots are never
        finished: their state is still the released one. (The scheduler
        reads the bundle's mask instead; on a mesh only that one holds
        every slot.)"""
        if self.mesh is not None:
            raise RuntimeError("a mesh engine's finished mask comes from "
                               "its gathered bundle")
        mask = torch.cat([gs.finished.all(dim=1)
                          for gs in gstate.groups]).cpu().numpy()
        for slot in self._prefilling:
            mask[slot] = False
        return mask

    def _slot_row_range(self, slot: int) -> range:
        """Cache rows of a global slot (row 0 first)."""
        mode, local = self._slot_of(slot)
        rps = self._groups[mode].rows_per_slot
        lo = self._row_lo[mode] + local * rps
        return range(lo, lo + rps)

    def _stage_chunks(self):
        """This iteration's prefill chunk lanes from the mid-prefill
        cursors: per group ``(tokens (S_g, C), pos0 (S_g,), n_valid
        (S_g,))`` on the device, covering every slot (idle lanes have
        ``n_valid == 0``), and the staged slots; None when no prompt is
        mid-stream. One chunk per slot per iteration. The cursor lives on
        the host record, not the request, so a preempted request requeues
        with its whole chunk plan and replays it."""
        staged = [s for s in sorted(self._prefilling)
                  if self._prefilling[s]["next"]
                  < len(self._prefilling[s]["chunks"])]
        if not staged:
            return None, []
        C = max(1, int(self.ecfg.prefill_chunk))
        lanes = {m: (np.zeros((spec.n_slots, C), np.int32),
                     np.zeros((spec.n_slots,), np.int32),
                     np.zeros((spec.n_slots,), np.int32))
                 for m, spec in self._groups.items()}
        for slot in staged:
            rec = self._prefilling[slot]
            toks, pos0, nval = lanes[rec["mode"]]
            local = slot - self._slot_base[rec["mode"]]
            toks[local], pos0[local], nval[local] = \
                rec["chunks"][rec["next"]]
        prefill = tuple(tuple(torch.from_numpy(a).to(self.device)
                              for a in lanes[m]) for m in self.mode_names)
        return prefill, staged

    # -- dispatch-ahead drive hooks ------------------------------------------
    def _dispatch_step(self, state):
        """Scheduler ``dispatch`` hook: run ONE megastep and snapshot who it
        ran for (resident rids). The step's kernels stay queued on the
        card's stream while the host goes on to the next iteration's expiry
        and admissions."""
        prefill, staged = (self._stage_chunks() if self.backend.chunked
                           else (None, []))
        self._staged_slots = staged
        self._dispatch_rids = {s: r.rid
                               for s, r in self.scheduler._resident.items()}
        self._dispatch_prefilling = set(self._prefilling)
        if self.mesh is None:
            state, bundle = self._megastep(state, prefill)
        else:
            with shard_ctx.tensor_parallel(self._tp):
                state, bundle = self._megastep_mesh(state, prefill)
        self._n_dispatched += 1
        self.n_dispatches += 1
        self._bundle = bundle
        return state

    def _sync_step(self) -> dict:
        """Scheduler ``sync`` hook: read the megastep's bundle (the
        iteration's second and last device read), then advance the prefill
        cursors and activate the slots whose prompt is now written, refresh
        the mirrored page counters, stash the stream deltas, and build the
        eviction mask (guarded by the dispatch-time rid snapshot, so a slot
        recycled since the dispatch is never evicted by a stale mask). On a
        mesh the bundle was read and gathered in the dispatch already."""
        out = (self._bundle if self.mesh is not None
               else self._read_bundle(self._bundle))
        t = time.perf_counter()
        if self._last_sync_t is not None:
            self._step_gaps.append(t - self._last_sync_t)
            if len(self._step_gaps) > 4096:
                del self._step_gaps[:2048]
        self._last_sync_t = t
        if bool(out["exhausted"]):
            # the step applied NOTHING: hint the scheduler at the first
            # group whose cumulative need overflows the pool
            n_free, run, prefer = int(out["n_free_alloc"]), 0, None
            for gi, m in enumerate(self.mode_names):
                run += int(out["need"][gi])
                if run > n_free:
                    prefer = m
                    break
            # sharded: the first shard that is actually short, so the
            # preemption and the replay stay inside it
            shard = None
            if "exhausted_sh" in out:
                ex = np.asarray(out["exhausted_sh"], bool)
                shard = int(np.argmax(ex)) if ex.any() else None
            return {"exhausted": True, "group": prefer, "shard": shard}
        self._dispatch_samples.append(self.n_dispatches - self._disp_mark)
        if len(self._dispatch_samples) > 4096:
            del self._dispatch_samples[:2048]
        self._disp_mark = self.n_dispatches
        for slot in self._staged_slots:     # the dispatched chunks are written
            rec = self._prefilling.get(slot)
            if rec is not None:
                rec["next"] += 1
                self.prefill_chunks_written += 1
        self._staged_slots = []
        for slot in sorted(self._dispatch_prefilling):
            rec = self._prefilling.get(slot)
            if rec is None or rec["next"] < len(rec["chunks"]):
                continue
            # prompt written: the siblings adopt row 0 and the slot goes
            # live for the next dispatch
            mode = rec["mode"]
            self._finish(self.scheduler.state, mode,
                         slot - self._slot_base[mode], rec["req"])
            self.n_dispatches += 1
            if self.radix is not None and rec["body"] is not None:
                # the prompt is committed: publish its full pages so later
                # requests can alias them
                self._radix_insert(slot, rec, out)
            del self._prefilling[slot]
            if self.allocator is not None:
                self.allocator.unpin_rows(self._slot_row_range(slot))
        if self.allocator is not None:
            self.allocator.peak_pages = max(
                self.allocator.peak_pages,
                (self.allocator.n_pages - 1) - int(out["n_free_alloc"]))
            self.pages_allocated += int(out["need"].sum())
            self._mirror_free = int(out["n_free_final"])
            if "n_free_final_sh" in out:
                self._mirror_free_sh = [int(x)
                                        for x in out["n_free_final_sh"]]
                self.allocator.note_peak(out["n_free_alloc_sh"])
            # bookings made before this bundle's dispatch are now visible
            # in the device counter; keep only the ones it cannot see yet
            self._booked = [b for b in self._booked
                            if b[0] >= self._n_dispatched]
        self._stream_bundle = dict(
            n_out=out["n_out"], n_new=out["n_new"], delta=out["delta"],
            # mid-prefill slots' session rows still hold the previous
            # occupant's counts: not this rid's tokens, never streamed
            rids={s: r for s, r in self._dispatch_rids.items()
                  if s not in self._dispatch_prefilling})
        self._log_row0(self._stream_bundle)
        mask = np.asarray(out["finished"], bool).copy()
        for slot in range(self.n_slots):
            sreq = self.scheduler._resident.get(slot)
            rid = self._dispatch_rids.get(slot)
            if rid is None or sreq is None or sreq.rid != rid:
                mask[slot] = False
        for slot in self._dispatch_prefilling:
            mask[slot] = False
        return {"exhausted": False, "finished": mask}

    def _mirror_recount(self) -> None:
        """Refresh the mirrored free counter straight from the device's
        block tables (a blocking read)."""
        n_pages, _ = self._paged_geometry()
        self.n_host_reads += 1
        self._mirror_free = int(device_free_pages(self._tables(), n_pages))
        if self.n_shards > 1:
            self.n_host_reads += 1
            self._mirror_free_sh = [
                int(x) for x in device_free_pages_by_shard(
                    self._tables(), n_pages, self.n_shards)]
        self._booked = [b for b in self._booked
                        if b[0] >= self._n_dispatched]

    def _mirror_admit_ok(self, state, mode) -> bool:
        """Paged admission gate on the MIRRORED free counter (last bundle)
        net of bookings the device has not seen yet: no device read in the
        steady state. Over-admission surfaces as the step's exhaustion flag
        and preempt-and-replay; a refusal first recounts from the device,
        since evictions between bundles free pages the mirror cannot see."""
        need = self.allocator.admit_pages_for(mode)
        if self._mirror_free - sum(b[-1] for b in self._booked) >= need:
            return True
        self._mirror_recount()
        # still short: retained prefix pages are reclaimable capacity;
        # evict LRU radix nodes (the tree only shrinks, so this ends) before
        # refusing the admission
        while (self._mirror_free - sum(b[-1] for b in self._booked) < need
               and self._radix_reclaim()):
            self._mirror_recount()
        return self._mirror_free - sum(b[-1] for b in self._booked) >= need

    def _new_scheduler(self) -> ContinuousScheduler:
        ecfg = self.ecfg
        paged = self._paged_geometry() if ecfg.paged else None
        # index rows ride after the group rows: block-table-only rows whose
        # cells pin retained radix pages (decode lanes never touch them)
        if self.mesh is None:
            cache = self.backend.init_cache(self.n_rows + self._n_index_rows,
                                            self.cache_len, paged=paged,
                                            device=self.device)
        else:
            cache = self._init_mesh_cache(paged)
        self._bundle = None
        self._stream_bundle = None
        # slot -> [rid, committed row-0 token arrays, count]: a late stream
        # subscriber's catch-up, kept from the gathered bundles
        self._row0_log: dict[int, list] = {}
        # chunked prefill: global slot -> {mode, req, chunks, next chunk};
        # the chunks and mid-prefill slots of the in-flight dispatch
        self._prefilling: dict[int, dict] = {}
        self._staged_slots: list[int] = []
        self._dispatch_prefilling: set[int] = set()
        self.prefill_chunks_written = 0
        self._dispatch_rids: dict[int, int] = {}
        self._booked: list[tuple] = []   # (dispatch stamp, shard, pages)
        self._n_dispatched = 0
        self._last_sync_t = None
        self._mirror_free_sh: list[int] = []
        self._admits_by_shard = [0] * self.n_shards
        # prefix reuse: the radix tree and each slot's acquired chain, the
        # encoder-output LRU and its counters, the lineage behind the
        # tree-of-requests API (rid -> query / parent / children / priority
        # / mode / radix nodes it inserted; bounded like _done)
        self.radix = (RadixPageCache(ecfg.page_size, self._n_cells)
                      if self._prefix_sharing else None)
        self._slot_chains: dict[int, list] = {}
        if self._prefix_sharing:
            self._rows0 = torch.as_tensor(
                [self._slot_row_range(s)[0] for s in range(self.n_slots)],
                dtype=torch.long, device=self.device)
        self._encode_lru: collections.OrderedDict = collections.OrderedDict()
        self._lineage: collections.OrderedDict = collections.OrderedDict()
        self._prefix_counters = {"lookups": 0, "hit_tokens": 0,
                                 "lookup_tokens": 0}
        self.pages_allocated = 0
        self.requests_admitted = 0

        def admit(state, slot, payload):
            mode, req = payload
            local = slot - self._slot_base[mode]
            shard = self._shard_of_slot.get(slot)
            self.requests_admitted += 1
            if self.allocator is not None:
                # book the admission's worst-case first-step pages against
                # the mirror (and its shard's) until a later bundle's free
                # count reflects it
                self._booked.append((self._n_dispatched, shard,
                                     self.allocator.admit_pages_for(mode)))
            if shard is not None:   # sharded slots only, as JAX counts
                self._admits_by_shard[shard] += 1
            self.n_dispatches += 1
            if not self.backend.chunked:
                with shard_ctx.tensor_parallel(self._tp):
                    return self._admit(state, mode, local, req)
            # chunked: recycle the rows now; the prompt streams into the
            # step's chunk lanes and the slot activates at the sync that
            # sees its last chunk written
            if self.mesh is None:
                self.backend.begin_cache(state.cache,
                                         self._slot_rows(mode, local))
            else:
                if self.ecfg.paged:
                    self.backend.begin_cache(self._gtables,
                                             self._slot_rows(mode, local))
                here = self._here(mode, local)
                if here is not None:
                    self.backend.begin_cache(state.cache, here[1])
            rec = {"mode": mode, "req": req, "next": 0, "chunks": req.chunks,
                   "depth0": 0, "body": None}
            if self.radix is not None and req.prompt is not None:
                self._admit_match_prefix(state, slot, rec)
            self._prefilling[slot] = rec
            if self.allocator is not None:
                self.allocator.pin_rows(self._slot_row_range(slot))
            return state

        def release(state, slot):
            mode, local = self._slot_of(slot)
            self._prefilling.pop(slot, None)   # preempted mid-prefill
            chain = self._slot_chains.pop(slot, None)
            if chain:
                # drop the slot's hold on its aliased prefix chain; the
                # nodes stay in the tree (LRU-evictable once inactive)
                self.radix.release(chain)
            if self.allocator is not None:
                self.allocator.unpin_rows(self._slot_row_range(slot))
            self.n_dispatches += 1
            return self._release(state, mode, local)

        def step(state):
            # only a hand-driven legacy loop calls this; the scheduler's
            # pipelined drive uses the dispatch/sync hooks
            state = self._dispatch_step(state)
            out = self._sync_step()
            if out.get("exhausted"):
                raise PoolExhausted("page pool exhausted",
                                    group=out.get("group"),
                                    shard=out.get("shard"))
            return state

        groups = {mode: list(range(base, base + self._groups[mode].n_slots))
                  for mode, base in self._slot_base.items()}
        hooks: dict = {"release": release, "groups": groups,
                       "finished": self._finished_mask,
                       "dispatch": self._dispatch_step,
                       "sync": self._sync_step}
        if self.n_shards > 1:
            # sharded: the engine picks the SLOT (and thereby the shard)
            # for every admission (prefix affinity first, least-loaded shard
            # otherwise) and pool-pressure preemption stays in the
            # exhausted shard
            hooks.update(place=self._place_slot,
                         shards=dict(self._shard_of_slot))
        if self.mesh is not None:
            hooks.update(sync_clock=self._sync_clock)
        if ecfg.paged:
            alloc_kw = dict(
                n_pages=paged[0], page_size=paged[1],
                row_lens={m: self.backend.row_len(s)
                          for m, s in self._groups.items()},
                prefill_blocks={m: self.backend.prefill_blocks(paged[1])
                                for m in self._groups})
            if self.n_shards > 1:
                self.allocator = ShardedPageAllocator(
                    self._groups, n_shards=self.n_shards, **alloc_kw)
                self._mirror_free_sh = [
                    self.allocator.shard_capacity(s)
                    for s in range(self.n_shards)]
            else:
                self.allocator = PageAllocator(self._groups, **alloc_kw)
            self._mirror_free = self.allocator.n_pages - 1
            hooks.update(admit_ok=self._mirror_admit_ok)
            if self._prefix_sharing:
                # the index rows' references must survive every reclaim
                self.allocator.pin_rows(
                    range(self.n_rows, self.n_rows + self._n_index_rows))
                hooks.update(reclaim=self._radix_reclaim)
        state = grouped_init_state(
            tuple((self._groups if self.mesh is None
                   else self._local_specs).values()), cache)
        return ContinuousScheduler(self.spec, state, admit=admit, step=step,
                                   policy=ecfg.overload, **hooks)

    # -- cross-request prefix sharing -----------------------------------------
    def _admit_match_prefix(self, state, slot: int, rec: dict) -> None:
        """Match an admitted prompt against the radix tree, alias the
        matched pages into the slot's row-0 block table and cut the chunk
        plan to the unmatched suffix. The match is cut to the chunk grid,
        so the suffix prefill replays the cold run's chunks."""
        ps = self.ecfg.page_size
        body = self.backend.prompt_body(rec["req"])
        rec["body"] = body
        chain = self.radix.match(body)
        if self.mesh is not None and self.n_shards > 1:
            # a rank reads only its own segment: cut the chain at its first
            # page from another shard (the rest is prefilled, as cold)
            sh = self._shard_of_slot[slot]
            cut = next((i for i, nd in enumerate(chain)
                        if self.allocator.shard_of_page(nd.page) != sh),
                       len(chain))
            chain_len = len(chain)
            chain = chain[:cut]
            self.radix.hit_tokens -= (chain_len - cut) * ps
        depth = (len(chain) // self._align_pages) * self._align_pages
        if depth < len(chain):
            # the hit-rate stats count what was aliased, not what matched
            self.radix.hit_tokens -= (len(chain) - depth) * ps
            chain = chain[:depth]
        if not chain:
            return
        alias_prefix_pages(self._tables(state), self._slot_row_range(slot)[0],
                           [nd.page for nd in chain])
        self.n_dispatches += 1
        self.radix.acquire(chain)
        self._slot_chains[slot] = chain
        rec["depth0"] = depth
        rec["chunks"] = self.backend.suffix_chunks(body, depth * ps)

    def _radix_insert(self, slot: int, rec: dict, out: dict) -> None:
        """A prompt has just been written: insert its full pages (the
        bundle's post-step row-0 tables) into the radix tree and write the
        new nodes' index cells, so the pages outlive the slot."""
        body = rec["body"]
        n_full = len(body) // self.ecfg.page_size
        if n_full <= 0:
            return
        pages = np.asarray(out["row0_pages"][slot][:n_full])
        if (pages <= 0).any():
            return   # an unmapped or trash block is never shared
        new = self.radix.insert(body[:n_full * self.ecfg.page_size], pages,
                                rec["depth0"])
        if not new:
            return
        sreq = self.scheduler._resident.get(slot)
        if sreq is not None:
            info = self._lineage.get(sreq.rid)
            if info is not None:
                info["nodes"].extend(new)
        self._write_cells([nd.cell for nd in new], [nd.page for nd in new])

    def _write_cells(self, cells: list, pages: list) -> None:
        """Write (cell -> page) index references."""
        rows, blocks = radix_cell_coords(self.n_rows, self._table_blocks,
                                         cells)
        write_index_cells(self._tables(), rows, blocks, pages)
        self.n_dispatches += 1

    def _clear_cells(self, pairs: list) -> None:
        """Clear evicted nodes' (cell, page) index references, so the pages
        fall out of the device refcount and return to the pool."""
        if not pairs:
            return
        rows, blocks = radix_cell_coords(self.n_rows, self._table_blocks,
                                         [c for c, _ in pairs])
        clear_index_cells(self._tables(), rows, blocks)
        self.n_dispatches += 1

    def _radix_reclaim(self, shard: int | None = None) -> bool:
        """Pool-pressure hook (the scheduler's ``reclaim``): evict LRU
        inactive radix nodes and clear their index cells. Tried before a
        resident is preempted: cached prefixes are cheaper to lose than
        live work. ``shard`` aims the eviction at one page-pool segment
        (the per-shard admission gate's relief valve)."""
        if self.radix is None or len(self.radix) == 0:
            return False
        where = (None if shard is None else
                 (lambda nd: self.allocator.shard_of_page(nd.page) == shard))
        pairs = self.radix.evict_lru(self._prefix_pad, where=where)
        if not pairs:
            return False
        self._clear_cells(pairs)
        return True

    # -- instrumentation -------------------------------------------------------
    def loop_stats(self) -> dict:
        """Host-loop instrumentation: total steps and admission/eviction
        calls issued (``n_dispatches``), calls per scheduler iteration
        (steady state == 1.0: the megastep alone), the step path's
        blocking device reads (``host_reads``: a paged iteration's plan
        flag and bundle, a dense one's bundle, a mirror recount), and the
        host step gap
        (seconds between consecutive bundle reads) p50/p95. On a mesh also
        this rank's bundle gathers, host collectives (gathers, owner
        broadcasts, clock broadcasts), model-axis collectives and
        data-axis ones (the MoE router's global counts)."""
        gaps = sorted(self._step_gaps)

        def pct(q):
            if not gaps:
                return 0.0
            return gaps[min(len(gaps) - 1, int(q * len(gaps)))]

        samples = self._dispatch_samples
        return {
            "n_dispatches": self.n_dispatches,
            "host_reads": self.n_host_reads,
            "n_iterations": len(samples),
            "dispatches_per_iteration": (sum(samples) / len(samples)
                                         if samples else 0.0),
            "steady_iterations_one_dispatch": sum(1 for s in samples
                                                  if s == 1),
            "step_gap_p50_s": pct(0.50),
            "step_gap_p95_s": pct(0.95),
            **({} if self.mesh is None else {
                "bundle_gathers": self.n_bundle_gathers,
                "host_collectives": self.n_host_collectives,
                "model_collectives": self._tp.n_collectives,
                "data_collectives": self._tp.n_data_collectives}),
        }

    # -- sharded placement ---------------------------------------------------
    def _shard_headroom(self, shard: int) -> int:
        """How much room shard ``shard`` has for new work: mirrored free
        pages net of unseen bookings (paged), or minus its resident count
        (dense: fewer residents, more room)."""
        if self.allocator is not None:
            booked = sum(b[-1] for b in self._booked if b[1] == shard)
            return self._mirror_free_sh[shard] - booked
        return -sum(1 for s in self.scheduler._resident
                    if self._shard_of_slot.get(s) == shard)

    def _shard_admit_ok(self, mode: str, shard: int) -> bool:
        """Per-shard ``_mirror_admit_ok``: can ``shard``'s segment cover one
        ``mode`` admission's worst-case first step? A refusal recounts from
        the device, then reclaims cached prefix pages FROM THIS SHARD
        before giving up."""
        need = self.allocator.admit_pages_for(mode)
        if self._shard_headroom(shard) >= need:
            return True
        self._mirror_recount()
        while (self._shard_headroom(shard) < need
               and self._radix_reclaim(shard)):
            self._mirror_recount()
        return self._shard_headroom(shard) >= need

    def _shard_order(self, mode: str, payload, avail: set) -> list[int]:
        """Shard preference for one admission: the shard holding the
        request's cached prefix pages first (the child decodes beside its
        parent's pages), then the rest by descending headroom
        (least-loaded), ties to the lowest shard id."""
        pref: list[int] = []
        req = payload[1]
        if self.radix is not None and req.prompt is not None:
            # a probe that moves neither the LRU clock nor the hit stats
            chain = self.radix.peek(self.backend.prompt_body(req))
            depth = (len(chain) // self._align_pages) * self._align_pages
            if depth > 0:
                sh = self.allocator.shard_of_page(chain[depth - 1].page)
                if sh in avail:
                    pref.append(sh)
        rest = sorted((s for s in avail if s not in pref),
                      key=lambda s: (-self._shard_headroom(s), s))
        return pref + rest

    def _place_slot(self, mode: str, free: list[int], payload):
        """Scheduler ``place`` hook (sharded engines): the slot, and so the
        data shard, for the group head's admission, or None to defer when
        no shard can cover it this iteration."""
        by_shard: dict[int, list[int]] = {}
        for s in free:
            by_shard.setdefault(self._shard_of_slot[s], []).append(s)
        for sh in self._shard_order(mode, payload, set(by_shard)):
            if self.allocator is None or self._shard_admit_ok(mode, sh):
                return min(by_shard[sh])
        return None

    def shard_stats(self) -> dict:
        """Per-shard balance counters (``GET /v1/stats`` reads them):
        admissions into each data shard's slots (an unsharded engine has no
        sharded slots and reports ``[0]``, as the JAX package's does), and
        on a sharded paged pool each segment's page peak and capacity."""
        out = {"n_shards": self.n_shards,
               "admitted_by_shard": list(self._admits_by_shard)}
        admits = self._admits_by_shard
        mean = sum(admits) / max(1, len(admits))
        out["admit_imbalance"] = (max(admits) / mean) if mean else 1.0
        if isinstance(self.allocator, ShardedPageAllocator):
            alloc = self.allocator
            out["peak_pages_by_shard"] = list(alloc.peak_pages_by_shard)
            out["shard_capacity"] = [alloc.shard_capacity(s)
                                     for s in range(self.n_shards)]
        return out

    def prefix_stats(self) -> dict:
        """Prefix-reuse counters: lookups of the radix tree (paged
        decoder-only) or the encoder-output LRU (seq2seq) and the prompt
        tokens they covered and hit, nodes or entries held, radix nodes
        inserted and evicted, pages allocated per admitted request.
        Cumulative over the session (``reset()`` starts them again)."""
        if self.radix is not None:
            rx = self.radix
            lookups, hit_t, look_t = (rx.lookups, rx.hit_tokens,
                                      rx.lookup_tokens)
            nodes, inserted, evicted = len(rx), rx.inserted, rx.evicted
        else:
            c = self._prefix_counters
            lookups, hit_t, look_t = (c["lookups"], c["hit_tokens"],
                                      c["lookup_tokens"])
            nodes = len(self._encode_lru)
            inserted = evicted = 0
        return {
            "lookups": int(lookups),
            "hit_tokens": int(hit_t),
            "lookup_tokens": int(look_t),
            "prefix_hit_rate": (hit_t / look_t) if look_t else 0.0,
            "nodes": int(nodes),
            "inserted": int(inserted),
            "evicted": int(evicted),
            "pages_allocated": int(self.pages_allocated),
            "requests_admitted": int(self.requests_admitted),
            "pages_per_request": (self.pages_allocated
                                  / self.requests_admitted
                                  if self.requests_admitted else 0.0),
        }

    def clear_prefix_cache(self) -> int:
        """Drop every inactive radix node (clearing its index cell) and the
        whole encoder-output LRU. Returns the number of radix nodes
        dropped (pages made reclaimable)."""
        self._encode_lru.clear()
        if self.radix is None:
            return 0
        pairs = self.radix.evict_lru(len(self.radix))
        self._clear_cells(pairs)
        return len(pairs)

    def cache_footprint(self) -> dict:
        """Self-attention cache accounting: ``capacity_bytes`` reserved up
        front, ``peak_bytes`` actually touched (paged: the page high-water
        mark), and ``contiguous_equiv_slots``: how many primary-group slots
        contiguous rows could fit in the same capacity."""
        spec = self.spec
        per_token = self.backend.per_token_bytes()
        row_bytes = self.backend.row_len(spec) * per_token
        if self.ecfg.paged:
            n_pages, ps = self._paged_geometry()
            page_bytes = ps * per_token
            alloc = self.allocator
            return {
                "kind": "paged", "page_size": ps, "n_pages": n_pages,
                "capacity_bytes": (n_pages - 1) * page_bytes,
                "peak_bytes": (alloc.peak_pages if alloc else 0) * page_bytes,
                "peak_pages": alloc.peak_pages if alloc else 0,
                # pages the radix tree holds through its index cells
                "retained_pages": len(self.radix) if self.radix else 0,
                "contiguous_equiv_slots":
                    ((n_pages - 1) * page_bytes)
                    // (spec.rows_per_slot * row_bytes),
            }
        cap = self.n_rows * self.cache_len * per_token
        return {"kind": "dense", "capacity_bytes": cap, "peak_bytes": cap,
                "contiguous_equiv_slots": self.n_slots}

    # -- request plumbing ----------------------------------------------------
    def _payload(self, query, mode: str,
                 params: GenerationParams | None = None):
        spec = self._groups[mode]
        rp = (params or GenerationParams()).resolve(spec)
        return (mode, self.backend.make_request(query, spec, rp))

    def _read_slot(self, state, slot: int) -> dict:
        """A finished slot's output on the host; on a mesh, read by its
        owning shard's ranks and broadcast over the data axis."""
        mode, local = self._slot_of(slot)
        here = self._here(mode, local)
        if self.mesh is None:
            return self._read_slot_here(state, slot, here[0])
        return self._owner_broadcast(
            slot, None if here is None else
            self._read_slot_here(state, slot, here[0]))

    def _read_slot_here(self, state, slot: int, local: int) -> dict:
        mode, _ = self._slot_of(slot)
        spec = self._groups[mode]
        gs = state.groups[self.mode_names.index(mode)]
        logp = gs.logp[local].cpu().numpy()
        order = (np.argsort(-logp, kind="stable") if spec.kind == "beam"
                 else np.arange(spec.n_beams))
        # per-request params trim the read-out to the request's own shape
        eff_k, eff_new = spec.n_beams, spec.max_new
        sreq = self.scheduler._resident.get(slot)
        if sreq is not None and sreq.payload[1].params is not None:
            rp = sreq.payload[1].params
            eff_k, eff_new = rp.n_beams, rp.max_new
        return dict(
            tokens=gs.tokens[local].cpu().numpy()[order][:eff_k, :eff_new],
            lengths=gs.n_out[local].cpu().numpy()[order][:eff_k],
            logprobs=logp[order][:eff_k],
            n_calls=int(gs.n_calls[local]),
            accepted=int(gs.accepted[local]),
        )

    def _prediction(self, r: SlotResult, wall_s: float) -> Prediction:
        smiles = [self.tok.decode(r.tokens[k])
                  for k in range(r.tokens.shape[0])]
        kind = self._groups[r.mode].kind if r.mode in self._groups else "greedy"
        logprobs = ([float(x) for x in r.logprobs]
                    if kind == "beam" else [0.0] * len(smiles))
        return Prediction(smiles=smiles, logprobs=logprobs,
                          n_calls=r.n_calls,
                          acceptance_rate=r.accepted / max(int(r.lengths[0]), 1),
                          wall_s=wall_s)

    # -- public API ----------------------------------------------------------
    def reset(self) -> None:
        """Drop all queued/resident requests and start a fresh session."""
        self.scheduler = self._new_scheduler()
        self._done, self._epoch, self._streams = {}, {}, {}
        self._pump = None
        self._pump_realtime = False
        self._dispatch_samples, self._step_gaps = [], []
        self._disp_mark = self.n_dispatches

    def submit_spec(self, rspec: RequestSpec) -> RequestHandle:
        """THE canonical entry point: enqueue one fully-specified
        ``RequestSpec`` and return its ``RequestHandle`` (an ``int`` — the
        request id — exposing ``.result()``/``.stream()``/``.cancel()``/
        ``.status``)."""
        mode = self.default_mode if rspec.mode is None else rspec.mode
        if mode not in self._groups:
            raise KeyError(f"engine serves {self.mode_names}, got {mode!r}")
        payload = self._payload(rspec.query, mode, rspec.params)
        rid = self.scheduler.submit(payload, arrival=rspec.arrival,
                                    mode=mode, priority=rspec.priority,
                                    deadline=rspec.deadline)
        # a shed submission landed a terminal record, not a queue entry:
        # store it now so handle.status is SHED at once
        for r in self.scheduler.drain_shed():
            self._finish_result(r)
        # lineage for submit_child / cancel_subtree, bounded like _done: an
        # aged-out parent can no longer be extended (a KeyError)
        q = rspec.query if isinstance(rspec.query, str) else \
            np.asarray(rspec.query, np.int32).reshape(-1).copy()
        self._lineage[rid] = {"query": q, "parent": None, "children": [],
                              "priority": rspec.priority, "mode": mode,
                              "nodes": []}
        while len(self._lineage) > self._DONE_CAP:
            self._lineage.popitem(last=False)
        return RequestHandle(rid, self, mode=mode, params=payload[1].params)

    def submit(self, query, *, arrival: float = 0.0,
               mode: str | None = None,
               params: GenerationParams | None = None,
               priority: int = 0,
               deadline: float | None = None) -> RequestHandle:
        """Sugar over ``submit_spec``. ``query`` is a SMILES string or a 1-D
        array of token ids; ``arrival`` delays admission (steps in
        closed-loop serve(), seconds in realtime serve()); ``mode`` routes
        the request to that slot group; ``params`` sets per-request
        generation knobs under the group's ceilings; higher ``priority``
        admits first among arrived requests; past its ``deadline`` (serving
        clock) the request expires instead of running."""
        return self.submit_spec(RequestSpec(
            query=query, params=params or GenerationParams(), mode=mode,
            priority=priority, deadline=deadline, arrival=arrival))

    # -- tree of requests (search-tree serving) -----------------------------
    def submit_child(self, parent, suffix, *, arrival: float = 0.0,
                     mode: str | None = None,
                     params: GenerationParams | None = None,
                     priority: int | None = None,
                     deadline: float | None = None) -> RequestHandle:
        """Submit a child whose query extends ``parent``'s (query +
        ``suffix``): the planning search's expansion step. Mode and
        priority default to the parent's (a subtree inherits its root's
        urgency). With prefix sharing on, the parent's committed prompt
        pages are served from the radix tree."""
        prid = int(parent)
        info = self._lineage.get(prid)
        if info is None:
            raise KeyError(
                f"parent request {prid} is unknown to this session "
                f"(reset(), or the bounded lineage store evicted it)")
        pq = info["query"]
        if isinstance(pq, str):
            if not isinstance(suffix, str):
                raise TypeError("parent query is a string; the child "
                                "suffix must be a string too")
            q = pq + suffix
        else:
            q = np.concatenate([np.asarray(pq, np.int32).reshape(-1),
                                np.asarray(suffix, np.int32).reshape(-1)])
        h = self.submit(q, arrival=arrival, mode=mode or info["mode"],
                        params=params,
                        priority=(info["priority"] if priority is None
                                  else priority),
                        deadline=deadline)
        self._lineage[int(h)]["parent"] = prid
        info["children"].append(int(h))
        return h

    def cancel_subtree(self, rid: int) -> int:
        """Cancel ``rid`` and every known descendant (a pruned search
        subtree), then drop the radix nodes those requests inserted: the
        cached page subtree returns to the pool, except nodes a live
        request outside the subtree still aliases. Returns the number newly
        cancelled."""
        order: list[int] = []
        stack, seen = [int(rid)], set()
        while stack:
            r = stack.pop()
            if r in seen:
                continue
            seen.add(r)
            order.append(r)
            info = self._lineage.get(r)
            if info is not None:
                stack.extend(info["children"])
        n = sum(1 for r in order if self._cancel(r))
        if self.radix is not None:
            pairs: list = []
            for r in order:
                info = self._lineage.get(r)
                if info is None:
                    continue
                for node in info["nodes"]:
                    # skip nodes already dropped (LRU eviction, or an
                    # ancestor handled earlier in ``order``)
                    if self.radix._nodes_by_cell.get(node.cell) is node:
                        pairs.extend(self.radix.drop_subtree(node))
                info["nodes"] = []
            self._clear_cells(pairs)
        return n

    # -- step pump: one drive shared by serve()/result()/stream() -----------
    def serve_steps(self, *, realtime: bool = False):
        """Step-driven serving: a generator yielding the list of terminal
        ``SlotResult``s after every scheduler iteration (often empty) until
        the queue drains — THE session's shared pump, the same drive that
        ``serve()`` and ``RequestHandle.result()``/``.stream()`` advance."""
        return self._ensure_pump(realtime=realtime)

    @torch.no_grad()   # every step of serve/wait/stream/drain/predict
    def _serve_steps_impl(self, realtime: bool):
        for events in self.scheduler.steps(self._read_slot,
                                           realtime=realtime):
            self._collect_streams()
            for r in events:
                self._finish_result(r)
            yield events

    def _ensure_pump(self, realtime: bool = False):
        if self._pump is None:
            self._pump = self._serve_steps_impl(realtime)
            self._pump_realtime = realtime
        return self._pump

    def _pump_once(self) -> bool:
        """Advance the shared pump one scheduler iteration; False once the
        queue is drained. A drained pump is disposed at once, so later work
        starts a fresh drive that picks its own clock mode."""
        pump = self._ensure_pump()
        try:
            next(pump)
        except StopIteration:
            self._pump = None
            return False
        if not self.scheduler.pending:
            self._pump = None
        return True

    def _finish_result(self, r: SlotResult) -> None:
        self._done[r.rid] = r
        self._epoch[r.rid] = r
        while len(self._done) > self._DONE_CAP:
            self._done.pop(next(iter(self._done)))
        while len(self._epoch) > self._DONE_CAP:
            self._epoch.pop(next(iter(self._epoch)))
        st = self._streams.get(r.rid)
        if st is not None and not st["done"]:
            self._flush_stream_tail(st, r)

    def _flush_stream_tail(self, st: dict, r: SlotResult) -> None:
        """Final stream chunk: greedy-family tails from the cursor; beam
        modes deliver the winning beam whole."""
        if r.status == RequestStatus.FINISHED and r.tokens.shape[0]:
            kind = self._groups[r.mode].kind if r.mode in self._groups \
                else "greedy"
            lo = st["n"] if kind == "greedy" else 0
            tail = np.asarray(r.tokens[0][lo:int(r.lengths[0])])
            if tail.size:
                st["buf"].append(tail)
        st["done"] = True

    def _collect_streams(self) -> None:
        """Deliver committed-token deltas to live ``stream()`` consumers from
        the LAST BUNDLE READ: greedy-family slots stream mid-flight with no
        extra device read; beam slots deliver at completion. A consumer
        that subscribed mid-flight catches up once from the session
        state."""
        live = {rid: st for rid, st in self._streams.items()
                if not st["done"]}
        sb = self._stream_bundle
        if not live or sb is None:
            return
        for slot, rid in sb["rids"].items():
            st = live.get(rid)
            if st is None:
                continue
            mode, local = self._slot_of(slot)
            if self._groups[mode].kind != "greedy":
                continue
            n_after = int(sb["n_out"][slot])
            n_new = int(sb["n_new"][slot])
            if n_after <= st["n"]:
                continue
            lo = st["n"] - (n_after - n_new)
            if lo >= 0:
                st["buf"].append(np.asarray(sb["delta"][slot, lo:n_new]))
                st["n"] = n_after
            elif not st.get("caught_up"):
                log = self._row0_log.get(slot)
                if log is not None and log[0] == rid and log[2] > st["n"]:
                    st["buf"].append(np.concatenate(log[1])[st["n"]:])
                    st["n"] = log[2]
                st["caught_up"] = True

    def _log_row0(self, sb: dict) -> None:
        """Append each greedy-family slot's committed row-0 delta to its
        host log (a late subscriber's catch-up): the tokens up to the
        bundle's count, with no device read and, on a mesh, no
        collective. A new occupant, or a replay from its first token,
        starts the slot's log afresh."""
        for slot, rid in sb["rids"].items():
            if self._groups[self._slot_of(slot)[0]].kind != "greedy":
                continue
            n_after, n_new = int(sb["n_out"][slot]), int(sb["n_new"][slot])
            log = self._row0_log.get(slot)
            if log is None or log[0] != rid or log[2] != n_after - n_new:
                if n_after != n_new:   # a gap: no log to catch up from
                    self._row0_log.pop(slot, None)
                    continue
                log = self._row0_log[slot] = [rid, [], 0]
            if n_new:
                log[1].append(np.array(sb["delta"][slot, :n_new]))
                log[2] = n_after

    # -- request-level control (the RequestHandle surface) -------------------
    def request_status(self, rid: int) -> RequestStatus:
        r = self._done.get(rid)
        if r is not None:
            return r.status
        if any(sr.rid == rid for sr in self.scheduler._resident.values()):
            return RequestStatus.RUNNING
        if rid in self.scheduler._queued_by_rid:
            return RequestStatus.QUEUED
        return RequestStatus.UNKNOWN

    def wait(self, rid: int) -> SlotResult:
        """Drive the pump until ``rid`` reaches a terminal record."""
        while rid not in self._done:
            if not self._pump_once() and rid not in self._done:
                raise KeyError(f"request {rid} is not part of this session "
                               f"(reset() drops pending requests)")
        return self._done[rid]

    def subscribe(self, rid: int) -> dict:
        """Attach a non-blocking stream sink to ``rid`` and return it: its
        ``buf`` fills with committed-token delta arrays as bundles are read,
        ``done`` flips when the terminal tail is flushed."""
        st = self._streams.get(rid)
        if st is None:
            st = self._streams[rid] = {"buf": [], "n": 0, "done": False}
            r = self._done.get(rid)
            if r is not None:      # finished before anyone listened
                self._flush_stream_tail(st, r)
        return st

    def unsubscribe(self, rid: int) -> None:
        self._streams.pop(rid, None)

    def _stream(self, rid: int):
        """Generator behind ``RequestHandle.stream()``."""
        st = self.subscribe(rid)
        try:
            while True:
                while st["buf"]:
                    yield st["buf"].pop(0)
                if st["done"]:
                    break
                if rid in self._done:   # terminal but tail not flushed
                    self._flush_stream_tail(st, self._done[rid])
                    continue
                if not self._pump_once() and rid not in self._done:
                    raise KeyError(f"request {rid} is not part of this "
                                   f"session")
        finally:
            self._streams.pop(rid, None)
        r = self._done[rid]
        if r.status != RequestStatus.FINISHED:
            if r.status in (RequestStatus.SHED, RequestStatus.EXPIRED):
                raise RequestRejected(rid, r.status,
                                      retry_after=r.retry_after)
            raise RequestCancelled(rid, r.status)

    def stream(self, rid: int):
        """Deprecated engine-level entry (as in the JAX package): use
        ``RequestHandle.stream()``."""
        warnings.warn(
            "StreamingEngine.stream(rid) is deprecated; call "
            ".stream() on the RequestHandle returned by submit()",
            DeprecationWarning, stacklevel=2)
        return self._stream(rid)

    @torch.no_grad()
    def _cancel(self, rid: int) -> bool:
        """Cancel a queued (dequeue) or resident (evict + reclaim pages)
        request. Returns False once the request is already terminal."""
        r = self.scheduler.cancel(rid)
        if r is None:
            return False
        self._finish_result(r)
        return True

    def cancel(self, rid: int) -> bool:
        """Deprecated engine-level entry (as in the JAX package): use
        ``RequestHandle.cancel()``."""
        warnings.warn(
            "StreamingEngine.cancel(rid) is deprecated; call "
            ".cancel() on the RequestHandle returned by submit()",
            DeprecationWarning, stacklevel=2)
        return self._cancel(rid)

    # -- graceful drain (shutdown path) --------------------------------------
    @property
    def draining(self) -> bool:
        return self.scheduler.draining

    @torch.no_grad()
    def begin_drain(self) -> int:
        """Enter drain mode without blocking: every queued request is shed
        with a retry hint, residents decode to completion, later
        submissions shed at once. Returns the number shed."""
        self.scheduler.draining = True
        shed = self.scheduler.shed_queued()
        for r in shed:
            self._finish_result(r)
        return len(shed)

    def drain(self) -> dict[int, SlotResult]:
        """Blocking graceful shutdown: ``begin_drain()`` + pump until the
        residents finish. Returns the epoch's terminal records."""
        self.begin_drain()
        while self._pump_once():
            pass
        out, self._epoch = self._epoch, {}
        return out

    def serve(self, *, realtime: bool = False) -> dict[int, SlotResult]:
        """Drain the queue with continuous batching; {rid: SlotResult} of
        every request that reached a terminal state since the last
        serve()."""
        if self._pump is not None and realtime != self._pump_realtime:
            raise RuntimeError(
                f"a {'realtime' if self._pump_realtime else 'closed-loop'} "
                f"drive is already in flight; serve(realtime={realtime}) "
                f"cannot switch clocks mid-drive — drain it first")
        self._ensure_pump(realtime=realtime)
        while self._pump_once():
            pass
        out, self._epoch = self._epoch, {}
        return out

    def _require_idle(self, caller: str) -> None:
        if self.scheduler.pending:
            raise RuntimeError(
                f"{caller} would drain {self.scheduler.pending} pending "
                f"submit()ed request(s); call serve() first")

    def predict(self, queries: Sequence[str]) -> list[Prediction]:
        """Drop-in for ``ReactionEngine.predict`` (greedy/speculative): a
        batch loop over the request front door."""
        if self.ecfg.mode not in ("greedy", "speculative"):
            raise ValueError(f"predict() supports greedy/speculative, "
                             f"got {self.ecfg.mode}")
        self._require_idle("predict()")
        t0 = time.perf_counter()
        handles = [self.submit(q) for q in queries]
        done = self.serve()
        wall = (time.perf_counter() - t0) / max(len(queries), 1)
        return [self._prediction(done[int(h)], wall) for h in handles]

    def predict_topn(self, query: str) -> Prediction:
        """Drop-in for ``ReactionEngine.predict_topn`` (beam modes): one
        query, n_beams candidates sorted by log-probability."""
        if self.spec.kind != "beam":
            raise ValueError(f"predict_topn() needs a beam mode, "
                             f"got {self.ecfg.mode}")
        self._require_idle("predict_topn()")
        t0 = time.perf_counter()
        handle = self.submit(query)
        done = self.serve()
        return self._prediction(done[int(handle)], time.perf_counter() - t0)
