"""DecodeSession — the fixed-slot decoding core every mode shares, the port
of ``repro.core.session``.

Every decoding mode (greedy, speculative greedy, beam, speculative beam) is
one step function over the same fixed-slot state: ``session_step`` runs ONE
verify/commit iteration for every slot. ``run_session`` drains the slots
with a host loop (one device-to-host read per iteration for its exit test)
where the JAX package runs a ``lax.while_loop``. The streaming engine
instead admits requests into freed slots between steps (``reset_slots`` /
``release_slot``), runs per-mode slot groups over one shared cache
(``GroupedState`` / ``grouped_step``) and, on a paged cache, plans page
maintenance on the device (``device_page_plan`` / ``apply_page_plan``) with
a host-side allocator for admission accounting (``PageAllocator``).

Unlike the JAX package, ``reset_slots``, ``release_slot``, the unmap helpers
and ``apply_page_plan`` update the state's tensors and the cache IN PLACE
(the engine threads one state linearly, so no copy is needed); the step
functions still return new state tensors.

Slot layout: ``n_slots`` (S) requests, each owning ``n_beams`` (K) beam rows
× ``n_drafts`` (N_d) draft rows of the model cache — cache row
``(s*K + k)*N_d + d``. Greedy-family modes are K=1; non-speculative modes are
N_d=1, DL=0.

On the greedy-family path the vocab argmax and the accepted-prefix match go
through the ``draft_verify`` kernel (its plain version on the CPU). The beam
step's argmax is over log-probs with the pad column masked, which is not
that kernel's function, so it stays plain torch.

JAX's ``.at[].set(mode="drop")`` drops out-of-range writes in silence; torch
raises, so the token writes scatter into one extra trash column, and the
page plan's scatters into one extra trash element, instead.
``jax.lax.top_k`` breaks ties toward the lower index and the candidate array
holds many exact -1e30 ties, so top-k here is a stable descending sort.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.handles import DecoderHandle
from repro_torch.core.tree_batch import (gather_rows, merge_rows, slice_rows,
                                         sync_winner)
from repro_torch.device import to_device
from repro_torch.kernels.draft_verify.ops import draft_verify
from repro_torch.models.attention import TRASH_PAGE, KVCache, PagedKVCache

_NEG = -1e30
_I32 = torch.int32


class SessionSpec(NamedTuple):
    """Static shape/mode bundle. The spec fixes the CEILINGS of its slots:
    every request admitted may use up to ``max_new`` tokens, ``n_beams``
    beams, ``n_drafts`` drafts of ``draft_len`` tokens and ``n_stop`` extra
    stop ids; per-request values below them ride in ``SessionState``
    tensors (``max_out``/``eff_dl``/``eff_beams``/``stop_ids``)."""

    n_slots: int                 # S — concurrent requests
    n_beams: int                 # K — rows per request (1 = greedy family)
    n_drafts: int                # N_d — drafts verified per row per step
    draft_len: int               # DL — tokens per draft
    max_new: int
    eos_id: int
    pad_id: int = 0
    kind: str = "greedy"         # "greedy" (argmax accept) | "beam" (top-k)
    n_stop: int = 0              # per-slot extra stop ids (0 = eos only)

    @property
    def rows_per_slot(self) -> int:
        return self.n_beams * self.n_drafts

    @property
    def n_rows(self) -> int:
        return self.n_slots * self.rows_per_slot

    @property
    def cache_len(self) -> int:
        """Minimum cache length: every step writes at pos .. pos+DL."""
        return self.max_new + self.draft_len + 2


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
    n_calls: torch.Tensor     # (S,) decoder forward passes while resident
    accepted: torch.Tensor    # (S,) committed draft tokens (beam-0 path)
    # per-request generation params (<= the spec's ceilings); values equal
    # to the ceilings make every consumer an algebraic no-op
    max_out: torch.Tensor     # (S,) per-slot token budget (<= spec.max_new)
    stop_ids: torch.Tensor    # (S, n_stop) extra stop ids, -1 = unused
    eff_dl: torch.Tensor      # (S,) effective draft length (<= DL)
    eff_beams: torch.Tensor   # (S,) effective beam width (<= K)
    cache: Any                # model cache, batch rows = S*K*N_d


def _cache_device(cache) -> torch.device:
    if isinstance(cache, dict):
        return _cache_device(next(iter(cache.values())))
    if isinstance(cache, (tuple, list)):
        return _cache_device(cache[0])
    if isinstance(cache, KVCache):
        return cache.k.device
    if isinstance(cache, PagedKVCache):
        return cache.k_pool.device
    return cache.device


def init_state(spec: SessionSpec, cache: Any, *, device=None) -> SessionState:
    """All slots free. ``cache`` must have ``spec.n_rows`` batch rows and
    length >= ``spec.cache_len``; with ``cache=None`` (a group of a grouped
    session) pass ``device``."""
    S, K = spec.n_slots, spec.n_beams
    kw = dict(device=device if cache is None else _cache_device(cache))
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
        n_calls=torch.zeros((S,), dtype=_I32, **kw),
        accepted=torch.zeros((S,), dtype=_I32, **kw),
        max_out=torch.full((S,), spec.max_new, dtype=_I32, **kw),
        stop_ids=torch.full((S, spec.n_stop), -1, dtype=_I32, **kw),
        eff_dl=torch.full((S,), spec.draft_len, dtype=_I32, **kw),
        eff_beams=torch.full((S,), spec.n_beams, dtype=_I32, **kw),
        cache=cache,
    )


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def reset_slots(spec: SessionSpec, state: SessionState, slots,
                last_token, start_pos, drafts, draft_mask, *,
                max_out=None, stop_ids=None, eff_dl=None,
                eff_beams=None) -> SessionState:
    """Prefill the algorithm state of several slots in place (the caller
    populates their model-cache rows). The per-slot values are host values:
    ``slots``, ``last_token``, ``start_pos`` and the optional ``max_out``,
    ``eff_dl``, ``eff_beams`` (n,), ``drafts`` (n, N_d, DL), ``draft_mask``
    (n, N_d), ``stop_ids`` (n, n_stop); the generation params default to
    the spec's ceilings. They are packed into one int32 array and moved to
    the device in one copy, then each field takes one indexed write, however
    many slots there are."""
    n, K = len(slots), spec.n_beams
    W = spec.n_drafts * spec.draft_len

    def col(x, default):
        return np.full((n,), default) if x is None else _host(x).reshape(n)

    stop = (np.full((n, spec.n_stop), -1) if stop_ids is None
            else _host(stop_ids).reshape(n, spec.n_stop))
    host = np.concatenate([
        np.stack([np.asarray(slots).reshape(n), col(last_token, 0),
                  col(start_pos, 0), col(max_out, spec.max_new),
                  col(eff_dl, spec.draft_len), col(eff_beams, K)], axis=1),
        _host(drafts).reshape(n, W), _host(draft_mask).reshape(n, -1),
        stop], axis=1).astype(np.int32)
    v = to_device(host, state.active.device)
    idx = v[:, 0].long()

    def per_beam(j):
        return v[:, j, None].expand(n, K)

    state.tokens.index_fill_(0, idx, spec.pad_id)
    state.logp.index_fill_(0, idx, _NEG)
    state.logp[:, 0].index_fill_(0, idx, 0.0)
    state.last.index_copy_(0, idx, per_beam(1))
    state.pos.index_copy_(0, idx, per_beam(2))
    state.n_out.index_fill_(0, idx, 0)
    state.finished.index_fill_(0, idx, False)
    state.active.index_fill_(0, idx, True)
    state.drafts.index_copy_(0, idx, v[:, 6:6 + W].reshape(
        n, spec.n_drafts, spec.draft_len))
    state.draft_mask.index_copy_(0, idx, v[:, 6 + W:6 + W + spec.n_drafts]
                                 != 0)
    state.n_calls.index_fill_(0, idx, 0)
    state.accepted.index_fill_(0, idx, 0)
    state.max_out.index_copy_(0, idx, v[:, 3])
    state.stop_ids.index_copy_(0, idx, v[:, 6 + W + spec.n_drafts:])
    state.eff_dl.index_copy_(0, idx, v[:, 4])
    state.eff_beams.index_copy_(0, idx, v[:, 5])
    return state


def reset_slot(spec: SessionSpec, state: SessionState, slot: int,
               last_token, start_pos, drafts, draft_mask, *,
               max_out=None, stop_ids=None, eff_dl=None,
               eff_beams=None) -> SessionState:
    """``reset_slots`` for one slot: ``drafts`` is (N_d, DL),
    ``draft_mask`` (N_d,), ``stop_ids`` (n_stop,)."""
    def one(x):
        return None if x is None else _host(x)[None]

    return reset_slots(spec, state, [slot], [last_token], [start_pos],
                       one(drafts), one(draft_mask), max_out=one(max_out),
                       stop_ids=one(stop_ids), eff_dl=one(eff_dl),
                       eff_beams=one(eff_beams))


def release_slot(state: SessionState, slot: int) -> SessionState:
    """Evict a finished request (in place); the slot's cache rows become
    garbage that the next admission overwrites."""
    state.active[slot] = False
    return state


def paged_cache_entries(cache) -> list[PagedKVCache]:
    """The ``PagedKVCache`` nodes of a model cache (the seq2seq cache has
    one, under "self"; the decoder-only cache one per attention pattern
    position), walked through its dicts and tuples."""
    if isinstance(cache, PagedKVCache):
        return [cache]
    if isinstance(cache, dict):
        cache = list(cache.values())
    if isinstance(cache, (tuple, list)):
        return [n for v in cache for n in paged_cache_entries(v)]
    return []


def unmap_cache_rows(cache, rows):
    """Unmap block-table ``rows`` of every paged node, in place. Stale writes
    by the now-inactive rows fall through the -1 entries into the trash
    page."""
    for node in paged_cache_entries(cache):
        idx = torch.as_tensor(rows, dtype=torch.long).to(
            node.block_tables.device)
        node.block_tables[:, idx] = -1
    return cache


def unmap_slot_pages(spec: SessionSpec, state: SessionState,
                     slot: int) -> SessionState:
    """Unmap a slot's block-table rows (paged caches). Once unmapped, the
    page planners see its pages as free: an eviction or preemption frees
    the slot's whole footprint at once."""
    rows = slot * spec.rows_per_slot + np.arange(spec.rows_per_slot)
    unmap_cache_rows(state.cache, rows)
    return state


# ---------------------------------------------------------------------------
# grouped sessions: per-mode slot groups sharing one cache and one step


class GroupedState(NamedTuple):
    """Session state partitioned into per-mode slot groups. ``groups[g]`` is
    a ``SessionState`` for group ``g``'s slots with ``cache=None``; the
    model cache is held ONCE here, covering every group's rows (one paged
    pool or one dense row block). Group ``g`` owns the contiguous cache rows
    ``[offset_g, offset_g + specs[g].n_rows)`` in declaration order."""

    groups: tuple            # per-group SessionState (cache=None)
    cache: Any               # shared model cache over all groups' rows


def group_row_offsets(specs) -> list[int]:
    """Starting cache row of each group (+ total) in declaration order."""
    offs = [0]
    for spec in specs:
        offs.append(offs[-1] + spec.n_rows)
    return offs


def grouped_init_state(specs, cache) -> GroupedState:
    """All slots of all groups free. ``cache`` must have
    ``group_row_offsets(specs)[-1]`` batch rows and length >= the largest
    group's ``cache_len``."""
    dev = _cache_device(cache)
    return GroupedState(
        groups=tuple(init_state(spec, None, device=dev) for spec in specs),
        cache=cache)


def grouped_step(specs, handle: DecoderHandle,
                 gstate: GroupedState) -> GroupedState:
    """ONE decode iteration for every slot of every group: each group's
    ``session_step`` on its row slice of the shared cache, merged back in
    place. Group steps write only pages their own rows own (the planner's
    private-window invariant), so the merge order does not matter."""
    cache = gstate.cache
    out, lo = [], 0
    for spec, gs in zip(specs, gstate.groups):
        hi = lo + spec.n_rows
        st = gs._replace(cache=slice_rows(cache, lo, hi))
        st = session_step(spec, handle, st)
        cache = merge_rows(cache, st.cache, lo, hi)
        out.append(st._replace(cache=None))
        lo = hi
    return GroupedState(groups=tuple(out), cache=cache)


# ---------------------------------------------------------------------------
# paged-cache page allocation (host side)


class PoolExhausted(RuntimeError):
    """The page pool cannot satisfy a mapping request. The scheduler reacts
    by deferring admission or preempting the youngest resident request:
    exhaustion is a scheduling event, never a crash. ``group`` names the
    slot group whose row could not be mapped (None outside grouped
    sessions); ``shard`` names the data shard whose page-pool segment ran
    short (None on an unsharded pool)."""

    def __init__(self, msg: str, group=None, shard=None):
        super().__init__(msg)
        self.group = group
        self.shard = shard


class PageAllocator:
    """Host-side free-list allocator + block-table maintenance for a session
    whose model cache holds a ``PagedKVCache``, the port of
    ``repro.core.session.PageAllocator``.

    ``reclaim(state)`` recomputes page reference counts from the block
    tables and returns every unreferenced page to the free list.
    ``prepare_step(state)`` walks every live row's write window ``[pos, pos
    + DL]`` and maps it to pages owned by exactly one row: lazy growth for
    unmapped blocks, copy-on-write of a shared draft-boundary page. The
    streaming engine runs the same walk on the device (``device_page_plan``)
    and uses this class for admission accounting and ``check()``. A
    chunked prefill (the decoder-only backend) maps prompt pages into a
    slot whose state stays inactive until the prompt is written: its rows
    are pinned (``pin_rows``) so every scan counts them live, and
    ``map_prefill`` maps a chunk's blocks on the host.

    Page 0 is the reserved trash page and is never allocated. The pool must
    cover one slot's worst case so the oldest resident can always run to
    completion: that makes deferral + preemption deadlock-free.
    """

    def __init__(self, spec, *, n_pages: int, page_size: int,
                 row_lens: dict | None = None,
                 prefill_blocks: dict | None = None):
        # ``spec``: one SessionSpec, or an ordered {group_key: SessionSpec}
        # (declaration order == row order, matching GroupedState.groups).
        # ``row_lens``: per-group logical row length (decoder-only rows
        # also hold the prompt); default spec.cache_len. ``prefill_blocks``:
        # per-group worst-case prompt blocks a chunked prefill maps into
        # one row before the slot's siblings alias them (0 = the seq2seq
        # admission writes no prompt into the paged cache).
        self.groups: dict = ({None: spec} if isinstance(spec, SessionSpec)
                             else dict(spec))
        self.spec = next(iter(self.groups.values()))
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        row_lens = row_lens or {}
        self._blocks = {k: -(-int(row_lens.get(k, s.cache_len))
                             // self.page_size)
                        for k, s in self.groups.items()}
        self._prefill_blocks = {k: int((prefill_blocks or {}).get(k, 0))
                                for k in self.groups}
        self.n_blocks = max(self._blocks.values())
        # one slot's worst case: prompt pages are mapped once and shared by
        # the slot's rows (only the draft-boundary page is split per row),
        # so a chunked-prefill group needs prefill_blocks + rows * (decode
        # blocks + the split boundary); a single-row slot never shares and
        # a monolithic group writes no prompt: both keep rows * blocks
        self._slot_worst = {}
        for k, s in self.groups.items():
            pb = self._prefill_blocks[k]
            if pb and s.rows_per_slot > 1:
                self._slot_worst[k] = pb + s.rows_per_slot * (
                    -(-s.cache_len // self.page_size) + 1)
            else:
                self._slot_worst[k] = s.rows_per_slot * self._blocks[k]
        need_one_slot = max(self._slot_worst.values())
        if self.n_pages - 1 < need_one_slot:
            raise ValueError(
                f"n_pages={n_pages} cannot hold one slot's worst case "
                f"({need_one_slot} pages of {page_size} tokens + trash page); "
                f"no admission policy can make progress")
        self._free: list[int] = list(range(self.n_pages - 1, TRASH_PAGE, -1))
        self._used: set[int] = set()
        # rows live in every scan while their slot is still inactive (a
        # chunked prefill in flight)
        self._pinned_rows: set[int] = set()
        self.peak_pages = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._used)

    def window_blocks(self, pos: int, group=None) -> range:
        """Logical blocks the next step writes for a ``group`` row at
        position ``pos`` (tokens land at pos .. pos + DL)."""
        if group is None:
            group = next(iter(self.groups))
        ps = self.page_size
        hi = min((pos + self.groups[group].draft_len) // ps,
                 self._blocks[group] - 1)
        return range(pos // ps, hi + 1)

    def admit_pages_for(self, group=None) -> int:
        """Pages a fresh ``group`` admission maps on its first step (window
        at pos 0) plus one window of headroom, and a chunked-prefill
        group's worst-case prompt blocks, clamped to one slot's worst case
        so an empty pool can always admit."""
        if group is None:
            group = next(iter(self.groups))
        per_row = len(self.window_blocks(0, group))
        want = self._prefill_blocks[group] + (
            self.groups[group].rows_per_slot * min(2 * per_row,
                                                   self._blocks[group]))
        return min(want, self._slot_worst[group])

    def _alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(f"page pool exhausted "
                                f"({self.used_pages}/{self.n_pages - 1} used)")
        p = self._free.pop()
        self._used.add(p)
        self.peak_pages = max(self.peak_pages, len(self._used))
        return p

    def _nodes(self, state):
        nodes = paged_cache_entries(state.cache)
        if not nodes:
            raise TypeError("PageAllocator requires a PagedKVCache node in "
                            "the model cache (init_cache(..., "
                            "paged=(n_pages, ps)))")
        return nodes

    def _group_views(self, state):
        """(group key, spec, row offset, pos (S,K), active (S,)) per group,
        for a plain ``SessionState`` or a ``GroupedState``."""
        if isinstance(state, GroupedState):
            if len(state.groups) != len(self.groups):
                raise ValueError(
                    f"allocator has {len(self.groups)} group spec(s) but "
                    f"the state has {len(state.groups)}")
            lo = 0
            for (key, spec), gs in zip(self.groups.items(), state.groups):
                yield (key, spec, lo, gs.pos.cpu().numpy(),
                       gs.active.cpu().numpy())
                lo += spec.n_rows
        else:
            key = next(iter(self.groups))
            yield (key, self.groups[key], 0, state.pos.cpu().numpy(),
                   state.active.cpu().numpy())

    def _scan(self, state):
        """ONE device readback feeding reclaim, admission accounting and the
        prepare walk: (tables, group views, refcounts). Returns every
        unreferenced page to the free list (rows of released slots must
        already be unmapped). Pinned rows count as live."""
        bt = self._nodes(state)[0].block_tables[0].cpu().numpy().copy()
        views = list(self._group_views(state))
        rows = [np.fromiter(sorted(self._pinned_rows), np.int64,
                            len(self._pinned_rows))]
        for _, spec, lo, _, active in views:
            rps = spec.rows_per_slot
            rows.append((lo + np.flatnonzero(active)[:, None] * rps
                         + np.arange(rps)[None, :]).reshape(-1))
        live = bt[np.concatenate(rows)]
        refs = np.bincount(live[live >= 0].ravel(), minlength=self.n_pages)
        for p in [p for p in self._used if refs[p] == 0]:
            self._used.remove(p)
            self._free.append(p)
        return bt, views, refs

    def pin_rows(self, rows) -> None:
        """Count cache ``rows`` live while their slot is still inactive (a
        chunked prefill in flight); unpin when the slot activates or its
        request is preempted or released."""
        self._pinned_rows.update(int(r) for r in rows)

    def unpin_rows(self, rows) -> None:
        self._pinned_rows.difference_update(int(r) for r in rows)

    def map_prefill(self, state, row: int, blocks, group=None):
        """Map fresh pages for logical ``blocks`` of cache row ``row``, in
        place, so the next prefill chunk writes straight through the
        slot's block table. Mapped blocks are skipped. Raises
        ``PoolExhausted`` on pool pressure; pages taken before the raise
        are unreferenced and return on the next scan."""
        bt = self._nodes(state)[0].block_tables[0, row].cpu().numpy()
        set_j, set_p = [], []
        for j in blocks:
            if bt[j] >= 0:
                continue
            try:
                set_p.append(self._alloc())
            except PoolExhausted as e:
                e.group = group
                raise
            set_j.append(int(j))
        if not set_j:
            return state
        for node in self._nodes(state):
            dev = node.block_tables.device
            node.block_tables[:, row, torch.as_tensor(set_j, device=dev)] = \
                torch.as_tensor(set_p, dtype=_I32, device=dev)
            node.pos[:, torch.as_tensor(set_p, device=dev)] = -1
        return state

    def reclaim(self, state) -> None:
        """Return every page unreferenced by a live row to the free list."""
        self._scan(state)

    def _unmapped_window_blocks(self, bt, views) -> int:
        """Live window blocks no page is mapped to yet."""
        n = 0
        for key, spec, lo, pos, active in views:
            K, N_d = spec.n_beams, spec.n_drafts
            for s in np.flatnonzero(active):
                for k in range(K):
                    window = self.window_blocks(int(pos[s, k]), key)
                    for d in range(N_d):
                        r = lo + (s * K + k) * N_d + d
                        n += sum(1 for j in window if bt[r, j] < 0)
        return n

    def can_admit(self, state, group=None) -> bool:
        """Gate a ``group`` admission on free pages, net of the pages the
        resident rows still need mapped."""
        bt, views, _ = self._scan(state)
        pending = self._unmapped_window_blocks(bt, views)
        return self.free_pages - pending >= self.admit_pages_for(group)

    def prepare_step(self, state):
        """Reclaim orphans, then map/privatize every live row's write window
        (lazy growth + copy-on-write at the draft boundary), in place on
        every paged node. Raises ``PoolExhausted`` (the allocator heals on
        the next ``reclaim``) when the pool cannot cover the windows."""
        bt, views, refs = self._scan(state)
        ps = self.page_size
        set_r: list[int] = []
        set_j: list[int] = []
        set_p: list[int] = []
        fresh: list[int] = []                             # pos := -1
        copy_src: list[int] = []
        copy_dst: list[int] = []
        for key, spec, lo, pos, active in views:
            K, N_d = spec.n_beams, spec.n_drafts
            for s in np.flatnonzero(active):
                for k in range(K):
                    p_row = int(pos[s, k])
                    window = self.window_blocks(p_row, key)
                    for d in range(N_d):
                        r = lo + (s * K + k) * N_d + d
                        for j in window:
                            cur = int(bt[r, j])
                            if cur >= 0 and refs[cur] == 1:
                                continue                  # already private
                            try:
                                new = self._alloc()
                            except PoolExhausted as e:
                                e.group = key
                                raise
                            if cur >= 0:
                                refs[cur] -= 1
                            refs[new] = 1
                            if cur >= 0 and j == window[0] and p_row % ps:
                                # boundary block holds committed tokens:
                                # copy the page (entries >= pos are stale
                                # draft slots the next write overwrites)
                                copy_src.append(cur)
                                copy_dst.append(new)
                            else:
                                fresh.append(new)
                            bt[r, j] = new
                            set_r.append(r)
                            set_j.append(j)
                            set_p.append(new)
        for node in self._nodes(state):
            dev = node.block_tables.device
            if set_r:
                node.block_tables[:, torch.as_tensor(set_r, device=dev),
                                  torch.as_tensor(set_j, device=dev)] = \
                    torch.as_tensor(set_p, dtype=_I32, device=dev)
            if fresh:
                node.pos[:, torch.as_tensor(fresh, device=dev)] = -1
            if copy_dst:
                src = torch.as_tensor(copy_src, device=dev)
                dst = torch.as_tensor(copy_dst, device=dev)
                node.k_pool[:, dst] = node.k_pool[:, src]
                node.v_pool[:, dst] = node.v_pool[:, src]
                node.pos[:, dst] = node.pos[:, src]
        return state

    def check(self) -> None:
        """Allocator invariants."""
        free = self._free
        assert len(set(free)) == len(free), "duplicate pages in free list"
        assert not (set(free) & self._used), "page both free and allocated"
        assert TRASH_PAGE not in self._used and TRASH_PAGE not in free
        assert set(free) | self._used == set(range(1, self.n_pages)), \
            "page leaked"


class ShardedPageAllocator(PageAllocator):
    """Per-shard view over ONE page pool split across a mesh's data axis,
    the port of ``repro.core.session.ShardedPageAllocator``: shard ``s``
    owns the contiguous page segment ``[s * pages_per_shard, (s + 1) *
    pages_per_shard)``; the reserved trash page 0 sits inside shard 0's
    segment and is never allocated.

    Host accounting stays global (admission sizing and pinning; the device
    page plan allocates, segment-locally when given the shard map). The
    subclass adds the shard geometry the engine's placement, admission and
    preemption key on: which shard owns a page, each shard's usable
    capacity, per-shard peaks, and the check that EVERY shard's segment
    covers one slot's worst case (what makes per-shard deferral plus
    shard-local preemption deadlock-free, as the global bound does for one
    pool)."""

    def __init__(self, spec, *, n_pages: int, page_size: int, n_shards: int,
                 row_lens: dict | None = None,
                 prefill_blocks: dict | None = None):
        super().__init__(spec, n_pages=n_pages, page_size=page_size,
                         row_lens=row_lens, prefill_blocks=prefill_blocks)
        self.n_shards = int(n_shards)
        if self.n_shards < 1:
            raise ValueError(f"n_shards={n_shards} must be >= 1")
        if self.n_pages % self.n_shards:
            raise ValueError(
                f"n_pages={n_pages} must divide evenly across "
                f"{self.n_shards} data shards (contiguous equal page "
                f"segments let the device plan allocate shard-locally)")
        self.pages_per_shard = self.n_pages // self.n_shards
        need_one_slot = max(self._slot_worst.values())
        if self.shard_capacity(0) < need_one_slot:
            raise ValueError(
                f"n_pages={n_pages} over {self.n_shards} shards leaves "
                f"{self.shard_capacity(0)} usable pages in shard 0, below "
                f"one slot's worst case ({need_one_slot}); shard-local "
                f"preemption could not make progress")
        self.peak_pages_by_shard = [0] * self.n_shards

    def shard_of_page(self, page: int) -> int:
        """The shard owning a page id."""
        return int(page) // self.pages_per_shard

    def shard_capacity(self, shard: int) -> int:
        """Allocatable pages in a shard's segment (shard 0 gives one to the
        trash)."""
        return self.pages_per_shard - (1 if shard == 0 else 0)

    def note_peak(self, free_by_shard) -> None:
        """Fold one bundle's per-shard free counts into the per-shard
        page high-water marks."""
        for s, free in enumerate(free_by_shard):
            used = self.shard_capacity(s) - int(free)
            if used > self.peak_pages_by_shard[s]:
                self.peak_pages_by_shard[s] = used


# ---------------------------------------------------------------------------
# cross-request prefix page sharing: radix tree over committed pages


class RadixNode:
    """One committed page of prompt tokens in the prefix tree. The node
    owns exactly one page and one *index cell*: a (row, block) slot in the
    reserved index rows of the block table whose reference keeps the page
    allocated while no request aliases it."""

    __slots__ = ("key", "page", "parent", "children", "cell", "active",
                 "last_used", "depth")

    def __init__(self, key, page, parent, cell, depth):
        self.key = key              # tuple of page_size token ids
        self.page = int(page)
        self.parent = parent
        self.children: dict = {}
        self.cell = cell            # index cell holding the reference
        self.active = 0             # resident requests aliasing this page
        self.last_used = 0          # LRU stamp (monotone counter)
        self.depth = depth


class RadixPageCache:
    """Host-side radix (prefix) tree over committed prompt pages, the port
    of ``repro.core.session.RadixPageCache``.

    A request's prompt is keyed in ``page_size``-token chunks; on admission
    the engine matches the prompt against this tree, aliases the matched
    pages into the new slot's block table, and prefills only the unmatched
    suffix. A node's page stays allocated (seen by the host allocator's
    scan and the device page plan's refcounts) through its *index cell*:
    one entry in the reserved index rows of the block table. Clearing the
    cell is the whole eviction; the page then reads as unreferenced and
    returns to the pool on the next reclaim.

    Shared pages are copy-on-write safe: the index-cell reference makes
    ``refs > win_refs`` for any decode window touching a shared page, so
    the device plan (and the host walk) never keep it in place; a writer
    always copies first. The tree is host bookkeeping only; the engine
    writes and clears the cells with the block-table edits below."""

    def __init__(self, page_size: int, n_cells: int):
        self.page_size = int(page_size)
        self.n_cells = int(n_cells)
        self.root = RadixNode(None, -1, None, None, 0)
        self._free_cells = list(range(n_cells - 1, -1, -1))
        self._nodes_by_cell: dict[int, RadixNode] = {}
        self._clock = 0
        self.lookups = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.inserted = 0
        self.evicted = 0

    def __len__(self) -> int:
        return len(self._nodes_by_cell)

    @property
    def free_cells(self) -> int:
        return len(self._free_cells)

    def _keys(self, tokens) -> list[tuple]:
        ps = self.page_size
        toks = [int(t) for t in tokens]
        return [tuple(toks[i:i + ps])
                for i in range(0, len(toks) - ps + 1, ps)]

    def match(self, tokens) -> list[RadixNode]:
        """Longest-prefix match of ``tokens`` in whole pages: the matched
        node chain, root first (maybe empty); counts a lookup."""
        self._clock += 1
        self.lookups += 1
        self.lookup_tokens += len(tokens)
        chain = self.peek(tokens)
        for nd in chain:
            nd.last_used = self._clock
        self.hit_tokens += len(chain) * self.page_size
        return chain

    def peek(self, tokens) -> list[RadixNode]:
        """``match`` without side effects: touches neither the LRU clock
        nor the hit-rate stats (a placement probe)."""
        chain, node = [], self.root
        for key in self._keys(tokens):
            nxt = node.children.get(key)
            if nxt is None:
                break
            chain.append(nxt)
            node = nxt
        return chain

    def insert(self, tokens, pages, depth0: int = 0) -> list[RadixNode]:
        """Extend the tree with ``tokens`` (full pages only) mapped to
        ``pages`` (one page id per chunk, the finished prefill's committed
        prompt pages); ``depth0`` skips the chunks matched at admission.
        Returns the NEW nodes (the engine writes their index cells); chunks
        already present are refreshed, not replaced. Out of cells, it stops
        inserting (the tree is a cache, not a ledger)."""
        self._clock += 1
        keys = self._keys(tokens)
        node = self.root
        for key in keys[:depth0]:
            nxt = node.children.get(key)
            if nxt is None:
                return []          # the matched chain was evicted meanwhile
            nxt.last_used = self._clock
            node = nxt
        new: list[RadixNode] = []
        for d, key in enumerate(keys[depth0:], start=depth0):
            nxt = node.children.get(key)
            if nxt is None:
                if not self._free_cells:
                    break
                cell = self._free_cells.pop()
                nxt = RadixNode(key, int(pages[d]), node, cell, d + 1)
                node.children[key] = nxt
                self._nodes_by_cell[cell] = nxt
                new.append(nxt)
                self.inserted += 1
            nxt.last_used = self._clock
            node = nxt
        return new

    def acquire(self, chain) -> None:
        for node in chain:
            node.active += 1

    def release(self, chain) -> None:
        for node in chain:
            node.active -= 1
            assert node.active >= 0, "radix node released below zero"

    def _drop(self, node: RadixNode) -> int:
        """Unlink one leaf node and recycle its cell; returns the cell."""
        assert not node.children and node.active == 0
        del node.parent.children[node.key]
        del self._nodes_by_cell[node.cell]
        self._free_cells.append(node.cell)
        self.evicted += 1
        return node.cell

    def evict_lru(self, n: int, where=None) -> list[tuple[int, int]]:
        """Evict up to ``n`` least-recently-used inactive LEAF nodes (leaf
        first keeps the tree prefix-closed). Returns the ``(cell, page)``
        pairs whose index cells the engine must clear. ``where`` narrows
        the victims (a sharded engine reclaims from the short page-pool
        shard: another shard's pages would not help it)."""
        out: list[tuple[int, int]] = []
        while len(out) < n:
            victims = [nd for nd in self._nodes_by_cell.values()
                       if not nd.children and nd.active == 0
                       and (where is None or where(nd))]
            if not victims:
                break
            victims.sort(key=lambda nd: nd.last_used)
            for nd in victims:
                if len(out) >= n:
                    break
                out.append((self._drop(nd), nd.page))
        return out

    def drop_subtree(self, node: RadixNode) -> list[tuple[int, int]]:
        """Remove ``node`` and every descendant whose whole chain is
        inactive (a pruned search subtree). Nodes a resident request still
        aliases are kept. Returns the cleared ``(cell, page)`` pairs."""
        out: list[tuple[int, int]] = []

        def walk(nd: RadixNode) -> bool:
            keep = nd.active > 0
            for child in list(nd.children.values()):
                if not walk(child):
                    keep = True
            if not keep:
                out.append((self._drop(nd), nd.page))
            return not keep

        walk(node)
        return out

    def check(self) -> None:
        """Tree invariants."""
        assert len(set(self._free_cells)) == len(self._free_cells)
        assert not (set(self._free_cells) & set(self._nodes_by_cell))
        assert (set(self._free_cells) | set(self._nodes_by_cell)
                == set(range(self.n_cells))), "index cell leaked"

        def walk(nd):
            for key, child in nd.children.items():
                assert child.parent is nd and child.key == key
                assert self._nodes_by_cell.get(child.cell) is child
                assert child.active >= 0
                walk(child)

        walk(self.root)


def radix_cell_coords(n_rows: int, n_blocks: int, cells):
    """Flat index-cell ids -> (index row, block) coordinates. Index rows
    follow the session's ``n_rows`` group rows in the block table; each
    holds ``n_blocks`` cells."""
    cells = np.asarray(list(cells), np.int64)
    return n_rows + cells // n_blocks, cells % n_blocks


def write_index_cells(cache, rows, blocks, pages):
    """``block_tables[:, rows[i], blocks[i]] = pages[i]`` on every paged
    node, in place: written into the reserved index rows, the reference
    that keeps a radix node's page allocated."""
    if len(rows) == 0:
        return cache
    for node in paged_cache_entries(cache):
        dev = node.block_tables.device
        r, b, p = (torch.as_tensor(np.asarray(a), device=dev)
                   for a in (rows, blocks, pages))
        node.block_tables[:, r.long(), b.long()] = p.to(_I32)
    return cache


def clear_index_cells(cache, rows, blocks):
    """Reset index cells to -1 (radix eviction, subtree drop), in place;
    the pages they held return to the pool once no live row aliases them."""
    return write_index_cells(cache, rows, blocks,
                             np.full((len(rows),), -1, np.int32))


def alias_prefix_pages(cache, row0: int, pages):
    """Write a matched prefix chain's pages into the leading blocks of
    cache row ``row0`` (the slot's prefill row), in place: the suffix-only
    admission's aliasing step. Later blocks keep their (unmapped) entries,
    so the suffix prefill maps them fresh."""
    n = len(pages)
    return write_index_cells(cache, np.full((n,), int(row0)), np.arange(n),
                             pages)


def read_row_pages(cache, rows0, n_blocks: int) -> torch.Tensor:
    """(len(rows0), n_blocks) int32: the leading ``n_blocks`` block-table
    entries of ``rows0``, the step bundle's committed-prompt-page feed
    (the host learns which pages a finished prefill wrote without a read
    of its own)."""
    bt = paged_cache_entries(cache)[0].block_tables[0]
    rows = torch.as_tensor(rows0, dtype=torch.long, device=bt.device)
    return bt[rows, :n_blocks]


# ---------------------------------------------------------------------------
# paged-cache page allocation (device side)


class DevicePagePlan(NamedTuple):
    """One iteration's page maintenance, computed on the device: the lazy-
    growth + copy-on-write walk of ``PageAllocator.prepare_step`` as
    fixed-shape lane tensors over the block table. Allocation is
    all-or-nothing: the engine reads ``exhausted`` and, when it is set,
    applies nothing, so the host can preempt and replay the iteration. All
    lane tensors share one length L (the decode windows of every group,
    then the prefill chunks' lanes)."""

    exhausted: torch.Tensor      # () bool
    n_free: torch.Tensor         # () int32 free pages before allocation
    need_by_group: torch.Tensor  # (G,) int32 pages each group's lanes need
    rows: torch.Tensor           # (L,) int32 lane cache row
    blocks: torch.Tensor         # (L,) int32 lane logical block
    need: torch.Tensor           # (L,) bool lane allocates a page
    copy: torch.Tensor           # (L,) bool draft-boundary copy-on-write
    cur: torch.Tensor            # (L,) int32 current page (-1 = unmapped)
    new: torch.Tensor            # (L,) int32 allocated page (if ``need``)
    # sharded sessions only (None on one pool): per-data-shard accounting
    # over the contiguous page segments
    need_by_shard: torch.Tensor | None = None       # (n_shards,) int32
    n_free_by_shard: torch.Tensor | None = None     # (n_shards,) int32
    exhausted_by_shard: torch.Tensor | None = None  # (n_shards,) bool


def _page_refs(bt: torch.Tensor, n_pages: int) -> torch.Tensor:
    """(n_pages,) reference counts over one block table (unmapped entries
    count into a dropped extra bin). Released rows are always unmapped, so
    every mapped entry belongs to a live row."""
    flat = torch.where(bt >= 0, bt, n_pages).reshape(-1).long()
    return torch.bincount(flat, minlength=n_pages + 1)[:n_pages].to(_I32)


def _block_table(cache) -> torch.Tensor:
    return paged_cache_entries(cache)[0].block_tables[0]


def device_free_pages(cache, n_pages: int) -> torch.Tensor:
    """() int32: pages no live row references (the mirrored-counter feed
    for the host's admission accounting)."""
    refs = _page_refs(_block_table(cache), n_pages)
    free = (refs == 0) & (torch.arange(n_pages, device=refs.device)
                          != TRASH_PAGE)
    return free.sum(dtype=_I32)


def device_free_pages_by_shard(cache, n_pages: int,
                               n_shards: int) -> torch.Tensor:
    """(n_shards,) int32: free pages in each contiguous shard segment (shard
    ``s`` owns pages ``[s * pps, (s + 1) * pps)``, the trash page inside
    shard 0's): the per-shard mirrored-counter feed."""
    refs = _page_refs(_block_table(cache), n_pages)
    free = (refs == 0) & (torch.arange(n_pages, device=refs.device)
                          != TRASH_PAGE)
    return free.reshape(n_shards, -1).sum(1, dtype=_I32)


def device_page_plan(specs, blocks, page_size: int, n_pages: int,
                     gstate: GroupedState, prefill=None,
                     shards=None) -> DevicePagePlan:
    """Plan this iteration's page maintenance on the device.

    ``specs``/``blocks`` are the groups' specs and logical block counts.
    ``prefill`` is None or a per-group tuple ``(rows0, pos0, n_valid,
    chunk)``: the prompt chunk each slot of the group writes this
    iteration (``rows0`` the slots' leading cache rows, a host list;
    ``pos0`` / ``n_valid`` (S_g,) tensors, ``n_valid == 0`` an idle lane).
    Its lanes map the chunk's unmapped blocks to fresh pages, after the
    decode lanes.
    A lane keeps its current page iff no out-of-window row references it
    (``refs == win_refs``) AND it is the highest-row in-window referencer
    (the host walk visits rows in ascending order, so its LAST visitor sees
    refs == 1 and keeps the page). Fresh pages come off an ascending free
    stack; page identity never affects tokens (attention masks on stored
    positions), only the count matters for accounting.

    ``shards`` is None (one free stack) or ``(n_shards, row_shard)`` with
    ``row_shard`` a host array giving each table row's data shard.
    Allocation is then SEGMENT-LOCAL: shard ``s`` owns pages ``[s * pps,
    (s + 1) * pps)`` and a lane draws from its row's shard stack only, so
    one shard's burst never takes another shard's pages. Exhaustion stays
    all-or-nothing and global (any short segment replays the whole step);
    ``exhausted_by_shard`` says which segments are short."""
    ps, P = int(page_size), int(n_pages)
    bt = _block_table(gstate.cache)
    dev = bt.device
    n_blocks = bt.shape[1]
    refs = _page_refs(bt, P)
    ar = torch.arange(P, dtype=_I32, device=dev)
    free = (refs == 0) & (ar != TRASH_PAGE)
    n_free = free.sum(dtype=_I32)
    rank = torch.cumsum(free.to(_I32), 0) - 1
    stack = torch.full((P + 1,), P, dtype=_I32, device=dev)
    stack[torch.where(free, rank, P).long()] = ar
    stack = stack[:P]

    offs = group_row_offsets(specs)
    lane_r, lane_j, lane_valid, lane_pos, lane_w0, lane_gi = \
        [], [], [], [], [], []
    for gi, (spec, gs) in enumerate(zip(specs, gstate.groups)):
        K, N_d, DL = spec.n_beams, spec.n_drafts, spec.draft_len
        nR, W = spec.n_rows, DL // ps + 2
        rg = torch.arange(nR, dtype=_I32, device=dev)
        s, k = rg // (K * N_d), (rg // N_d) % K
        pos_r = gs.pos[s.long(), k.long()]
        act = gs.active[s.long()]
        w = torch.arange(W, dtype=_I32, device=dev)
        j = torch.div(pos_r, ps, rounding_mode="floor")[:, None] + w[None, :]
        hi = torch.clamp(torch.div(pos_r + DL, ps, rounding_mode="floor"),
                         max=blocks[gi] - 1)
        lane_r.append((offs[gi] + rg)[:, None].expand(nR, W).reshape(-1))
        lane_j.append(j.reshape(-1))
        lane_valid.append((act[:, None] & (j <= hi[:, None])).reshape(-1))
        lane_pos.append(pos_r[:, None].expand(nR, W).reshape(-1))
        lane_w0.append((w[None, :] == 0).expand(nR, W).reshape(-1))
        lane_gi.append(torch.full((nR * W,), gi, dtype=torch.long,
                                  device=dev))
    r, jb, valid = torch.cat(lane_r), torch.cat(lane_j), torch.cat(lane_valid)
    posl, w0, gsel = torch.cat(lane_pos), torch.cat(lane_w0), torch.cat(lane_gi)

    cur = torch.where(valid, bt[r.long(), jb.clamp(0, n_blocks - 1).long()],
                      -1)
    vc = valid & (cur >= 0)
    safe_cur = torch.where(vc, cur, P).long()
    win_refs = torch.bincount(safe_cur, minlength=P + 1)[:P].to(_I32)
    keeper = torch.full((P + 1,), -1, dtype=_I32, device=dev)
    keeper.scatter_reduce_(0, safe_cur, torch.where(vc, r, -1), "amax")
    keeper = keeper[:P]
    cc = cur.clamp(0, P - 1).long()
    keep = vc & (refs[cc] == win_refs[cc]) & (r == keeper[cc])
    need = valid & ~keep
    copy = need & vc & w0 & (posl % ps != 0)

    if prefill is not None:
        # frontier growth for this iteration's prompt chunks: fresh pages
        # for row 0's unmapped blocks the chunk's valid tokens reach
        pr, pj, pn, pc, pu, pg = [r], [jb], [need], [copy], [cur], [gsel]
        for gi, (rows0, pos0, n_valid, chunk) in enumerate(prefill):
            CB = -(-int(chunk) // ps) + 1
            c = torch.arange(CB, dtype=_I32, device=dev)
            pos0 = pos0.to(dev, _I32)
            n_valid = n_valid.to(dev, _I32)
            j = torch.div(pos0, ps, rounding_mode="floor")[:, None] + c[None]
            hi = torch.div(pos0 + n_valid.clamp(min=1) - 1, ps,
                           rounding_mode="floor")
            r0 = torch.as_tensor(rows0, dtype=_I32, device=dev)
            mapped = bt[r0.long()[:, None],
                        j.clamp(0, n_blocks - 1).long()] >= 0
            v = (n_valid[:, None] > 0) & (j <= hi[:, None]) & ~mapped
            L = v.numel()
            pr.append(r0[:, None].expand(j.shape).reshape(-1))
            pj.append(j.reshape(-1))
            pn.append(v.reshape(-1))
            pc.append(torch.zeros((L,), dtype=torch.bool, device=dev))
            pu.append(torch.full((L,), -1, dtype=_I32, device=dev))
            pg.append(torch.full((L,), gi, dtype=torch.long, device=dev))
        r, jb = torch.cat(pr), torch.cat(pj)
        need, copy = torch.cat(pn), torch.cat(pc)
        cur, gsel = torch.cat(pu), torch.cat(pg)

    need_i = need.to(_I32)
    need_by_group = torch.zeros((len(specs),), dtype=_I32, device=dev)
    need_by_group.index_add_(0, gsel, need_i)
    if shards is None:
        ni = torch.cumsum(need_i, 0) - 1
        new = stack[torch.where(need, ni, 0).clamp(0, P - 1).long()]
        return DevicePagePlan(exhausted=need_i.sum() > n_free, n_free=n_free,
                              need_by_group=need_by_group, rows=r, blocks=jb,
                              need=need, copy=copy, cur=cur, new=new)
    # segment-local allocation: per-shard ascending free stacks, each
    # needing lane ranked WITHIN its row's shard (a lane x shard one-hot
    # cumsum: L and n_shards are both small)
    n_sh, row_shard = int(shards[0]), shards[1]
    if P % n_sh:
        raise ValueError(f"n_pages={P} must divide across {n_sh} shards")
    pps = P // n_sh
    free_sh = free.reshape(n_sh, pps)
    n_free_sh = free_sh.sum(1, dtype=_I32)
    rank_sh = torch.cumsum(free_sh.to(_I32), 1) - 1
    srow = torch.arange(n_sh, device=dev)[:, None].expand(n_sh, pps)
    stack_sh = torch.full((n_sh, pps + 1), P, dtype=_I32, device=dev)
    stack_sh[srow, torch.where(free_sh, rank_sh, pps).long()] = ar.reshape(
        n_sh, pps)
    stack_sh = stack_sh[:, :pps]
    lane_sh = torch.as_tensor(np.asarray(row_shard), dtype=torch.long,
                              device=dev)[r.long()]
    onehot = ((lane_sh[:, None] == torch.arange(n_sh, device=dev)[None, :])
              & need[:, None]).to(_I32)                   # (L, n_shards)
    ni = (torch.cumsum(onehot, 0) - 1).gather(1, lane_sh[:, None])[:, 0]
    new = stack_sh[lane_sh, torch.where(need, ni, 0).clamp(0, pps - 1).long()]
    need_by_shard = onehot.sum(0, dtype=_I32)
    exhausted_by_shard = need_by_shard > n_free_sh
    return DevicePagePlan(exhausted=exhausted_by_shard.any(), n_free=n_free,
                          need_by_group=need_by_group, rows=r, blocks=jb,
                          need=need, copy=copy, cur=cur, new=new,
                          need_by_shard=need_by_shard,
                          n_free_by_shard=n_free_sh,
                          exhausted_by_shard=exhausted_by_shard)


def apply_page_plan(cache, plan: DevicePagePlan, n_copy: int | None = None):
    """Apply a non-exhausted plan to every paged node, in place: write the
    new table entries, copy the draft-boundary pages (the committed prefix
    rides along; stale draft slots past ``pos`` are overwritten before they
    are read) and mark fresh pages empty (stored position -1). The caller
    checks ``plan.exhausted`` first: an exhausted plan must not be applied.

    ``n_copy`` is the plan's count of copy lanes as the host already read it
    (the engine reads it with ``exhausted``); the copy lanes are compacted to
    that many so the pools copy only those pages. Without it the count is
    read here. Lanes that write nothing are pointed at harmless targets
    instead of JAX's dropped writes: an extra element past the table for
    table entries, the trash page (whose positions are always -1) for the
    fresh-page marks."""
    if n_copy is None:
        n_copy = int(plan.copy.sum())
    nodes = paged_cache_entries(cache)
    bt = nodes[0].block_tables[0]
    n_rows, nb = bt.shape
    cell = torch.where(plan.need, plan.rows.long() * nb + plan.blocks.long(),
                       n_rows * nb)
    flat = torch.cat([bt.reshape(-1), bt.new_zeros(1)])
    flat[cell] = plan.new
    bt_new = flat[:-1].view(n_rows, nb)
    fresh = torch.where(plan.need & ~plan.copy, plan.new, TRASH_PAGE).long()
    lanes = torch.argsort((~plan.copy).to(torch.int8), stable=True)[:n_copy]
    copy_dst, copy_src = plan.new[lanes].long(), plan.cur[lanes].long()
    for node in nodes:
        if n_copy:
            node.k_pool[:, copy_dst] = node.k_pool[:, copy_src]
            node.v_pool[:, copy_dst] = node.v_pool[:, copy_src]
            node.pos[:, copy_dst] = node.pos[:, copy_src]
        node.pos[:, fresh] = -1
        node.block_tables.copy_(bt_new.expand_as(node.block_tables))
    return cache


def segment_pages(pages: torch.Tensor, shard: int, pps: int) -> torch.Tensor:
    """Global page ids -> ids in shard ``shard``'s own pool: its segment
    ``[shard * pps, (shard + 1) * pps)`` at 1 .. pps, with local page 0 the
    rank's own trash page; -1 for unmapped entries and another shard's
    pages (they read the trash page, masked)."""
    lo = shard * pps
    mine = (pages >= lo) & (pages < lo + pps)
    return torch.where(mine, pages - lo + 1, -1).to(_I32)


def global_pages(local: torch.Tensor, shard: int, pps: int) -> torch.Tensor:
    """``segment_pages``'s inverse on its own entries (trash and unmapped
    entries -> -1)."""
    return torch.where(local > 0, local - 1 + shard * pps, -1).to(_I32)


def apply_page_plan_segment(tables, pools, plan: DevicePagePlan, shard: int,
                            pps: int, n_copy: int):
    """Apply a non-exhausted sharded plan, in place, on one rank of data
    shard ``shard``: every table entry the plan maps goes into the
    replicated global tables (``tables``: paged nodes holding them), and
    the page copies and fresh-page marks of the shard's own segment into
    its pools (``pools``: the rank's paged nodes, ``segment_pages`` ids).
    ``n_copy``: the plan's copy lanes inside the segment, as the host read
    them. Lanes of other shards touch the local trash page only."""
    nodes = paged_cache_entries(tables)
    bt = nodes[0].block_tables[0]
    n_rows, nb = bt.shape
    cell = torch.where(plan.need, plan.rows.long() * nb + plan.blocks.long(),
                       n_rows * nb)
    flat = torch.cat([bt.reshape(-1), bt.new_zeros(1)])
    flat[cell] = plan.new
    bt_new = flat[:-1].view(n_rows, nb)
    for node in nodes:
        node.block_tables.copy_(bt_new.expand_as(node.block_tables))
    new_l = segment_pages(plan.new, shard, pps)
    mine = plan.need & (new_l > 0)
    fresh = torch.where(mine & ~plan.copy, new_l, TRASH_PAGE).long()
    copying = mine & plan.copy
    lanes = torch.argsort((~copying).to(torch.int8), stable=True)[:n_copy]
    copy_dst = new_l[lanes].long()
    copy_src = segment_pages(plan.cur[lanes], shard, pps).long()
    for node in paged_cache_entries(pools):
        if n_copy:
            node.k_pool[:, copy_dst] = node.k_pool[:, copy_src]
            node.v_pool[:, copy_dst] = node.v_pool[:, copy_src]
            node.pos[:, copy_dst] = node.pos[:, copy_src]
        node.pos[:, fresh] = -1
    return tables


def _is_stop_token(spec: SessionSpec, tok: torch.Tensor,
                   stop_ids: torch.Tensor) -> torch.Tensor:
    """True where ``tok`` ends its slot's sequence: the session-wide EOS, or
    one of the slot's ``stop_ids``. ``tok`` is (S, ...); ``stop_ids`` is
    (S, n_stop) with -1 = unused (token ids are non-negative)."""
    hit = tok == spec.eos_id
    if spec.n_stop:
        extra = tok[..., None] == stop_ids.reshape(
            stop_ids.shape[0], *([1] * (tok.dim() - 1)), spec.n_stop)
        hit = hit | extra.any(-1)
    return hit


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
    max_out = state.max_out                                      # (S,)

    # argmax over the vocab + accepted-prefix match, fused in one kernel
    greedy_tok, n_acc = draft_verify(logits.contiguous(),
                                     drafts_rows.contiguous(),
                                     state.draft_mask.reshape(-1).contiguous())
    greedy_tok = greedy_tok.reshape(S, N_d, DL + 1)

    # --- accept / select best draft --------------------------------------
    # per-request draft windows: clamping the accept length to the slot's
    # eff_dl BEFORE best-draft selection makes a padded (N_d, DL) draft
    # matrix behave exactly like a DL'=eff_dl session
    n_acc = torch.minimum(n_acc.reshape(S, N_d), state.eff_dl[:, None])
    best = torch.argmax(n_acc, dim=-1).to(_I32)                  # (S,)
    # inactive slots must not move rows either
    best = torch.where(state.active, best, 0)
    n_acc_b = n_acc.gather(1, best[:, None].long())[:, 0]
    new_toks = greedy_tok.gather(
        1, best[:, None, None].long().expand(S, 1, DL + 1))[:, 0]  # (S, DL+1)

    # --- EOS/stop + budget truncation -------------------------------------
    within = rel[None, :] <= n_acc_b[:, None]
    is_eos = _is_stop_token(spec, new_toks, state.stop_ids) & within
    any_eos = is_eos.any(1)
    first_eos = torch.argmax(is_eos.to(_I32), dim=1).to(_I32)
    n_prop = torch.where(any_eos, first_eos + 1, n_acc_b + 1)
    budget = max_out - n_out
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
    new_finished = finished | hit_eos | (n_out >= max_out)
    acc_used = torch.minimum(n_acc_b, n_app)
    return state._replace(
        tokens=out[:, None], last=last[:, None], pos=pos[:, None],
        n_out=n_out[:, None], finished=new_finished[:, None], cache=cache,
        n_calls=state.n_calls + state.active.to(_I32),
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
    max_out = state.max_out                                      # (S,)

    lp_all = torch.log_softmax(logits.float(), dim=-1)
    lp_all[:, :, pad_id] = _NEG          # pad is never a real emission
    lp_all = lp_all.reshape(S, K, N_d, A, V)
    greedy_tok = torch.argmax(lp_all, dim=-1).to(_I32)

    # ---- best draft per beam ---------------------------------------------
    d4 = drafts_rows.reshape(S, K, N_d, DL)
    dm = state.draft_mask[:, None].expand(S, K, N_d)
    n_acc = _accept_lengths(greedy_tok, d4, dm)                  # (S, K, N_d)
    # per-request draft window (see the greedy-family step)
    n_acc = torch.minimum(n_acc, state.eff_dl[:, None, None])
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
    valid_a &= ((state.n_out[..., None] + rel[None, None, :] + 1)
                <= max_out[:, None, None])
    # prefixes may not extend past a draft EOS/stop token
    draft_eos = torch.cumsum(
        _is_stop_token(spec, draft_best, state.stop_ids).to(_I32), dim=-1)
    no_eos_in_prefix = torch.cat(
        [torch.ones((S, K, 1), dtype=torch.bool, device=dev), draft_eos == 0],
        dim=-1)
    valid_a &= no_eos_in_prefix
    cand_lp = torch.where(valid_a[..., None], cand_lp, _NEG)
    # per-request beam width: an eff_beams < K request only extends with its
    # top-eff_beams tokens per (parent, prefix)
    k_rank = torch.arange(K, dtype=_I32, device=dev)
    cand_lp = torch.where(
        k_rank[None, None, None, :] < state.eff_beams[:, None, None, None],
        cand_lp, _NEG)

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

    new_finished = (was_fin | _is_stop_token(spec, w_tok, state.stop_ids)
                    | (nout_p + n_new >= max_out[:, None]))
    # beams past the slot's eff_beams are parked: _NEG log-prob + finished
    parked = k_rank[None, :] >= state.eff_beams[:, None]
    new_logp = torch.where(parked, _NEG, new_logp)
    new_finished = new_finished | parked
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
        n_calls=state.n_calls + state.active.to(_I32),
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
