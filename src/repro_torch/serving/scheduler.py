"""Continuous-batching request scheduler over a DecodeSession (the port of
``repro.serving.scheduler``, carried over whole: it is host code).

The paper's industrial setting is a stream of retrosynthesis queries, not
fixed batches: the one-shot engine runs each request batch to completion,
so every request waits for the batch's slowest member. This scheduler
instead keeps S fixed decode slots stepping forever:

  - ``submit()`` enqueues a request (optionally with a future arrival
    time for open-loop load generation, a ``priority``, and a
    ``deadline``);
  - each host iteration admits queued requests into free slots (one
    admit call per slot for its host bookkeeping, then, where the engine
    supplies one, ONE ``admit_flush`` that does the device work of every
    admission the iteration made), runs ONE shared ``session_step`` for
    all slots, and evicts finished slots, returning their tokens
    immediately;
  - eviction frees the slot for the next queued request while the other
    slots keep decoding — no head-of-line blocking.

Priority + deadline scheduling: admission is no longer earliest-arrival.
Among ARRIVED requests, the scheduler admits by ``(-priority,
earliest-deadline, arrival)`` — a high-priority burst overtakes a low-
priority backlog, and within a priority class earlier deadlines go first
(EDF), then FIFO. Requests whose deadline has passed while QUEUED are
expired at admission time (a terminal ``status="expired"`` record, never
a slot); a RESIDENT request whose deadline passes mid-flight is evicted,
its pages reclaimed, without perturbing co-resident slots.

Cancellation: ``cancel(rid)`` removes a queued request immediately or
evicts a resident one mid-flight (slot released + pages unmapped so the
allocator's next reclaim returns its whole footprint). Both produce a
terminal ``status="cancelled"`` record.

``steps()`` is the step-driven core: a generator yielding the iteration's
terminal ``SlotResult``s after every scheduler cycle — the engine's
streaming token delivery hooks in between iterations. ``run()`` is the
blocking wrapper that drains the queue.

The scheduler is model-agnostic: it drives two callables (``admit``,
``step``) plus a ``read_slot`` extractor, all supplied by the engine
(``repro_torch.serving.engine.StreamingEngine``). Because the session step is
row-independent, a request's output is byte-identical whether it runs
alone or is admitted mid-stream next to strangers — the invariant
``tests/test_session.py`` enforces.

In-flight mode mixing: the slot axis may be partitioned into named *slot
groups* (``groups={mode: [slot ids]}``) so one session serves e.g. greedy
probes and beam retrosynthesis expansions concurrently. Each group keeps
its own free list and its own queue — a request routes to its mode's
slots (``submit(..., mode=...)``) and a full group never blocks another
group's admissions — while page-gated admission and preemption operate
over the one shared KV pool. Preemption prefers a victim inside the group
that exhausted the pool (``PoolExhausted.group``) before falling back to
the globally youngest resident, and a preempted request requeues at the
head of its own priority class with its mode tag intact.

Backend-agnostic admission: the scheduler never interprets payloads, so
the engine may admit in phases (chunked ragged prefill advances inside
``pre_step``). A ``pre_step`` that raises ``PoolExhausted`` mid-pump must
leave the scheduler's ``state`` attribute pointing at the live
(partially-advanced) state, so the preemption path releases against valid
buffers.

Memory-aware mode (paged KV cache): three optional hooks turn slot-count
admission into page-count admission. ``admit_ok`` gates each admission on
free *pages*, ``pre_step`` runs the host page-table maintenance before
every step, and when the pool is truly exhausted mid-decode the scheduler
*preempts* a youngest resident request rather than crashing. The oldest
resident always fits (``PageAllocator`` validates the pool covers one
slot's worst case), so the policy is deadlock-free.

Overload policy (``OverloadPolicy``): three knobs that keep the scheduler
honest when offered load exceeds capacity.

  - **Priority aging** (``aging_rate``): a queued request's *effective*
    priority grows with its wait (``priority + int(rate * wait)``), so a
    sustained high-priority stream can no longer starve a low-priority
    request forever — it climbs into the high class and is served. Ready
    queues are re-keyed against the current clock each admission pass.
  - **Deadline-aware preemption** (``deadline_preemption``): an urgent
    arrival (strictly higher effective priority, or a tighter deadline
    than a resident's slack by more than ``preempt_slack_margin``) may
    evict the resident with the MOST deadline slack even when the page
    pool is healthy. The victim requeues through the same deterministic
    requeue path as pool-pressure preemption (restart from scratch,
    token-identical), but WITHOUT the boost flag — its own lax deadline
    orders it after the urgent work, which is what prevents
    preempt-back thrash.
  - **Load shedding** (``shed_depth``): a submission finding its group's
    queue at depth is refused outright with a terminal ``SHED`` record
    carrying ``retry_after`` — an EWMA service-time estimate of when a
    retry might actually be admitted (``shed_retry_after`` overrides).
    Shedding at submit keeps the refusal O(1) and the queue bounded.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import time
from typing import Any, Callable, Hashable

import numpy as np

from repro_torch.core.session import PoolExhausted, SessionSpec, release_slot
from repro_torch.serving.api import RequestStatus
from repro_torch.serving.trace import Tracer


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """Scheduler behavior when offered load exceeds capacity. The default
    instance disables everything — strict priority/EDF/FIFO, admission
    only into free slots, queues unbounded — matching the pre-policy
    scheduler exactly.

    ``aging_rate``: effective-priority points gained per serving-clock
    unit spent queued (steps closed-loop, seconds realtime). 0 = off.
    ``shed_depth``: per-group queued-request ceiling; a submission that
    would exceed it is refused with a ``SHED`` record. None = unbounded.
    ``shed_retry_after``: fixed retry hint for shed records; None derives
    one from the group's EWMA service time and queue depth.
    ``deadline_preemption``: allow an urgent arrival to evict the
    most-slack resident (see module docstring). ``preempt_slack_margin``:
    minimum slack advantage (victim slack - arrival slack) before a
    same-priority deadline preemption fires — raising it trades latency
    for fewer restarts."""

    aging_rate: float = 0.0
    shed_depth: int | None = None
    shed_retry_after: float | None = None
    deadline_preemption: bool = False
    preempt_slack_margin: float = 0.0


@dataclasses.dataclass
class ScheduledRequest:
    """One queued decode request. ``payload`` is whatever the engine's
    admit function consumes (source tokens, drafts, ...); ``mode`` is the
    slot group the request routes to (queue routing AND requeue-after-
    preemption both read it, so the tag survives a round trip)."""

    rid: int
    payload: Any
    arrival: float = 0.0   # run()-relative: steps (closed loop) | s (realtime)
    mode: Hashable = None
    priority: int = 0      # higher admitted first among arrived requests
    deadline: float | None = None   # serving-clock expiry (None = never)
    seq: int = 0           # submission order (FIFO tie-break)
    boost: int = 0         # preemption requeue: head of its priority class
    cancelled: bool = False
    queued_ns: int = 0     # perf_counter_ns at enqueue, while tracing

    def eff_priority(self, now: float, rate: float) -> int:
        """Effective priority under aging: the base class plus one point
        per ``1/rate`` clock units spent queued. Residents age too (their
        wait froze at admission-time ``now``), keeping preemption
        comparisons symmetric."""
        if rate <= 0.0:
            return self.priority
        return self.priority + int(rate * max(0.0, now - self.arrival))

    def key_at(self, now: float, rate: float):
        """Ready-queue ordering: effective priority desc, preempted-first,
        EDF, then FIFO."""
        return (-self.eff_priority(now, rate), -self.boost,
                math.inf if self.deadline is None else self.deadline,
                self.arrival, self.seq)

    @property
    def key(self):
        """Static ordering (no aging) — kept for aging-off fast paths."""
        return self.key_at(0.0, 0.0)


@dataclasses.dataclass
class SlotResult:
    """A terminal request record. ``FINISHED`` rows are read out of the
    slot at eviction; ``CANCELLED``/``EXPIRED``/``SHED`` rows carry empty
    token buffers (the request never finished — ``admitted``/``completed``
    stamp when it left the system). ``SHED`` rows additionally carry
    ``retry_after``, the scheduler's estimate of when a retry could be
    admitted (serving-clock units).

    Timestamps (and thus ``latency``/``queue_delay``) are relative to
    run() start, in the run's clock unit: wall-clock seconds when
    ``realtime=True``, decode-step counts otherwise."""

    rid: int
    tokens: np.ndarray            # (K, max_new) committed tokens, pad after EOS
    lengths: np.ndarray           # (K,)
    logprobs: np.ndarray          # (K,) cumulative log-probs (beam family)
    n_calls: int                  # decoder forward passes while resident
    accepted: int                 # committed draft tokens
    arrival: float                # s (realtime) | steps (closed loop)
    admitted: float
    completed: float
    mode: Hashable = None         # slot group the request was served by
    status: RequestStatus = RequestStatus.FINISHED
    retry_after: float | None = None   # SHED backoff hint

    @property
    def latency(self) -> float:
        return self.completed - self.arrival

    @property
    def queue_delay(self) -> float:
        return self.admitted - self.arrival


def _default_finished(state) -> np.ndarray:
    """(n_slots,) bool per global slot for a plain single-group session."""
    return state.finished.cpu().numpy().all(axis=1)


class ContinuousScheduler:
    """S-slot continuous batching over engine-supplied session callables.

    admit(state, slot:int, payload) -> state     (supplied by the engine)
    step(state) -> state                          (supplied by the engine)

    Optional batched admission:
    admit_flush(state) -> state      called once at the end of an
                                     admission pass that admitted anything,
                                     after its admissions and preemptions:
                                     the device work of the admissions,
                                     batched. A ``release`` of a slot whose
                                     admission is not flushed yet must drop
                                     it.

    Optional mode mixing:
    groups: {mode: [global slot ids]}    per-mode slot groups/free lists;
                                         default one anonymous group over
                                         ``spec.n_slots`` slots
    finished(state) -> (n_slots,) bool   per-global-slot finished mask
                                         (grouped engines supply one that
                                         spans their group states)

    Optional memory-aware hooks (paged KV cache):
    admit_ok(state, mode) -> bool    gate admissions on free pages
    pre_step(state) -> state         page-table maintenance; may raise
                                     ``PoolExhausted`` -> preemption
    release(state, slot) -> state    eviction (default: core release_slot;
                                     paged engines also unmap the slot)
    reclaim() -> bool                free reclaimable (non-resident) pages
                                     — e.g. cached prefix pages — tried
                                     BEFORE preempting a resident request
                                     under pool pressure; True = progress

    Optional sharded placement (mesh engines):
    place(mode, free, payload) -> slot|None
                                     pick THE slot for the group's head
                                     request from its free list (prefix
                                     affinity / least-loaded shard), or
                                     None to hold the whole group this
                                     iteration (every shard full). When
                                     supplied it subsumes ``admit_ok``.
    shards: {global slot: shard id}  lets pool-pressure preemption pick
                                     its victim from the exhausted shard
                                     (replay stays shard-local)
    sync_clock(t) -> t               the realtime serving clock as every
                                     rank of a mesh must see it (rank 0's,
                                     broadcast)

    ``tracer``: the ``repro_torch.serving.trace.Tracer`` the scheduler's
    spans go to (``expire``, ``admit`` (one a request, and one without a
    request id around ``admit_flush``), ``readout``, ``release``,
    ``queued``); default one of its own, off.
    """

    def __init__(self, spec: SessionSpec, state, *,
                 admit: Callable, step: Callable,
                 admit_flush: Callable | None = None,
                 admit_ok: Callable | None = None,
                 pre_step: Callable | None = None,
                 release: Callable = release_slot,
                 groups: dict[Hashable, list[int]] | None = None,
                 finished: Callable | None = None,
                 dispatch: Callable | None = None,
                 sync: Callable | None = None,
                 reclaim: Callable | None = None,
                 place: Callable | None = None,
                 shards: dict[int, int] | None = None,
                 sync_clock: Callable | None = None,
                 policy: OverloadPolicy | None = None,
                 tracer: Tracer | None = None):
        self.spec = spec
        self.state = state
        self.policy = policy or OverloadPolicy()
        self.tracer = tracer or Tracer()
        self._admit = admit
        self._admit_flush = admit_flush
        self._step = step
        self._admit_ok = admit_ok
        self._pre_step = pre_step
        self._release = release
        self._dispatch = dispatch
        self._sync = sync
        self._reclaim = reclaim
        self._place = place
        self._slot_shard = shards or {}
        self._sync_clock = sync_clock
        self._finished = finished or _default_finished
        if groups is None:
            groups = {None: list(range(spec.n_slots))}
        self._slot_key = {s: k for k, slots in groups.items() for s in slots}
        if len(self._slot_key) != sum(len(v) for v in groups.values()):
            raise ValueError("slot groups must be disjoint")
        self._free = {k: sorted(slots) for k, slots in groups.items()}
        # two-stage per-group queues: ``_future`` holds not-yet-arrived
        # requests ordered by arrival; once arrived they promote into
        # ``_ready`` ordered by the scheduling key (priority/EDF/FIFO).
        # Cancellation is lazy (flag + live counter), so cancelling deep in
        # a backlog is O(1) and stale entries drop at the next head pop.
        self._future: dict[Hashable, list] = {k: [] for k in groups}
        self._ready: dict[Hashable, list] = {k: [] for k in groups}
        self._n_queued: dict[Hashable, int] = {k: 0 for k in groups}
        self._resident: dict[int, ScheduledRequest] = {}   # slot -> request
        self._admit_time: dict[int, float] = {}
        self._queued_by_rid: dict[int, ScheduledRequest] = {}
        self._next_rid = 0
        self._next_seq = 0
        self.n_steps = 0
        self.n_preemptions = 0
        self.n_cancelled = 0
        self.n_expired = 0
        self.n_shed = 0
        self.max_resident = 0
        self._skipped = 0.0   # closed-loop clock offset from idle jumps
        self._now = 0.0       # last serving-clock reading (for cancel())
        self.draining = False   # True: every submission sheds (shutdown)
        self._shed_events: list[SlotResult] = []   # drained by the engine
        # per-group EWMA of (completed - admitted) service time, feeding
        # the retry_after estimate on shed records
        self._ewma_service: dict[Hashable, float] = {}
        self._group_width = {k: max(1, len(v)) for k, v in groups.items()}

    # ------------------------------------------------------------------ API
    def submit(self, payload, *, arrival: float = 0.0, rid=None,
               mode: Hashable = None, priority: int = 0,
               deadline: float | None = None) -> int:
        if mode is None and len(self._future) == 1:
            mode = next(iter(self._future))
        if mode not in self._future:
            raise KeyError(f"unknown mode {mode!r}; "
                           f"groups: {list(self._future)}")
        if rid is None:
            rid = self._next_rid
        elif rid < self._next_rid:
            # auto-assigned ids count up from 0; reusing one would make two
            # results collide in any {rid: result} view
            raise ValueError(f"rid {rid} may already be in use; "
                             f"pass rid >= {self._next_rid} or omit it")
        self._next_rid = max(self._next_rid, rid) + 1
        req = ScheduledRequest(rid=rid, payload=payload, arrival=arrival,
                               mode=mode, priority=priority,
                               deadline=deadline, seq=self._next_seq)
        self._next_seq += 1
        depth = self.policy.shed_depth
        if self.draining or (depth is not None
                             and self._n_queued[mode] >= depth):
            self._shed(req)
        else:
            self._enqueue(req)
        return rid

    def _shed(self, req: ScheduledRequest) -> None:
        """Refuse a submission with a terminal SHED record (never queued,
        never a slot). Records accumulate until the engine drains them
        (``drain_shed``) into its done-buffer, so ``RequestHandle.status``
        flips to SHED synchronously with ``submit()``."""
        self.n_shed += 1
        self._shed_events.append(self._terminal(
            req, RequestStatus.SHED, now=self._now,
            retry_after=self.retry_after_estimate(req.mode)))

    def drain_shed(self) -> list[SlotResult]:
        """Hand off (and clear) the SHED records produced since the last
        drain — called by the engine after every submit/shed_queued."""
        out, self._shed_events = self._shed_events, []
        return out

    def retry_after_estimate(self, mode: Hashable) -> float:
        """Backoff hint for a shed request: roughly when today's backlog
        will have cleared — queue depth over group width, times the
        group's EWMA service time (prior: the compile ceiling ``max_new``,
        one step per token — exact for closed-loop greedy, pessimistic
        otherwise until real completions tighten it)."""
        fixed = self.policy.shed_retry_after
        if fixed is not None:
            return fixed
        svc = self._ewma_service.get(
            mode, float(getattr(self.spec, "max_new", 1) or 1))
        waves = 1.0 + self._n_queued[mode] / self._group_width[mode]
        return waves * svc

    def _enqueue(self, req: ScheduledRequest) -> None:
        if req.arrival > self._now:
            heapq.heappush(self._future[req.mode],
                           (req.arrival, req.seq, req))
        else:
            heapq.heappush(self._ready[req.mode],
                           (self._key(req), req.seq, req))
        self._n_queued[req.mode] += 1
        self._queued_by_rid[req.rid] = req
        if self.tracer.on:
            req.queued_ns = time.perf_counter_ns()

    def _key(self, req: ScheduledRequest, now: float | None = None):
        """Ready-queue key against the current clock (aging-aware)."""
        return req.key_at(self._now if now is None else now,
                          self.policy.aging_rate)

    @property
    def queued(self) -> int:
        return sum(self._n_queued.values())

    @property
    def pending(self) -> int:
        return self.queued + len(self._resident)

    def cancel(self, rid: int) -> SlotResult | None:
        """Abandon a request: a queued one is dequeued immediately, a
        resident one is evicted (slot released, pages unmapped for the
        allocator's next reclaim). Returns the terminal
        ``status="cancelled"`` record, or None when the rid is unknown or
        already terminal — finished results are never retracted."""
        req = self._queued_by_rid.get(rid)
        if req is not None:
            req.cancelled = True
            del self._queued_by_rid[rid]
            self._n_queued[req.mode] -= 1
            self.n_cancelled += 1
            return self._terminal(req, RequestStatus.CANCELLED,
                                  now=self._now)
        for slot, req in self._resident.items():
            if req.rid == rid:
                req, admitted = self._evict(slot)
                self.n_cancelled += 1
                return self._terminal(req, RequestStatus.CANCELLED,
                                      now=self._now, admitted=admitted)
        return None

    def shed_queued(self) -> list[SlotResult]:
        """Drain support: refuse EVERY queued (non-resident) request with
        a terminal SHED record + retry hint, leaving residents to finish.
        Returns the records (also mirrored into ``drain_shed``'s buffer is
        NOT done — the caller owns delivery)."""
        out: list[SlotResult] = []
        for mode in self._future:
            for q in (self._future[mode], self._ready[mode]):
                for _, _, req in q:
                    if req.cancelled:
                        continue
                    req.cancelled = True   # stale heap entries drop lazily
                    self._queued_by_rid.pop(req.rid, None)
                    self._n_queued[mode] -= 1
                    self.n_shed += 1
                    out.append(self._terminal(
                        req, RequestStatus.SHED, now=self._now,
                        retry_after=self.retry_after_estimate(mode)))
                q.clear()
        return out

    # ------------------------------------------------------------ internals
    def _evict(self, slot: int) -> tuple[ScheduledRequest, float]:
        """Remove a resident request from its slot: release the session
        state (paged engines unmap the slot's rows here, so the
        allocator's next reclaim returns its whole footprint) and return
        the slot to its group's free list. The single eviction sequence
        behind cancellation, deadline expiry, and preemption."""
        req = self._resident.pop(slot)
        admitted = self._admit_time.pop(slot)
        with self.tracer.span("release", req.rid):
            self.state = self._release(self.state, slot)
        self._return_slot(slot)
        return req, admitted

    def _terminal(self, req: ScheduledRequest, status: RequestStatus, *,
                  now: float, admitted: float | None = None,
                  retry_after: float | None = None) -> SlotResult:
        # a never-admitted request (cancelled/expired in the queue) stamps
        # admitted/completed no earlier than its arrival, so queue_delay
        # and latency are never negative in aggregate views
        floor = max(now, req.arrival)
        return SlotResult(
            rid=req.rid, tokens=np.zeros((1, 0), np.int32),
            lengths=np.zeros((1,), np.int32),
            logprobs=np.zeros((1,), np.float32), n_calls=0, accepted=0,
            arrival=req.arrival,
            admitted=floor if admitted is None else admitted,
            completed=floor, mode=req.mode, status=status,
            retry_after=retry_after)

    def _promote(self, now: float) -> None:
        """Move arrived requests from the arrival-ordered stage into the
        priority-ordered ready stage (dropping cancelled ones)."""
        for mode, fut in self._future.items():
            while fut and fut[0][0] <= now:
                _, _, req = heapq.heappop(fut)
                if req.cancelled:
                    continue
                heapq.heappush(self._ready[mode],
                               (self._key(req, now), req.seq, req))

    def _reage(self, now: float) -> None:
        """Aging makes ready-queue keys time-dependent: rebuild every
        group's heap against the current clock so the head really is the
        highest-effective-priority request. O(n log n) per pass over the
        queued set — the queue is bounded by ``shed_depth`` whenever
        aging matters, and the rebuild is what makes starvation freedom
        deterministic rather than heuristic."""
        if self.policy.aging_rate <= 0.0:
            return
        for mode, q in self._ready.items():
            if len(q) > 1:
                fresh = [(self._key(req, now), req.seq, req)
                         for _, _, req in q if not req.cancelled]
                heapq.heapify(fresh)
                self._ready[mode] = fresh

    def _ready_head(self, mode, now: float,
                    events: list | None = None) -> ScheduledRequest | None:
        """Live head of a group's ready queue: drops cancelled entries and
        expires deadline-passed ones (appending their terminal records to
        ``events``) until a runnable request (or nothing) remains."""
        q = self._ready[mode]
        while q:
            req = q[0][2]
            if req.cancelled:
                heapq.heappop(q)
                continue
            if req.deadline is not None and req.deadline <= now:
                heapq.heappop(q)
                self._queued_by_rid.pop(req.rid, None)
                self._n_queued[mode] -= 1
                self.n_expired += 1
                if events is not None:
                    events.append(self._terminal(
                        req, RequestStatus.EXPIRED, now=now))
                continue
            return req
        return None

    def _heads_ready(self, now: float, events: list):
        """Admissible head request of every group with a free slot, best
        scheduling key first (priority desc / EDF / FIFO; group declaration
        order only breaks exact ties)."""
        out = []
        for gi, mode in enumerate(self._future):
            if not self._free[mode]:
                continue
            req = self._ready_head(mode, now, events)
            if req is not None:
                out.append((self._key(req, now), gi, mode))
        out.sort()
        return out

    def _next_arrival(self) -> float | None:
        """Earliest time anything queued could be admitted (ready heads
        count as their own arrival, which is already <= now)."""
        arr = []
        for mode in self._future:
            fut = self._future[mode]
            while fut and fut[0][2].cancelled:
                heapq.heappop(fut)
            if fut:
                arr.append(fut[0][0])
            req = self._ready_head(mode, -math.inf)  # no expiry side effects
            if req is not None:
                arr.append(req.arrival)
        return min(arr) if arr else None

    def _pop_head(self, mode) -> ScheduledRequest:
        _, _, req = heapq.heappop(self._ready[mode])
        self._queued_by_rid.pop(req.rid, None)
        self._n_queued[mode] -= 1
        return req

    def _requeue_front(self, req: ScheduledRequest) -> None:
        """Requeue a preempted request at the head of its own priority
        class (``boost``) in its OWN group's queue — the mode tag rides on
        the request, so a preempted beam expansion can never restart in a
        greedy slot, and a same-priority newcomer can never leapfrog it."""
        req.boost = 1
        self._enqueue(req)

    def _admit_ready(self, now: float, events: list) -> None:
        self._promote(now)
        self._reage(now)
        n_admitted = 0
        while True:
            admitted = True
            while admitted:
                admitted = False
                for _, _, mode in self._heads_ready(now, events):
                    if self._place is not None:
                        # sharded engines pick THE slot (prefix-affine /
                        # least-loaded shard, per-shard page gate folded in)
                        head = self._ready_head(mode, now, events)
                        slot = (None if head is None else self._place(
                            mode, list(self._free[mode]), head.payload))
                        if slot is None:
                            continue   # every shard full: try other groups
                        self._free[mode].remove(slot)
                    else:
                        if (self._admit_ok is not None
                                and not self._admit_ok(self.state, mode)):
                            continue   # pool pressure: try other groups
                        slot = self._free[mode].pop(0)
                    req = self._pop_head(mode)
                    if req.queued_ns:
                        if self.tracer.on:
                            self.tracer.record(
                                "queued", req.queued_ns,
                                time.perf_counter_ns(), rid=req.rid)
                        req.queued_ns = 0
                    with self.tracer.span("admit", req.rid):
                        self.state = self._admit(self.state, slot,
                                                 req.payload)
                    self._resident[slot] = req
                    self._admit_time[slot] = now
                    n_admitted += 1
                    admitted = True   # state changed: recompute candidates
                    break
            # free slots exhausted: an urgent head may still evict the
            # most-slack resident; loop back so it admits into the freed
            # slot through the normal (admit_ok-gated) path above
            if not self._preempt_for_urgent(now, events):
                break
        if n_admitted and self._admit_flush is not None:
            # the device work of the whole pass at once, before the drive
            # waits on the in-flight step
            with self.tracer.span("admit"):
                self.state = self._admit_flush(self.state)
        self.max_resident = max(self.max_resident, len(self._resident))

    def _preempt_for_urgent(self, now: float, events: list) -> bool:
        """Deadline-aware preemption (``OverloadPolicy``): for each group
        whose free list is empty but whose queue head is URGENT relative
        to a resident — strictly higher effective priority, or a deadline
        tighter than the resident's slack by more than the margin — evict
        the resident with the MOST deadline slack (ties: youngest, least
        work lost) through the standard eviction sequence and requeue it
        WITHOUT the preemption boost: its own lax deadline keys it after
        the urgent work, so it cannot turn around and preempt its
        preemptor (no thrash). Replay is deterministic — the victim
        restarts from scratch later with identical tokens. At most one
        eviction per call; returns True if one happened."""
        pol = self.policy
        if not pol.deadline_preemption:
            return False
        for mode in self._future:
            if self._free[mode]:
                continue
            head = self._ready_head(mode, now, events)
            if head is None:
                continue
            hp = head.eff_priority(now, pol.aging_rate)
            h_slack = (math.inf if head.deadline is None
                       else head.deadline - now)
            best = None
            for slot, res in self._resident.items():
                if self._slot_key[slot] != mode:
                    continue
                vp = res.eff_priority(self._admit_time[slot],
                                      pol.aging_rate)
                v_slack = (math.inf if res.deadline is None
                           else res.deadline - now)
                urgent = hp > vp or (
                    hp >= vp and h_slack < v_slack - pol.preempt_slack_margin)
                # the no-churn invariant: once requeued (boost stripped),
                # the victim must key strictly AFTER the head, or we would
                # just re-admit it into the slot we freed
                vkey = dataclasses.replace(res, boost=0).key_at(
                    now, pol.aging_rate)
                if urgent and self._key(head, now) < vkey:
                    cand = (v_slack, self._admit_time[slot], slot)
                    if best is None or cand > best:
                        best = cand
            if best is not None:
                req, _ = self._evict(best[2])
                req.boost = 0
                self._enqueue(req)
                self.n_preemptions += 1
                return True
        return False

    def _expire_residents(self, now: float, events: list) -> None:
        """Evict resident requests whose deadline has passed — their slot
        (and pages) free up for the backlog; co-resident slots never
        notice (row independence)."""
        expired = [s for s, r in self._resident.items()
                   if r.deadline is not None and r.deadline <= now]
        for slot in expired:
            req, admitted = self._evict(slot)
            self.n_expired += 1
            events.append(self._terminal(req, RequestStatus.EXPIRED,
                                         now=now, admitted=admitted))

    def _preempt_youngest(self, prefer: Hashable | None = None,
                          shard: int | None = None) -> None:
        """Kick a most recently admitted request back to its queue head;
        its pages are reclaimed and it restarts from scratch later (decoding
        is deterministic, so its tokens are unchanged — only latency pays).
        ``prefer`` names the slot group that exhausted the pool: a victim is
        taken from that group first so one mode's burst cannot evict another
        mode's residents while it still has residents of its own. ``shard``
        narrows the hunt further to the exhausted page-pool shard — evicting
        elsewhere frees pages the short shard cannot use, so the replay
        would exhaust again and the loop would thrash through innocents."""
        pool = list(self._resident)
        if shard is not None:
            local = [s for s in pool if self._slot_shard.get(s) == shard]
            if local:
                pool = local
        group = [s for s in pool if self._slot_key[s] == prefer]
        if group:
            pool = group
        slot = max(pool, key=lambda s: (self._admit_time[s], s))
        req, _ = self._evict(slot)
        self._requeue_front(req)
        self.n_preemptions += 1

    def _resident_in_shard(self, shard: int | None) -> int:
        """Residents whose eviction could relieve pressure on ``shard``
        (all of them when the exhaustion is not shard-attributed)."""
        if shard is None or not self._slot_shard:
            return len(self._resident)
        return sum(1 for s in self._resident
                   if self._slot_shard.get(s) == shard)

    def _return_slot(self, slot: int) -> None:
        free = self._free[self._slot_key[slot]]
        free.append(slot)
        free.sort()

    def _prepare(self) -> None:
        if self._pre_step is None:
            return
        while True:
            try:
                self.state = self._pre_step(self.state)
                return
            except PoolExhausted as e:
                if self._reclaim is not None and self._reclaim():
                    continue   # cached pages freed: replay with no victim
                shard = getattr(e, "shard", None)
                if self._resident_in_shard(shard) <= 1:
                    raise  # pool below one request's worst case (validated
                           # at allocator construction; unreachable there
                           # unless retained pages were held — reclaimed
                           # above)
                prefer = e.group if e.group in self._future else None
                self._preempt_youngest(prefer, shard=shard)

    def _evict_finished(self, now: float, read_slot,
                        mask=None) -> list[SlotResult]:
        if not self._resident:
            return []
        finished = self._finished(self.state) if mask is None else mask
        done, results = [s for s in self._resident if finished[s]], []
        for slot in done:
            # read while the slot is still resident: the engine's read_slot
            # looks up the request's per-request params to trim the view
            with self.tracer.span("readout", self._resident[slot].rid):
                fields = read_slot(self.state, slot)
            req, admitted = self._evict(slot)
            service = max(0.0, now - admitted)
            prev = self._ewma_service.get(req.mode)
            self._ewma_service[req.mode] = (
                service if prev is None else 0.8 * prev + 0.2 * service)
            results.append(SlotResult(
                rid=req.rid, arrival=req.arrival, mode=req.mode,
                admitted=admitted, completed=now, **fields))
        return results

    def _wall_clock(self, t0: float):
        """Seconds since ``t0``; through ``sync_clock`` when there is one."""
        if self._sync_clock is None:
            return lambda: time.perf_counter() - t0
        return lambda: self._sync_clock(time.perf_counter() - t0)

    def _rewind_clock(self) -> None:
        """Each drive restarts the serving clock at 0, but submissions made
        between drives were staged against the PREVIOUS drive's final
        clock. Re-stage them: anything with a future arrival (relative to
        the new clock origin) moves back to the arrival-ordered stage so
        its delay is honored."""
        self._now = 0.0
        for mode, q in self._ready.items():
            keep = []
            while q:
                req = heapq.heappop(q)[2]
                if not req.cancelled:
                    keep.append(req)
            for req in keep:
                if req.arrival > 0.0 and not req.boost:
                    heapq.heappush(self._future[mode],
                                   (req.arrival, req.seq, req))
                else:
                    heapq.heappush(q, (self._key(req, 0.0), req.seq, req))

    # ---------------------------------------------------------------- drive
    def steps(self, read_slot: Callable, *, realtime: bool = False):
        """Step-driven serving core: one scheduler iteration per ``next()``
        — expiry, admissions, page maintenance, ONE session step,
        evictions — yielding the iteration's terminal ``SlotResult``s
        (often empty). The engine's streaming layer reads committed-token
        deltas between iterations; ``run()`` is the draining wrapper.

        ``realtime=False``: closed loop — arrival times are DECODE-STEP
        counts (deterministic mid-stream admission, the unit tests' mode),
        and the clock fast-forwards over idle gaps.
        ``realtime=True``: open loop — arrival times are wall-clock seconds
        since the drive started; requests are held back until they
        "arrive" (the throughput benchmark's Poisson stream).

        Engines that supply ``dispatch``/``sync`` hooks get the
        dispatch-ahead (double-buffered) drive instead: iteration k's
        device step stays in flight while the host runs iteration k+1's
        expiry/admission/staging, synchronizing only on the step's small
        output bundle (``_steps_pipelined``)."""
        if self._dispatch is not None:
            return self._steps_pipelined(read_slot, realtime=realtime)
        return self._steps_legacy(read_slot, realtime=realtime)

    def _steps_legacy(self, read_slot: Callable, *, realtime: bool = False):
        t0 = time.perf_counter()
        step0, skip0 = self.n_steps, self._skipped   # drive-relative clock
        clock = (self._wall_clock(t0) if realtime
                 else (lambda: float(self.n_steps - step0)
                       + (self._skipped - skip0)))
        self._rewind_clock()
        while self.queued or self._resident:
            self._now = now = clock()
            events: list[SlotResult] = []
            with self.tracer.span("expire"):
                self._expire_residents(now, events)
            nxt = self._next_arrival()
            if (not self._resident and nxt is not None and not realtime
                    and nxt > now):
                # idle: fast-forward the clock to the next arrival (persisted
                # in the offset so admitted/completed stamps stay monotone)
                self._skipped += nxt - now
                self._now = now = clock()
            self._admit_ready(now, events)
            if not self._resident:
                if realtime and nxt is not None:
                    # nothing can change until the head arrives: sleep it off
                    time.sleep(max(0.0, nxt - now))
                if events:
                    yield events
                continue
            self._prepare()
            self.state = self._step(self.state)
            self.n_steps += 1
            self._now = done_t = clock()
            events.extend(self._evict_finished(done_t, read_slot))
            yield events

    def _steps_pipelined(self, read_slot: Callable, *,
                         realtime: bool = False):
        """Dispatch-ahead drive: the device step for iteration k is IN
        FLIGHT while the host expires, admits, and stages iteration k+1 —
        the only blocking point is the in-flight step's small output
        bundle (finished mask / committed counts / page counters), which
        the ``sync`` hook reads one iteration later.

        ``dispatch(state) -> state`` issues the engine's fused megastep
        (asynchronous on the card's stream) and stashes the
        bundle's futures; ``sync() -> dict`` blocks on them and returns
        ``finished`` (an (n_slots,) bool mask valid for the residents of
        the dispatched iteration) plus ``exhausted``/``group`` when the
        on-device page pool could not cover the step. An exhausted step
        applied NOTHING (the megastep is predicated on the device flag),
        so the preempt-and-replay loop below re-dispatches the identical
        iteration against the shrunken resident set — the same
        deterministic replay semantics as the host-side ``_prepare``.

        Relative to the legacy drive, a slot freed by step k is re-usable
        one iteration later (its eviction is observed at k+1's sync, after
        k+1's admissions) — admission *stamps* are unchanged (the clock
        only advances at syncs), completion stamps shift uniformly."""
        t0 = time.perf_counter()
        step0, skip0 = self.n_steps, self._skipped
        clock = (self._wall_clock(t0) if realtime
                 else (lambda: float(self.n_steps - step0)
                       + (self._skipped - skip0)))
        self._rewind_clock()
        inflight = False
        while self.queued or self._resident or inflight:
            self._now = now = clock()
            events: list[SlotResult] = []
            with self.tracer.span("expire"):
                self._expire_residents(now, events)
            nxt = self._next_arrival()
            if (not self._resident and not inflight and nxt is not None
                    and not realtime and nxt > now):
                self._skipped += nxt - now
                self._now = now = clock()
            self._admit_ready(now, events)
            if inflight:
                out = self._sync()
                while out.get("exhausted"):
                    # retained (prefix-cache) pages are the cheapest thing
                    # to give back — reclaim before preempting live work,
                    # and before concluding a single resident cannot fit
                    shard = out.get("shard")
                    if self._reclaim is not None and self._reclaim():
                        pass
                    elif self._resident_in_shard(shard) <= 1:
                        raise PoolExhausted(
                            "page pool exhausted with a single resident "
                            "request (pool below one slot's worst case is "
                            "rejected at allocator construction)",
                            shard=shard)
                    else:
                        prefer = out.get("group")
                        self._preempt_youngest(
                            prefer if prefer in self._future else None,
                            shard=shard)
                    self.state = self._dispatch(self.state)
                    out = self._sync()
                inflight = False
                self.n_steps += 1
                self._now = done_t = clock()
                events.extend(self._evict_finished(done_t, read_slot,
                                                   mask=out["finished"]))
            if self._resident:
                self.state = self._dispatch(self.state)
                inflight = True
            elif realtime and nxt is not None:
                # nothing resident or in flight: sleep off the idle gap
                time.sleep(max(0.0, nxt - clock()))
            yield events

    def run(self, read_slot: Callable, *,
            realtime: bool = False) -> list[SlotResult]:
        """Drain the queue: drive ``steps()`` to exhaustion and return
        every terminal record (finished, cancelled-while-running via the
        engine, expired)."""
        return [r for events in self.steps(read_slot, realtime=realtime)
                for r in events]
