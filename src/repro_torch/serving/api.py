"""Request-level serving API — the StreamingEngine's front door (the port
of ``repro.serving.api``; host code, whose only tensors are the slot
params of ``ResolvedParams.device_args``).

The engine's shape surface (``EngineConfig`` + per-group ``SessionSpec``)
fixes CEILINGS: slot counts, the widest beam, the longest
draft, the largest token budget. Real CASP traffic — a retrosynthesis
search tree firing thousands of single-step calls with wildly different
beam widths, token budgets, and urgencies, abandoning branches as soon as
a better route appears — needs *per-request* control under those ceilings.
This module is that contract:

``GenerationParams``
    Per-request decode knobs (``max_new``, ``draft_len``, ``n_drafts``,
    ``n_beams``, extra ``stop_ids``), each validated against the owning
    slot group's ceilings at submit time. Ragged values ride in
    ``SessionState`` tensors (``repro_torch.core.session``), so they
    change no tensor shape.

``RequestSpec``
    A full request: payload + params + scheduling metadata (``priority``
    — higher admitted first among arrived requests; ``deadline`` — the
    request expires, queued or resident, once the serving clock passes
    it; ``arrival`` — open/closed-loop arrival time).

``RequestHandle``
    Returned by ``StreamingEngine.submit()``. An ``int`` subclass (it IS
    the request id, so every pre-existing ``{rid: SlotResult}`` workflow
    keeps working) exposing the per-request control surface:

      ``.result()``   drive the engine until this request finishes and
                      return its ``SlotResult`` (raises
                      ``RequestCancelled`` if it was cancelled/expired)
      ``.stream()``   iterate incremental committed-token deltas as
                      scheduler iterations complete (greedy-family modes
                      stream mid-flight; beam modes deliver the winning
                      beam once, at completion — beams reorder freely
                      until then, so mid-flight deltas would lie)
      ``.cancel()``   queued: dequeue; resident: evict the slot and
                      reclaim its pages mid-flight — co-resident requests
                      are unaffected (row-independence invariant)
      ``.status``     a ``RequestStatus`` — QUEUED | RUNNING | FINISHED |
                      CANCELLED | EXPIRED | SHED | UNKNOWN (not in this
                      session: the engine was reset() or the terminal
                      record aged out)

The blocking calls all drive ONE engine pump (``serve_steps``), so
``h.result()``, ``h.stream()``, and ``engine.serve()`` compose freely on
a single session.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Iterator

import numpy as np
import torch

# per-slot extra stop ids the engine keeps room for (SessionSpec.n_stop
# ceiling); requests may use any subset, -1 marks unused entries
MAX_STOP_IDS = 4


class RequestStatus(str, enum.Enum):
    """Lifecycle of a request, shared by the scheduler's terminal records
    (``SlotResult.status``), ``RequestHandle.status``, and the SSE wire
    format. A ``str`` subclass, so JSON serialization and equality against
    the literal value (``status == "finished"``) both work.

    Terminal states: FINISHED | CANCELLED | EXPIRED | SHED | LOST.
    Live states: QUEUED | RUNNING. UNKNOWN means "not in this session"
    (the engine was ``reset()`` or the terminal record aged out of the
    bounded done-buffer). LOST is the fleet router's retryable terminal:
    the replica serving the request died after tokens had already been
    delivered, so a transparent reroute would duplicate the stream — the
    client owns the retry (``retry_after`` rides on the wire event)."""

    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    EXPIRED = "expired"
    SHED = "shed"
    LOST = "lost"
    UNKNOWN = "unknown"

    @property
    def terminal(self) -> bool:
        return self not in (RequestStatus.QUEUED, RequestStatus.RUNNING)

    def __str__(self) -> str:  # f"{status}" == status.value, not the repr
        return self.value


class RequestCancelled(RuntimeError):
    """Raised by ``RequestHandle.result()``/``.stream()`` when the request
    was cancelled (``reason="cancelled"``) or missed its deadline
    (``reason="expired"``) instead of finishing."""

    def __init__(self, rid: int, reason: str):
        super().__init__(f"request {rid} {reason}")
        self.rid = rid
        self.reason = str(reason)


class RequestRejected(RequestCancelled):
    """Raised by ``RequestHandle.result()``/``.stream()`` when the engine
    refused to run the request at all: load-shed under overload
    (``reason="shed"``) or expired before ever holding a slot
    (``reason="expired"``). ``retry_after`` carries the scheduler's
    backoff estimate in serving-clock units (steps closed-loop, seconds
    realtime; ``None`` when no estimate applies) — a front door relays it
    as the retry hint. Subclasses ``RequestCancelled``, so pre-existing
    handlers keep working."""

    def __init__(self, rid: int, reason: str,
                 retry_after: float | None = None):
        super().__init__(rid, reason)
        self.retry_after = retry_after


@dataclasses.dataclass(frozen=True)
class GenerationParams:
    """Per-request decode knobs; ``None`` = the owning group's ceiling.

    Every value must fit under the group's shape ceiling
    (``resolve`` validates), which is what keeps ragged params free: a
    smaller ``max_new`` / ``draft_len`` / ``n_drafts`` / ``n_beams`` is a
    masked no-op inside the same step, never a new tensor shape."""

    max_new: int | None = None        # token budget
    draft_len: int | None = None      # speculative draft window
    n_drafts: int | None = None       # drafts verified per step
    n_beams: int | None = None        # beam width (beam-family groups)
    stop_ids: tuple[int, ...] = ()    # extra stop tokens (EOS always stops)

    def resolve(self, spec) -> "ResolvedParams":
        """Validate against a ``SessionSpec``'s ceilings and fill defaults."""

        def pick(name, value, ceiling, lo):
            if value is None:
                return ceiling
            if not lo <= value <= ceiling:
                raise ValueError(
                    f"GenerationParams.{name}={value} outside "
                    f"[{lo}, {ceiling}] (the slot group's shape "
                    f"ceiling; raise EngineConfig.{name} to serve larger "
                    f"requests)")
            return int(value)

        stop = tuple(int(t) for t in self.stop_ids)
        if len(stop) > spec.n_stop:
            raise ValueError(
                f"{len(stop)} stop_ids exceed the session's n_stop="
                f"{spec.n_stop} ceiling")
        if any(t < 0 for t in stop):
            raise ValueError(f"stop_ids must be non-negative, got {stop}")
        return ResolvedParams(
            max_new=pick("max_new", self.max_new, spec.max_new, 1),
            draft_len=pick("draft_len", self.draft_len, spec.draft_len, 0),
            n_drafts=pick("n_drafts", self.n_drafts, spec.n_drafts, 1),
            n_beams=pick("n_beams", self.n_beams, spec.n_beams, 1),
            stop_ids=stop)


@dataclasses.dataclass(frozen=True)
class ResolvedParams:
    """``GenerationParams`` with defaults filled from a group's spec —
    what backends consume for host-side prep (draft extraction) and what
    the jitted admit writes into the slot's device params."""

    max_new: int
    draft_len: int
    n_drafts: int
    n_beams: int
    stop_ids: tuple[int, ...]

    def device_args(self, spec) -> tuple:
        """The slot params for ``reset_slot``: (max_out, stop_ids (n_stop,)
        int32 tensor, -1 = unused, eff_dl, eff_beams)."""
        stop = torch.full((spec.n_stop,), -1, dtype=torch.int32)
        stop[:len(self.stop_ids)] = torch.tensor(self.stop_ids,
                                                 dtype=torch.int32)
        return (self.max_new, stop, self.draft_len, self.n_beams)


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """THE request object — one fully-specified request for
    ``StreamingEngine.submit_spec`` (the canonical entry point;
    ``engine.submit(query, ...)`` is thin sugar that builds one of these).

    ``priority``: higher runs first among arrived requests (FIFO within a
    priority class). ``deadline``: serving-clock time (steps closed-loop,
    seconds realtime) after which the request expires instead of running.
    ``tenant``: opaque accounting label — the engine ignores it (the JAX
    package's network front door enforces quotas on it)."""

    query: Any
    params: GenerationParams = GenerationParams()
    mode: str | None = None
    priority: int = 0
    deadline: float | None = None
    arrival: float = 0.0
    tenant: str | None = None


class RequestHandle(int):
    """The live view of a submitted request. ``int(handle)`` is the
    request id (and the handle hashes/compares as that id), so it drops
    into every ``{rid: SlotResult}`` map the engine returns."""

    def __new__(cls, rid: int, engine, *, mode=None,
                params: "ResolvedParams | None" = None):
        self = super().__new__(cls, rid)
        self._engine = engine
        self.mode = mode
        self.params = params
        return self

    @property
    def rid(self) -> int:
        return int(self)

    # ------------------------------------------------------------- queries
    @property
    def status(self) -> "RequestStatus":
        return self._engine.request_status(self.rid)

    def done(self) -> bool:
        """True once the request can make no further progress — finished,
        cancelled, expired, shed, or no longer part of the session
        ("unknown", e.g. after ``engine.reset()``)."""
        return self.status not in (RequestStatus.QUEUED,
                                   RequestStatus.RUNNING)

    # ------------------------------------------------------------- control
    def result(self):
        """Drive the engine until this request terminates; return its
        ``SlotResult``. Raises ``RequestRejected`` (with ``retry_after``)
        when the engine refused to run it — load-shed, or expired in the
        queue — and ``RequestCancelled`` on cancel / mid-flight expiry."""
        r = self._engine.wait(self.rid)
        if r.status in (RequestStatus.SHED, RequestStatus.EXPIRED):
            raise RequestRejected(self.rid, r.status,
                                  retry_after=r.retry_after)
        if r.status != RequestStatus.FINISHED:
            raise RequestCancelled(self.rid, r.status)
        return r

    def stream(self) -> Iterator[np.ndarray]:
        """Yield committed-token deltas (1-D int32 arrays) as scheduler
        iterations complete, ending when the request finishes. Concatenated
        deltas equal ``result().tokens[0][:lengths[0]]`` exactly."""
        return self._engine._stream(self.rid)

    def cancel(self, recursive: bool = False) -> bool:
        """Abandon the request: dequeue if queued, evict + reclaim pages
        if resident. Returns False when it already reached a terminal
        state (finished results stay available).

        ``recursive=True`` prunes the whole request subtree rooted here
        (every descendant made via ``submit_child``): the planner's
        abandon-this-branch operation. Returns True if ANY request in the
        subtree was newly cancelled."""
        if recursive:
            return self._engine.cancel_subtree(self.rid) > 0
        return self._engine._cancel(self.rid)

    def submit_child(self, suffix, *, arrival: float = 0.0,
                     mode: str | None = None,
                     params: "GenerationParams | None" = None,
                     priority: int | None = None,
                     deadline: float | None = None) -> "RequestHandle":
        """Submit a child request whose query is this request's query plus
        ``suffix`` (string + string, or concatenated token arrays). Mode
        and priority default to the parent's."""
        return self._engine.submit_child(
            self.rid, suffix, arrival=arrival, mode=mode, params=params,
            priority=priority, deadline=deadline)
