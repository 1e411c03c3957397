"""Spans of the serving engine's host loop, kept in memory until asked for.

A ``Tracer`` is off until ``enable()``. While it is off, ``span()`` checks
one flag and returns a shared context that does nothing: no clock read and
no allocation. While it is on, each span records ``(name, parent, rid,
start_ns, end_ns)``: ``time.perf_counter_ns()`` at entry and at exit, the
name of the span open around it, and the request id where there is one.
At most ``CAP`` spans are kept; the rest are counted in ``dropped``.
``export()`` returns them on the Unix-epoch nanosecond clock that
``torch.profiler``'s events carry, through the one pair of clock readings
``enable()`` takes, so a span can be laid beside a device trace.

The spans ``StreamingEngine`` and ``ContinuousScheduler`` record, nested
as they nest in one scheduler iteration (names are what a reader of the
trace keys on):

- ``iteration``: one ``next()`` of the engine's step pump (the scheduler's
  drive and the stream delivery after it), parent of:
  - ``expire``: residents past their deadline evicted;
  - ``admit`` (rid): one admission's host bookkeeping (a decoder-only
    admission's whole admission);
  - ``admit`` (no rid): a seq2seq engine's flush of a pass's admissions,
    with a child ``encode`` where the encoder runs (one pass over the
    flush's sources, or over its encoder-output LRU misses);
  - ``bundle_wait``: the blocking read of the step's bundle (on a mesh, the
    read and the gather, inside ``launch``);
  - ``readout`` (rid): a finished slot's output read to the host;
  - ``release`` (rid): a slot evicted (also under ``expire``, and on its
    own for a cancel outside the pump);
  - ``dispatch``: the megastep, with children ``plan`` (the device page
    plan and the blocking read of its exhaustion flag) and ``launch``
    (the plan applied, prefill chunks, the decode step, the bundle);
  - ``streams``: stream deltas and terminal records delivered.
- ``queued`` (rid): a request's wait from entering a queue (submit or a
  preemption's requeue) to its admission.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    parent: str | None   # the enclosing span's name; None at the top
    rid: int | None
    start_ns: int
    end_ns: int


# spans kept by one recording, ~100 MB of tuples at most
CAP = 1 << 20

_OFF = contextlib.nullcontext()


class _Open:
    """One span in flight: pushed on the tracer's stack at entry, recorded
    and popped at exit."""

    __slots__ = ("_tracer", "_name", "_rid", "_parent", "_t0")

    def __init__(self, tracer: Tracer, name: str, rid):
        self._tracer, self._name, self._rid = tracer, name, rid

    def __enter__(self):
        stack = self._tracer._stack
        self._parent = stack[-1] if stack else None
        stack.append(self._name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self._tracer
        tr._stack.pop()
        tr.record(self._name, self._t0, t1, rid=self._rid,
                  parent=self._parent)
        return False


class Tracer:
    """Host spans of one engine, off by default (see the module's
    docstring). Not thread-safe: the engine's pump runs on one thread."""

    def __init__(self):
        self.on = False
        self.dropped = 0
        self._spans: list[tuple] = []
        # names of the spans open now; the parent of the next one
        self._stack: list[str] = []
        self._anchor = (0, 0)

    def enable(self) -> None:
        """Start a fresh recording: earlier spans are dropped, and the
        clock pair that ``export()`` converts with is read anew."""
        self._spans, self.dropped = [], 0
        self._anchor = (time.perf_counter_ns(), time.time_ns())
        self.on = True

    def disable(self) -> None:
        """Stop recording; what was recorded stays for ``export()``. Spans
        open now are still recorded when they close."""
        self.on = False

    def span(self, name: str, rid: int | None = None):
        """A context that records one span while the tracer is on."""
        if not self.on:
            return _OFF
        return _Open(self, name, rid)

    def record(self, name: str, start_ns: int, end_ns: int, *,
               rid: int | None = None, parent: str | None = None) -> None:
        """Keep a span whose ends were read with ``time.perf_counter_ns()``
        (one that does not nest, such as ``queued``)."""
        if len(self._spans) < CAP:
            self._spans.append((name, parent, rid, start_ns, end_ns))
        else:
            self.dropped += 1

    def export(self) -> list[Span]:
        """The recorded spans in the order they closed, their ends on the
        Unix-epoch nanosecond clock."""
        shift = self._anchor[1] - self._anchor[0]
        return [Span(n, p, r, s + shift, e + shift)
                for n, p, r, s, e in self._spans]
