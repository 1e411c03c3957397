"""A cell run with the serving engine's host spans on: where an iteration's
time goes, which program span the host was in when the card idled, and
what the spans cost.

    python3 perfbench/phases.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1> [--alternate <s>]

It runs ``harness.run_cell`` as ``run.py`` does, with the engine's
``tracer`` (``repro_torch.serving.trace``) on from the engine's
construction, so through the warm-up, the window and (``--trace 1``) the
profiled seconds after it. The last line of standard output is one JSON
object: the run's own result line under ``result``; ``loop``, the window's
``iteration_ms`` and ``queries_per_s`` from the harness's own count;
``reads``, the window's blocking device reads an iteration
(``loop_stats()``'s ``host_reads`` and ``readout_reads``); ``gc``, the
collector's passes and milliseconds an iteration of the window;
``phases``, each span's milliseconds an iteration over the window, the
spans an iteration and the p95 of ``queued``; ``span_cost_ns``, what an
empty span costs this host on and off; with ``--trace 1`` also
``traced``, over the profiled span: launches an iteration, the CUDA
runtime's launches and waits (and the time waited) an iteration by the
program span they were made in, and the card's idle seconds by label,
``<benchmark span>/<program span>``.

``--alternate S`` measures the tracer's cost inside one process: the
window is cut into segments of S seconds, the tracer on in the 1st, 4th,
5th, 8th, ... and off in the others (on, off, off, on: a drift in the
host's pace falls on both states alike), and ``alternation`` gives each
segment's iterations, results, admissions and collector work, and the
on segment against the off one of each pair. The functions below read
the spans and the profiler's events; ``harness.py`` does not call them.
"""

from __future__ import annotations

import bisect
import gc
import re
import sys
import time
import weakref

T_START = time.perf_counter()

import numpy as np  # noqa: E402

# the spans one iteration nests (repro_torch.serving.trace)
PHASES = ("expire", "admit", "encode", "bundle_wait", "readout", "release",
          "dispatch", "plan", "launch", "streams")
# the CUDA runtime's calls, as the profiler names them on the host, that
# put work on the card's stream, and those that wait for the card
LAUNCH = re.compile(r"^(cudaLaunch|cuLaunch|cudaMemcpy|cudaMemset)")
SYNC = re.compile(r"Synchronize$")
# empty spans ``span_cost_ns`` times in each state
COST_N = 200_000


def _in(spans, name, w0, w1):
    return [s for s in spans if s.name == name and w0 <= s.start_ns < w1]


def phase_ms(spans, w0: int, w1: int) -> dict:
    """Each span's total duration in ms, over the spans that start in [w0,
    w1) (Unix-epoch ns), divided by the ``iteration`` spans starting there;
    ``iteration_self`` is what the iteration's direct children leave out,
    and ``queue_wait_p95`` the p95 of the ``queued`` spans that end in the
    window. Empty where no iteration started."""
    its = _in(spans, "iteration", w0, w1)
    if not its:
        return {}
    n = len(its)

    def total(ss):
        return sum(s.end_ns - s.start_ns for s in ss) / 1e6

    out = {"iterations": n, "iteration": total(its) / n,
           "spans": sum(1 for s in spans if w0 <= s.start_ns < w1) / n}
    for name in PHASES:
        out[name] = total(_in(spans, name, w0, w1)) / n
    kids = [s for s in spans if s.parent == "iteration"
            and w0 <= s.start_ns < w1]
    out["iteration_self"] = (total(its) - total(kids)) / n
    waits = [(s.end_ns - s.start_ns) / 1e6 for s in spans
             if s.name == "queued" and w0 <= s.end_ns < w1]
    if waits:
        out["queue_wait_p95"] = float(np.percentile(waits, 95))
    return out


def launches_per_iteration(events, spans, w0: int, w1: int):
    """Device events (kernels, copies, sets) of the profiler's trace that
    start in [w0, w1), over the ``iteration`` spans starting there."""
    its = len(_in(spans, "iteration", w0, w1))
    dev = sum(1 for _, d, s, _ in events if d and w0 <= s < w1)
    return dev / its if its else None


def _program(spans):
    """The spans that nest (``queued`` spans iterations), by start, a
    child that starts with its parent after it; and their starts."""
    prog = sorted((s for s in spans if s.name != "queued"),
                  key=lambda s: (s.start_ns, -s.end_ns))
    return prog, [s.start_ns for s in prog]


def _innermost(spans, starts, t):
    """The innermost of ``_program``'s spans open at ``t``, or None; the
    search stops at the last top-level span closed before ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        s = spans[i]
        if s.end_ns > t:
            return s
        if s.parent is None:
            return None
        i -= 1
    return None


def idle_by_label(events, spans, window) -> dict:
    """The card's idle gaps in ``window`` (the profiler's device intervals'
    complement, as ``harness.reduce_trace`` finds them), each labelled by
    the benchmark's host span open at its start and the innermost program
    span open then: ``pump/readout``; a gap in no program span keeps the
    host span's label alone (``host`` in neither). Returns ``by_label``
    (seconds, largest first), the ten longest gaps, and the seconds idle
    in ``pump`` and, of those, in a program span."""
    from perfbench.harness import SPANS, _union

    w0, w1 = window
    host = sorted((s, e, n) for n, d, s, e in events
                  if not d and n in SPANS)
    hstarts = [h[0] for h in host]
    busy = _union([(max(s, w0), min(e, w1)) for n, d, s, e in events
                   if d and n not in SPANS and n != "window"
                   and e > w0 and s < w1])
    prog, pstarts = _program(spans)
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    by_label: dict[str, float] = {}
    top, pump, named = [], 0.0, 0.0
    for g0, g1 in gaps:
        i = bisect.bisect_right(hstarts, g0) - 1
        label = host[i][2] if i >= 0 and host[i][1] > g0 else "host"
        inner = _innermost(prog, pstarts, g0)
        sec = (g1 - g0) / 1e9
        if label == "pump":
            pump += sec
            named += sec if inner is not None else 0.0
        if inner is not None:
            label = f"{label}/{inner.name}"
        by_label[label] = by_label.get(label, 0.0) + sec
        top.append([label, sec])
    top.sort(key=lambda x: -x[1])
    return {"by_label": sorted(([k, v] for k, v in by_label.items()),
                               key=lambda x: -x[1]),
            "gaps": top[:10], "pump_idle_s": pump,
            "pump_idle_in_spans_s": named}


def calls_by_span(events, spans, w0: int, w1: int) -> dict:
    """The CUDA runtime calls among the profiler's host events that start
    in [w0, w1), by the innermost program span open at their start (``-``
    where none is), an iteration: ``launches`` (kernels, copies, sets),
    ``syncs`` (the host waiting for the card) and ``sync_ms`` (the syncs'
    duration). Empty where no iteration started."""
    its = len(_in(spans, "iteration", w0, w1))
    if not its:
        return {}
    prog, pstarts = _program(spans)
    out: dict = {"launches": {}, "syncs": {}, "sync_ms": {}}
    for n, d, s, e in events:
        if d or not w0 <= s < w1:
            continue
        kind = ("launches" if LAUNCH.match(n) else
                "syncs" if SYNC.search(n) else None)
        if kind is None:
            continue
        inner = _innermost(prog, pstarts, s)
        key = "-" if inner is None else inner.name
        out[kind][key] = out[kind].get(key, 0) + 1
        if kind == "syncs":
            out["sync_ms"][key] = out["sync_ms"].get(key, 0) + (e - s) / 1e6
    return {k: dict(sorted(((n, c / its) for n, c in v.items()),
                           key=lambda x: -x[1]))
            for k, v in out.items()}


def span_cost_ns() -> dict:
    """Host nanoseconds one empty span takes with a tracer on and off
    (``COST_N`` of each, a tracer of its own)."""
    from repro_torch.serving.trace import Tracer

    out = {}
    for state in ("off", "on"):
        tr = Tracer()
        if state == "on":
            tr.enable()
        t0 = time.perf_counter_ns()
        for _ in range(COST_N):
            with tr.span("x", 1):
                pass
        out[state] = (time.perf_counter_ns() - t0) / COST_N
    return out


def pair_segments(segments, spans=()) -> dict:
    """The on segment against the off segment of each pair (segments 0-1,
    2-3, ...): ``excess``, each pair's ms an iteration on over off, less
    one, and its median; ``pooled``, the same over all on and all off
    segments; ``gc_ms``, the collector's ms an iteration on and off; the
    spans an iteration of the on segments (``spans``, by start)."""
    pairs = [segments[i:i + 2] for i in range(0, len(segments) - 1, 2)]

    def per_it(ss, key="ms"):
        return sum(s[key] for s in ss) / max(sum(s["iterations"]
                                                 for s in ss), 1)

    excess = [per_it([a if a["on"] else b]) / per_it([b if a["on"] else a])
              - 1 for a, b in pairs if a["iterations"] and b["iterations"]]
    on = [s for s in segments if s["on"]]
    off = [s for s in segments if not s["on"]]
    n_spans = sum(1 for sp in spans for s in on
                  if s["t0"] <= sp.start_ns < s["t1"])
    return {"excess": excess,
            "excess_median": float(np.median(excess)) if excess else None,
            "pooled": per_it(on) / per_it(off) - 1 if on and off else None,
            "on_ms": per_it(on), "off_ms": per_it(off),
            "gc_ms": [per_it(on, "gc_ms"), per_it(off, "gc_ms")],
            "spans": n_spans / max(sum(s["iterations"] for s in on), 1)}


def run(workload: str, seed: int, seconds: float, trace: bool,
        alternate: float = 0.0, **kw) -> dict:
    """``harness.run_cell`` with the engine's tracer on, and what the
    spans and the trace say; with ``alternate`` the tracer goes on and
    off in segments of that many seconds of the window. See the module's
    docstring."""
    from perfbench import harness

    got: dict = {}
    segments: list[dict] = []
    seg: dict = {}
    collector = {"n": [0, 0, 0], "ns": 0, "t": 0}

    def on_gc(phase, info):
        if phase == "start":
            collector["t"] = time.perf_counter_ns()
        else:
            collector["n"][info["generation"]] += 1
            collector["ns"] += time.perf_counter_ns() - collector["t"]

    def gc_now():
        return list(collector["n"]), collector["ns"]

    def admitted():
        return got["engine"]().prefix_stats()["requests_admitted"]

    def start_segment(k, now):
        seg.update(k=k, t0_pc=now, t0=time.time_ns(), iterations=0,
                   results=0, admitted=admitted(), gc=gc_now())
        got["tracer"].on = k % 4 in (0, 3)

    def tick(results):
        """After each iteration of the window: count it, and close the
        segment once it has run ``alternate`` seconds."""
        if not seg:
            return
        seg["iterations"] += 1
        seg["results"] += results
        now = time.perf_counter_ns()
        if now - seg["t0_pc"] >= alternate * 1e9:
            n, ns = gc_now()
            segments.append({
                "on": got["tracer"].on, "iterations": seg["iterations"],
                "ms": (now - seg["t0_pc"]) / 1e6, "results": seg["results"],
                "admitted": admitted() - seg["admitted"],
                "gc": [a - b for a, b in zip(n, seg["gc"][0])],
                "gc_ms": (ns - seg["gc"][1]) / 1e6,
                "t0": seg["t0"], "t1": time.time_ns()})
            start_segment(seg["k"] + 1, now)

    build, loop, events_of = (harness.build_engine, harness.closed_loop,
                              harness.profiler_events)

    def build_engine(*a, **k):
        eng = build(*a, **k)
        got["tracer"] = eng.tracer
        got["engine"] = weakref.ref(eng)
        eng.tracer.enable()
        if alternate:
            steps = eng.serve_steps

            def serve_steps():
                for events in steps():
                    tick(len(events))
                    yield events

            eng.serve_steps = serve_steps
        return eng

    def reads():
        st = got["engine"]().loop_stats()
        return st["host_reads"], st["readout_reads"]

    def closed_loop(*a, on_open=None, on_close=None, on_extra_end=None,
                    **k):
        def opened():
            on_open()
            got["reads"], got["gc"] = reads(), gc_now()
            got["open"] = time.time_ns()
            if alternate:
                start_segment(0, time.perf_counter_ns())

        def closed():
            got["close"] = time.time_ns()
            seg.clear()
            got["tracer"].on = True
            got["reads"] = [b - a for a, b in zip(got["reads"], reads())]
            n, ns = gc_now()
            got["gc"] = ([b - a for a, b in zip(got["gc"][0], n)],
                         ns - got["gc"][1])
            on_close()

        def extra_end():
            on_extra_end()
            got["tracer"].disable()

        out = loop(*a, on_open=opened, on_close=closed,
                   on_extra_end=extra_end, **k)
        got["loop"] = out
        return out

    def profiler_events(prof):
        got["events"] = events_of(prof)
        return got["events"]

    harness.build_engine, harness.closed_loop = build_engine, closed_loop
    harness.profiler_events = profiler_events
    gc.callbacks.append(on_gc)
    try:
        result = harness.run_cell(workload, seed, seconds, trace, **kw)
    finally:
        gc.callbacks.remove(on_gc)
        harness.build_engine, harness.closed_loop = build, loop
        harness.profiler_events = events_of
    got["tracer"].disable()
    out = got["loop"]
    n = out.iterations
    spans = got["tracer"].export()
    line = {"workload": workload, "seed": seed, "trace": int(trace),
            "alternate": alternate, "result": result,
            "loop": {"iteration_ms": out.window_s / n * 1e3,
                     "queries_per_s": len(out.done) / out.window_s,
                     "iterations": n},
            "reads": {"host_reads": got["reads"][0] / n,
                      "readout_reads": got["reads"][1] / n},
            "gc": {"passes": [c / n for c in got["gc"][0]],
                   "ms": got["gc"][1] / 1e6 / n},
            "dropped": got["tracer"].dropped,
            "span_cost_ns": span_cost_ns(),
            "phases": phase_ms(spans, got["open"], got["close"])}
    if alternate:
        line["alternation"] = {"segments": segments,
                               **pair_segments(segments, spans)}
    if trace:
        events = got["events"]
        win = [(s, e) for n, d, s, e in events if not d and n == "window"]
        line["traced"] = {
            "launches_per_iteration": launches_per_iteration(
                events, spans, *win[0]),
            "phases": phase_ms(spans, *win[0]),
            "calls": calls_by_span(events, spans, *win[0]),
            **idle_by_label(events, spans, win[0])}
    return line


def main(argv=None) -> int:
    import argparse
    import json
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from perfbench import run as bench_run

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--alternate", type=float, default=0.0,
                    help="seconds a segment: the tracer on and off in "
                    "turn through the window")
    args = ap.parse_args(argv)
    bench_run._environment()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    from perfbench import harness

    print(f"card: {harness.card_line()}; torch {torch.__version__}",
          file=sys.stderr, flush=True)
    line = run(args.workload, args.seed, args.seconds, bool(args.trace),
               args.alternate, t_start=T_START)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
