"""``perfbench/phases.py``: the span readings on hand-made spans and
events, and one small cell run on the CPU with the engine's tracer on."""

from __future__ import annotations

import pytest

from perfbench import phases
from perfbench.tests import tiny
from repro_torch.serving.trace import Span

PRODUCT = "mt-product.spec-greedy.c128"
MS = 1_000_000


def _it(t0, t1, kids=()):
    """An iteration from t0 to t1 ms and its children (name, a, b, rid)."""
    out = [Span(n, "iteration", r, a * MS, b * MS) for n, a, b, r in kids]
    return out + [Span("iteration", None, None, t0 * MS, t1 * MS)]


SPANS = (_it(0, 10, [("admit", 0, 2, 1), ("bundle_wait", 2, 6, None),
                     ("readout", 6, 7, 0), ("dispatch", 7, 9, None)])
         + [Span("plan", "dispatch", None, 7 * MS, 8 * MS),
            Span("queued", None, 1, -5 * MS, 0)]
         + _it(10, 20, [("admit", 10, 14, 2), ("dispatch", 15, 19, None)])
         + [Span("queued", None, 2, 3 * MS, 10 * MS)]
         + _it(30, 40))


def test_phase_ms_per_iteration():
    got = phases.phase_ms(SPANS, 0, 25 * MS)
    assert got["iterations"] == 2
    assert got["iteration"] == pytest.approx(10.0)
    assert got["spans"] == pytest.approx(10 / 2)   # by start: one queued
    assert got["admit"] == pytest.approx((2 + 4) / 2)
    assert got["bundle_wait"] == pytest.approx(2.0)
    assert got["readout"] == pytest.approx(0.5)
    assert got["dispatch"] == pytest.approx((2 + 4) / 2)
    assert got["plan"] == pytest.approx(0.5)
    assert got["launch"] == 0.0
    # 20 ms of iterations, 17 of them in direct children
    assert got["iteration_self"] == pytest.approx(3 / 2)
    # both waits end in the window: 5 and 7 ms
    assert got["queue_wait_p95"] == pytest.approx(5 + 0.95 * 2)
    assert phases.phase_ms(SPANS, 21 * MS, 29 * MS) == {}


def test_launches_per_iteration():
    ev = [("k", True, 1 * MS, 2 * MS), ("k", True, 12 * MS, 13 * MS),
          ("m", True, 13 * MS, 14 * MS), ("cpu", False, 1 * MS, 3 * MS),
          ("k", True, 31 * MS, 32 * MS)]
    assert phases.launches_per_iteration(ev, SPANS, 0, 25 * MS) == 1.5
    assert phases.launches_per_iteration(ev, SPANS, 21 * MS, 29 * MS) is None


def test_calls_by_span():
    ev = [("cudaLaunchKernel", False, 1 * MS, 1 * MS + 5),    # admit
          ("cudaMemcpyAsync", False, 6 * MS, 6 * MS + 5),     # readout
          ("cudaStreamSynchronize", False, 6 * MS + 9, 7 * MS),
          ("cudaLaunchKernel", False, 7 * MS, 7 * MS + 5),    # plan
          ("cudaLaunchKernel", False, 8 * MS, 8 * MS + 5),    # dispatch
          ("cudaLaunchKernel", False, 9 * MS, 9 * MS + 5),    # iteration
          ("aten::add", False, 9 * MS, 9 * MS + 5),
          ("k", True, 9 * MS, 9 * MS + 5),
          ("cudaLaunchKernel", False, 12 * MS, 12 * MS + 5),  # admit
          ("cudaLaunchKernel", False, 25 * MS, 25 * MS + 5)]  # none
    got = phases.calls_by_span(ev, SPANS, 0, 30 * MS)
    assert got["launches"] == {"admit": 1.0, "readout": 0.5, "plan": 0.5,
                               "dispatch": 0.5, "iteration": 0.5, "-": 0.5}
    assert got["syncs"] == {"readout": 0.5}
    assert got["sync_ms"] == {"readout": pytest.approx((MS - 9) / MS / 2)}
    assert phases.calls_by_span(ev, SPANS, 21 * MS, 29 * MS) == {}


def test_idle_gaps_name_the_program_span():
    ev = [("window", False, 0, 50 * MS),
          ("pump", False, 0, 20 * MS), ("pump", False, 30 * MS, 40 * MS),
          ("submit", False, 20 * MS, 30 * MS),
          ("pump", False, 44 * MS, 50 * MS),
          ("k", True, 0, 1 * MS),              # 1-3: admit
          ("k", True, 3 * MS, 6.5 * MS),       # 6.5-7: readout
          ("k", True, 7 * MS, 11 * MS),        # 11-12: admit
          ("k", True, 12 * MS, 33 * MS),       # 33-40: the iteration itself
          ("k", True, 40 * MS, 44 * MS),       # 44-48: pump, no program span
          ("k", True, 48 * MS, 50 * MS)]
    got = phases.idle_by_label(ev, SPANS, (0, 50 * MS))
    assert dict(got["by_label"]) == pytest.approx(
        {"pump/admit": 0.003, "pump/readout": 0.0005,
         "pump/iteration": 0.007, "pump": 0.004})
    assert got["gaps"][0] == ["pump/iteration", pytest.approx(0.007)]
    assert got["pump_idle_s"] == pytest.approx(0.0145)
    assert got["pump_idle_in_spans_s"] == pytest.approx(0.0105)


def test_without_program_spans_the_labels_are_the_harness_own():
    from perfbench import harness

    ev = [("window", False, 0, 1000), ("pump", False, 0, 50),
          ("k1", True, 10, 40), ("k2", True, 30, 60),
          ("result", False, 60, 100), ("k1", True, 200, 300),
          ("submit", False, 150, 400), ("k3", True, 990, 1200)]
    got = phases.idle_by_label(ev, [], (0, 1000))
    want = harness.reduce_trace(ev).idle_gaps
    assert got["gaps"] == want
    assert got["pump_idle_in_spans_s"] == 0.0


def test_pair_segments_sets_each_on_segment_against_its_off_one():
    def seg(on, iterations, ms, t0):
        return {"on": on, "iterations": iterations, "ms": ms, "t0": t0,
                "t1": t0 + 10, "gc_ms": 0.1 * ms if on else 0.0}

    segs = [seg(True, 10, 110.0, 0), seg(False, 10, 100.0, 10),
            seg(False, 5, 50.0, 20), seg(True, 4, 42.0, 30),
            seg(True, 3, 33.0, 40)]          # the last has no partner
    spans = [Span("x", None, None, t, t) for t in (0, 5, 15, 31, 45)]
    got = phases.pair_segments(segs, spans)
    assert got["excess"] == pytest.approx([0.1, 0.05])
    assert got["excess_median"] == pytest.approx(0.075)
    assert got["on_ms"] == pytest.approx(185 / 17)
    assert got["off_ms"] == pytest.approx(10.0)
    assert got["pooled"] == pytest.approx(185 / 17 / 10 - 1)
    assert got["gc_ms"] == pytest.approx([18.5 / 17, 0.0])
    assert got["spans"] == pytest.approx(4 / 17)   # starts in on segments
    assert phases.pair_segments([])["excess_median"] is None


def test_a_small_cell_with_the_tracer_on(tmp_path):
    """The engine's spans over a CPU run of a small cell: every phase an
    iteration has, the window's reads, and a correct result; alternating,
    the tracer records in the on segments only."""
    cell = tiny.cell(PRODUCT, tmp_path)
    kw = dict(device="cpu", cell=cell, weights_dir=tmp_path / "w",
              log=lambda *a: None)
    on = phases.run(PRODUCT, 2**31 + 3, 2.0, False, **kw)
    assert on["result"]["correct"], on["result"]["checks"]
    ph = on["phases"]
    assert ph["iterations"] == on["loop"]["iterations"] > 0
    for name in ("admit", "encode", "bundle_wait", "readout", "dispatch",
                 "plan", "launch", "streams", "queue_wait_p95"):
        assert ph[name] > 0, name
    assert ph["iteration_self"] < ph["iteration"]
    assert 0 < on["span_cost_ns"]["off"] < on["span_cost_ns"]["on"]
    # a paged engine reads its plan flag and its bundle each iteration
    assert on["reads"]["host_reads"] >= 2
    assert on["reads"]["readout_reads"] > 0
    assert "alternation" not in on
    alt = phases.run(PRODUCT, 2**31 + 3, 1.5, False, 0.2, **kw)
    # too short a window for the logit tap's calls: what it served is whole
    assert alt["result"]["failed"] == 0
    assert alt["result"]["checks"]["malformed"]["value"] == 0
    segs = alt["alternation"]["segments"]
    assert len(segs) >= 4
    assert [s["on"] for s in segs[:4]] == [True, False, False, True]
    assert all(s["iterations"] > 0 for s in segs)
    assert sum(s["admitted"] for s in segs) > 0
    # the on segments' iterations, and those of an unfinished last one
    assert alt["phases"]["iterations"] >= sum(s["iterations"]
                                              for s in segs if s["on"])
    assert alt["alternation"]["spans"] > 0
    assert len(alt["alternation"]["excess"]) == len(segs) // 2
