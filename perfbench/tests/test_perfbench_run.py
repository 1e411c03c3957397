"""A run end to end on the CPU at a small size: the reference agrees with
the program's path, the closed loop keeps C requests in flight, the
measurement refuses to run without a card, and each fault planted under
the timed path turns ``correct`` false."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import faults, harness, weights
from perfbench.reference import model as ref
from perfbench.reference import synthetic
from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
PRODUCT = "mt-product.spec-greedy.c128"
RETRO = "mt-retro.spec-beam10.c16"
SEED = 2**31 + 11


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Each small cell and its weights, trained once for the module."""
    tmp = tmp_path_factory.mktemp("perfbench")
    out = {}
    for wl, beams in ((PRODUCT, None), (RETRO, 3)):
        cell = tiny.cell(wl, tmp, n_beams=beams)
        got = weights.trained(cell.config, cell.config_path, "cpu",
                              log=lambda *a: None, cache_dir=tmp / "w")
        out[wl] = (cell, got, tmp)
    return out


def _queries(n: int, task: str, seed: int = 5):
    return [s for s, _ in synthetic.pairs(n, seed, task)]


def test_reference_greedy_equals_the_program(trained):
    cell, got, _ = trained[PRODUCT]
    tok = synthetic.tokenizer()
    eng = harness.build_engine(cell, got["weights"], tok, "cpu")
    srcs = _queries(6, "forward")
    handles = [eng.submit(q) for q in srcs]
    done = eng.serve()
    cfg = weights.model_cfg(cell.config)
    want = ref.greedy(got["weights"], cfg,
                      [tok.encode(q, add_eos=True) for q in srcs],
                      max_new=cell.traffic["max_new"], bos=tok.bos_id,
                      eos=tok.eos_id)
    for h, w in zip(handles, want):
        r = done[int(h)]
        assert list(r.tokens[0][:int(r.lengths[0])]) == w


def test_reference_speculative_beam_equals_the_program(trained):
    cell, got, _ = trained[RETRO]
    tok = synthetic.tokenizer()
    eng = harness.build_engine(cell, got["weights"], tok, "cpu")
    srcs = _queries(3, "retro")
    handles = [eng.submit(q) for q in srcs]
    done = eng.serve()
    mix = cell.traffic
    found = ref.speculative_beam_search(
        got["weights"], weights.model_cfg(cell.config),
        [tok.encode(q, add_eos=True) for q in srcs], n_beams=mix["n_beams"],
        max_new=mix["max_new"], draft_len=mix["draft_len"],
        n_drafts=mix["n_drafts"], bos=tok.bos_id, eos=tok.eos_id)
    for h, beams in zip(handles, found):
        r = done[int(h)]
        for k, (toks, score) in enumerate(beams):
            assert list(r.tokens[k][:int(r.lengths[k])]) == toks
            assert abs(float(r.logprobs[k]) - score) < 1e-3


def test_source_drafts_match_the_program():
    from repro_torch.core.drafting import extract_drafts

    for toks in ([5, 6, 7, 8, 9, 10, 11, 2], [5, 6, 2], []):
        d, m = ref.source_drafts(toks + [0, 0], 4, 3)
        pd, pm = extract_drafts(np.asarray(toks + [0, 0]), 4, 3)
        assert d.tolist() == pd.tolist() and m.tolist() == pm.tolist()


class _Counting:
    """An engine whose every submit and returned result is counted, so the
    test can read the requests in flight at each iteration's start."""

    def __init__(self, eng, clients):
        self.eng, self.clients = eng, clients
        self.out = 0
        self.seen: list[int] = []

    def submit(self, q):
        self.out += 1
        return self.eng.submit(q)

    def loop_stats(self):
        return self.eng.loop_stats()

    def serve_steps(self):
        for events in self.eng.serve_steps():
            self.out -= len(events)
            yield events
            self.seen.append(self.out)


def test_closed_loop_keeps_c_in_flight(trained):
    cell, got, _ = trained[PRODUCT]
    tok = synthetic.tokenizer()
    eng = _Counting(harness.build_engine(cell, got["weights"], tok, "cpu"),
                    4)
    pool = [(q, "") for q in _queries(64, "forward")]
    out = harness.closed_loop(eng, pool, 4, 2, 1.5)
    assert out.done and out.missing == 0
    # every iteration after the first, up to the one that closes the
    # window, starts with exactly C requests submitted and not yet returned
    timed = eng.seen[:2 + out.iterations - 1]
    assert timed and all(n == 4 for n in timed), timed


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        PRODUCT, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def _run(trained, wl, **kw):
    cell, _, tmp = trained[wl]
    seconds = 2.0 if wl == PRODUCT else 5.0   # a few completions each
    return harness.run_cell(wl, SEED, seconds, False, device="cpu", cell=cell,
                            weights_dir=tmp / "w", log=lambda *a: None, **kw)


@pytest.mark.parametrize("wl", [PRODUCT, RETRO])
def test_a_sound_run_is_correct(trained, wl):
    r = _run(trained, wl)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"queries_per_s", "latency_p95_ms",
                                 "setup_s"}


@pytest.mark.parametrize("wl,fault", [
    (wl, f) for wl, kind in ((PRODUCT, "greedy"), (RETRO, "beam"))
    for f in faults.applicable(kind, "seq2seq")])
def test_a_planted_fault_is_not_correct(trained, wl, fault):
    """The faults a one-chip serving cell can have (no exchange between
    chips exists here)."""
    with faults.planted(fault):
        r = _run(trained, wl, drain_s=2.0)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("wl", [PRODUCT, RETRO])
def test_the_control_is_judged_in_the_programs_place(trained, wl):
    """The control's numbers go through the same judgement as the
    program's: every limited number is there, the program's judgement
    beside it."""
    r = _run(trained, wl, control=True)
    assert r["program"]["correct"], r["program"]["checks"]
    assert set(r["checks"]) == set(trained[wl][0].limits["limits"])
    assert all(c["value"] is not None for c in r["checks"].values())


def test_a_number_not_produced_fails():
    limits = {"logit_err": 3e-3, "tap_unmatched": 0}
    checks, ok = harness.decide({"tap_unmatched": 0.0}, limits)
    assert not ok and checks["logit_err"]["value"] is None
    assert harness.decide({"logit_err": 1e-4, "tap_unmatched": 0.0,
                           "extra": 9.0}, limits)[1]


def test_an_empty_tap_reads_no_logit_err(trained):
    cell, got, _ = trained[PRODUCT]
    from perfbench import check

    tok = synthetic.tokenizer()
    N = cell.traffic["n_drafts"]
    tokens = np.zeros((2 * N, 11), np.int64)
    positions = np.full((2 * N, 11), -1, np.int64)   # no active slot
    out = check.tap_numbers(got["weights"], weights.model_cfg(cell.config),
                            tok, [(tokens, positions, None)], [],
                            traffic=cell.traffic, seed=SEED, slots=4)
    assert "logit_err" not in out


class _Ticking:
    """An engine of empty iterations of a fixed length, so the loop's split
    and its counts can be checked without a model."""

    def __init__(self, dt):
        self.dt, self.n = dt, 0

    def submit(self, q):
        self.n += 1
        return self.n

    def loop_stats(self):
        return {"n_dispatches": 10 * self.n}

    def serve_steps(self):
        import time
        while True:
            time.sleep(self.dt)
            self.n += 1
            yield []


def test_the_traced_span_follows_the_window():
    """A traced run's profiled span is served after the window closes, for
    as long as asked, and no client submits after it."""
    import time

    seen = []
    eng = _Ticking(0.01)
    out = harness.closed_loop(
        eng, [("q", "")], 2, 1, 0.3, drain_s=0.0,
        on_close=lambda: seen.append(("close", time.perf_counter())),
        extra_s=0.2,
        on_extra_end=lambda: seen.append(("end", time.perf_counter())))
    assert [k for k, _ in seen] == ["close", "end"]
    assert seen[1][1] - seen[0][1] >= 0.2
    assert 0.3 <= out.window_s < 0.5 and out.missing == 2


def test_the_recorder_counts_after_the_window():
    """What a launch's bound depends on is copied as it stands at the
    launch, and counted only when asked."""
    import types

    calls = []
    mod = types.ModuleType("perfbench_tests_fake_entry")
    mod.op = lambda x: x.add_(1)
    sys.modules[mod.__name__] = mod
    metric = types.SimpleNamespace(ENTRIES={(mod.__name__, "op"): (
        lambda a, kw: (a[0],),
        lambda x: calls.append(x.tolist()) or (int(x.sum()) * 3.35e12, 0))})
    try:
        rec = harness.EntryRecorder({"m": metric})
        x = torch.zeros(2)
        mod.op(x)
        rec.active = True
        mod.op(x)
        mod.op(x)
        assert calls == []
        assert rec.bounds() == {"m": pytest.approx(2.0 + 4.0)}
        assert calls == [[1.0, 1.0], [2.0, 2.0]]
        rec.close()
        assert mod.op is not None and mod.op(x) is x
    finally:
        del sys.modules[mod.__name__]


def test_trace_reduction():
    ev = [("window", False, 0, 1000), ("pump", False, 0, 50),
          ("k1", True, 10, 40), ("k2", True, 30, 60),
          ("result", False, 60, 100), ("k1", True, 200, 300),
          ("submit", False, 150, 400), ("k3", True, 990, 1200)]
    t = harness.reduce_trace(ev)
    assert t.window_s == 1e-6
    assert t.busy_s == pytest.approx((50 + 100 + 10) / 1e9)
    assert t.kernel_s["k1"] == pytest.approx(130 / 1e9)
    assert t.idle_gaps[0] == ["submit", pytest.approx(690 / 1e9)]
    assert [g[0] for g in t.idle_gaps] == ["submit", "result", "pump"]


@pytest.mark.gpu
def test_a_cell_on_the_card():
    """One short run of each cell on the card, correct (``-m gpu``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for wl in (PRODUCT, RETRO):
        r = harness.run_cell(wl, SEED, 3.0, False)
        assert r["correct"], r["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("wl,number", [(PRODUCT, "logit_err"),
                                       (RETRO, "logprob_err")])
def test_the_control_fails_on_the_card(wl, number):
    """The reference in TF32 put in the program's place is judged not
    correct, on the same served requests as a sound run that is
    (``-m gpu``; ``calibrate.py`` makes the full readings)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = harness.run_cell(wl, SEED + 1, 5.0, False, control=True)
    assert r["program"]["correct"], r["program"]["checks"]
    assert not r["correct"], r["checks"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"]
