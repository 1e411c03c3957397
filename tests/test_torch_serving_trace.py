"""The serving engine's host spans (``repro_torch.serving.trace``) and its
read counters, on a random tiny MT on the CPU: off, the tracer is one
shared no-op and records nothing; on, one drive records each scheduler
iteration's phases under it with the right parents and request ids, on the
clock of ``torch.profiler``'s events, a pass's admissions written by one
flush with one encoder pass; ``loop_stats()`` counts the read-out's five
reads a finished request apart from the step's."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.mt import tiny_config  # noqa: E402
from repro_torch.data.synthetic import SyntheticReactionDataset  # noqa: E402
from repro_torch.models import seq2seq as s2s  # noqa: E402
from repro_torch.serving import EngineConfig, StreamingEngine  # noqa: E402
from repro_torch.serving import trace  # noqa: E402

MS = 1_000_000   # ns


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny model's ops are far too small to share out between threads,
    and pytest-xdist's workers would contend for the same cores; one
    thread, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy():
    ds = SyntheticReactionDataset(16, seed=0)
    cfg = tiny_config(ds.tokenizer.vocab_size, depth=2, d_model=64,
                      max_len=192)
    params = s2s.init(torch.Generator().manual_seed(0), cfg, device="cpu")

    def engine(**kw):
        base = dict(mode="speculative", draft_len=3, n_drafts=4, n_beams=2,
                    max_new=6, max_src=64, n_slots=2, paged=True,
                    page_size=8)
        base.update(kw)
        return StreamingEngine(params, cfg, ds.tokenizer,
                               EngineConfig(**base), device="cpu")

    return dict(engine=engine,
                queries=[ds.pair(i)[0] for i in range(len(ds))])


def test_off_is_one_shared_no_op(monkeypatch):
    tr = trace.Tracer()

    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"an off tracer read time.{name}")

    monkeypatch.setattr(trace, "time", NoClock())
    a, b = tr.span("admit", 3), tr.span("iteration")
    assert a is b
    with a:
        with b:
            pass
    assert tr.export() == [] and tr.dropped == 0


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 2)
    tr = trace.Tracer()
    tr.enable()
    for _ in range(5):
        with tr.span("x"):
            pass
    tr.disable()
    with tr.span("after"):
        pass
    assert [s.name for s in tr.export()] == ["x", "x"]
    assert tr.dropped == 3


def test_an_engine_off_records_nothing(toy):
    eng = toy["engine"]()
    for q in toy["queries"][:3]:
        eng.submit(q)
    eng.serve()
    assert not eng.tracer.on and eng.tracer.export() == []


def _drive(eng, queries):
    """Submit and drive the pump by hand; the iterations that ran."""
    rids = {int(eng.submit(q)) for q in queries}
    n = sum(1 for _ in eng.serve_steps())
    return rids, n


# a span's parent under one drive (``queued`` nests in nothing: it spans
# iterations)
PARENT = {"iteration": None, "expire": "iteration", "admit": "iteration",
          "encode": "admit", "bundle_wait": "iteration",
          "readout": "iteration", "release": "iteration",
          "dispatch": "iteration", "plan": "dispatch", "launch": "dispatch",
          "streams": "iteration", "queued": None}


@pytest.mark.parametrize("mode,paged", [("speculative", True),
                                        ("speculative_beam", True),
                                        ("greedy", False)])
def test_one_drive_records_the_phases(toy, mode, paged):
    import time

    eng = toy["engine"](mode=mode, paged=paged)
    t0 = time.time_ns()
    eng.tracer.enable()
    rids, n_iter = _drive(eng, toy["queries"][:5])
    eng.tracer.disable()
    t1 = time.time_ns()
    spans = eng.tracer.export()
    want = set(PARENT) - ({"plan"} if not paged else set())
    assert {s.name for s in spans} == want
    for s in spans:
        assert s.parent == PARENT[s.name], s
        assert t0 <= s.start_ns <= s.end_ns <= t1, s
    its = [s for s in spans if s.name == "iteration"]
    # the drive's last next() finds the queue drained and yields nothing
    assert len(its) == n_iter + 1
    # every child lies inside an iteration, and only one
    for s in spans:
        if s.parent == "iteration":
            assert sum(i.start_ns <= s.start_ns and s.end_ns <= i.end_ns
                       for i in its) == 1, s
    # one admission, one wait and one read-out a request, each under its id
    for name in ("admit", "queued", "readout", "release"):
        assert sorted(s.rid for s in spans
                      if s.name == name and s.rid is not None) == \
            sorted(rids), name
    # a pass's admissions are written by one flush, an ``admit`` span with
    # no id, which runs the encoder once
    flushes = [s for s in spans if s.name == "admit" and s.rid is None]
    encodes = [s for s in spans if s.name == "encode"]
    assert len(encodes) == len(flushes) == eng.loop_stats()["admit_batches"]
    for e in encodes:
        assert sum(f.start_ns <= e.start_ns and e.end_ns <= f.end_ns
                   for f in flushes) == 1, e
    assert eng.loop_stats()["admit_batch_queries"] == len(rids)
    # a request waits, then is admitted; the two slots make later ones wait
    by_rid = {s.rid: s for s in spans if s.name == "admit"
              and s.rid is not None}
    waits = []
    for s in spans:
        if s.name == "queued":
            assert s.end_ns <= by_rid[s.rid].start_ns
            waits.append(s.end_ns - s.start_ns)
    assert max(waits) > min(waits)
    # every step dispatched is waited for once
    assert sum(s.name == "dispatch" for s in spans) == \
        sum(s.name == "bundle_wait" for s in spans)


@pytest.mark.parametrize("paged", [True, False])
def test_readout_reads_apart_from_the_steps(toy, paged):
    eng = toy["engine"](paged=paged)
    eng.submit(toy["queries"][0])
    eng.serve()
    stats = eng.loop_stats()
    assert stats["readout_reads"] == 5
    # a lone resident's iterations read only what the step reads: a paged
    # one its plan flag and bundle, a dense one its bundle
    assert stats["host_reads"] == (2 if paged else 1) * stats["n_iterations"]
    assert not any(k.startswith("step_gap") for k in stats)
    for q in toy["queries"][1:5]:
        eng.submit(q)
    eng.serve()
    assert eng.loop_stats()["readout_reads"] == 5 * 5


def test_a_span_encloses_a_profiled_range():
    """Exported spans share the clock of ``torch.profiler``'s events: a
    span around a ``record_function`` range encloses it, within 0.2 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = trace.Tracer()
    tr.enable()
    x = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            x @ x
        for i in range(3):
            with tr.span("outer"):
                with record_function(f"inner{i}"):
                    x @ x
    rng = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()}
    outer = tr.export()
    assert len(outer) == 3
    for i, s in enumerate(outer):
        a, b = rng[f"inner{i}"]
        assert s.start_ns - 0.2 * MS <= a and b <= s.end_ns + 0.2 * MS, (
            (a - s.start_ns) / MS, (s.end_ns - b) / MS)
