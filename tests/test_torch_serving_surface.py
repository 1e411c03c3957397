"""The port's StreamingEngine serving surface against the JAX package's, on
the random tiny MT carried across with ``repro_torch.bridge``:

- the overload policy (``EngineConfig(overload=OverloadPolicy(...))``), on
  the workloads of ``tests/test_overload.py`` and the step clock: priority
  aging on and off, urgent-arrival preemption, no preemption without
  urgency, shedding past the queue depth, the retry hint, graceful drain
  and drain-then-reset. Statuses, tokens, timestamps, shed sets and the
  scheduler's counters are identical;
- the encoder-output LRU (``prefix_cache=True``), dense and paged, greedy
  and speculative, as ``tests/test_prefix_cache.py`` runs it: the port's
  tokens equal JAX's and those of the port with the cache off, and
  ``prefix_stats()`` equals JAX's;
- the tree of requests (``submit_child``, ``cancel_subtree``,
  ``RequestHandle.cancel(recursive=True)``) on SMILES queries;
- ``EngineConfig``'s validation errors.

Every engine runs on the step clock (``realtime=False``), so the two
packages see the same iterations; greedy log-probs are 0, so records
compare exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.mt import tiny_config as jax_tiny_config  # noqa: E402
from repro.data import SyntheticReactionDataset  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import OverloadPolicy as JaxOverloadPolicy  # noqa: E402
from repro.serving import StreamingEngine as JaxStreamingEngine  # noqa: E402
from repro.serving.api import RequestCancelled as JaxCancelled  # noqa: E402
from repro.serving.api import RequestRejected as JaxRejected  # noqa: E402
from repro_torch.bridge import seq2seq_params_from_jax  # noqa: E402
from repro_torch.configs.mt import tiny_config  # noqa: E402
from repro_torch.data.tokenizer import SmilesTokenizer  # noqa: E402
from repro_torch.serving import (EngineConfig, OverloadPolicy,  # noqa: E402
                                 RequestCancelled, RequestRejected,
                                 StreamingEngine)
from repro_torch.training.optimizer import (tree_leaves,  # noqa: E402
                                            tree_unflatten)

MAX_NEW = 8   # tests/test_overload.py's


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny model's ops are far too small to share out between threads,
    and under pytest-xdist every worker's own thread pool would contend for
    the same cores; one thread, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy():
    ds = SyntheticReactionDataset(16, seed=0)
    V = ds.tokenizer.vocab_size
    cfg_j = jax_tiny_config(V, depth=2, d_model=64, max_len=192)
    pj = js2s.init(jax.random.PRNGKey(0), cfg_j)
    cfg_t = tiny_config(V, depth=2, d_model=64, max_len=192)
    pt = seq2seq_params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    tok = SmilesTokenizer.from_dict(ds.tokenizer.to_dict())
    return dict(ds=ds, cfg_j=cfg_j, pj=pj, cfg_t=cfg_t, pt=pt, tok=tok)


def _engines(toy, policy: dict | None = None, **kw):
    """(JAX engine, port engine) for one EngineConfig; ``policy``: the
    OverloadPolicy fields, given to each package's own class."""
    base = dict(mode="greedy", max_new=MAX_NEW, max_src=96, n_slots=1)
    base.update(kw)
    je = JaxStreamingEngine(toy["pj"], toy["cfg_j"], toy["ds"].tokenizer,
                            JaxEngineConfig(
                                overload=None if policy is None else
                                JaxOverloadPolicy(**policy), **base))
    te = StreamingEngine(toy["pt"], toy["cfg_t"], toy["tok"], EngineConfig(
        overload=None if policy is None else OverloadPolicy(**policy),
        **base), device="cpu")
    return je, te


def _q(toy, i):
    return toy["ds"].pair(i % 16)[0]


def _rec(r) -> tuple:
    """A terminal record as plain values (greedy log-probs are 0)."""
    return (str(r.status), np.asarray(r.tokens).tolist(),
            np.asarray(r.lengths).tolist(), np.asarray(r.logprobs).tolist(),
            int(r.n_calls), int(r.accepted), float(r.arrival),
            float(r.admitted), float(r.completed), r.mode,
            None if r.retry_after is None else float(r.retry_after))


def _counters(eng) -> dict:
    s = eng.scheduler
    return dict(steps=s.n_steps, preemptions=s.n_preemptions, shed=s.n_shed,
                expired=s.n_expired, cancelled=s.n_cancelled,
                max_resident=s.max_resident, queued=s.queued,
                draining=s.draining)


def _both(toy, workload, policy=None, **kw):
    """Run ``workload(engine)`` (returning plain observations) on the JAX
    and the port engine; the two must be identical."""
    je, te = _engines(toy, policy, **kw)
    got_j, got_t = workload(je), workload(te)
    assert got_t == got_j
    return got_t


# ---------------------------------------------------------------------------
# the overload policy


@pytest.mark.parametrize("aging", [0.05, None])
def test_starvation_workload_matches_jax(toy, aging):
    """One slot, a best-effort request with a deadline, then high-priority
    arrivals every 6 steps: with aging the low finishes inside its
    deadline, without it the low expires in the queue."""

    def workload(eng):
        low = eng.submit(_q(toy, 0), priority=0, deadline=90.0)
        highs = [eng.submit(_q(toy, 1 + i % 8), priority=1,
                            arrival=float(i) * 6.0) for i in range(14)]
        done = eng.serve()
        return dict(low=_rec(done[int(low)]),
                    highs=[_rec(done[int(h)]) for h in highs],
                    counters=_counters(eng))

    got = _both(toy, workload,
                None if aging is None else dict(aging_rate=aging))
    assert got["low"][0] == ("finished" if aging else "expired")


def test_urgent_arrival_preemption_matches_jax(toy):
    pol = dict(deadline_preemption=True, preempt_slack_margin=2.0)

    def workload(eng):
        low = eng.submit(_q(toy, 0), priority=0)
        while str(low.status) != "running":
            eng._pump_once()
        t0 = eng.scheduler._now
        high = eng.submit(_q(toy, 1), priority=1,
                          deadline=t0 + MAX_NEW + 4.0)
        eng._pump_once()
        mid = (eng.scheduler.n_preemptions, str(high.status),
               str(low.status))
        return dict(mid=mid, t0=t0, high=_rec(high.result()),
                    low=_rec(low.result()), counters=_counters(eng))

    got = _both(toy, workload, pol)
    assert got["mid"] == (1, "running", "queued")
    assert got["counters"]["preemptions"] == 1


def test_no_preemption_without_urgency_matches_jax(toy):
    def workload(eng):
        first = eng.submit(_q(toy, 0), priority=0)
        while str(first.status) != "running":
            eng._pump_once()
        second = eng.submit(_q(toy, 1), priority=0)
        eng._pump_once()
        mid = (eng.scheduler.n_preemptions, str(second.status))
        return dict(mid=mid, first=_rec(first.result()),
                    second=_rec(second.result()), counters=_counters(eng))

    assert _both(toy, workload,
                 dict(deadline_preemption=True))["mid"] == (0, "queued")


def test_shed_past_depth_matches_jax(toy):
    """Past ``shed_depth`` a submission is SHED at once (before any pump)
    with a positive retry hint; the kept ones finish."""

    def workload(eng):
        hs = [eng.submit(_q(toy, i)) for i in range(5)]
        before = [str(h.status) for h in hs]
        hints = []
        for h in hs[2:]:
            with pytest.raises((RequestRejected, JaxRejected)) as ei:
                h.result()
            hints.append((ei.value.reason, ei.value.retry_after))
        done = eng.serve()
        return dict(before=before, hints=hints,
                    kept=[_rec(h.result()) for h in hs[:2]],
                    epoch=sorted(done), counters=_counters(eng))

    got = _both(toy, workload, dict(shed_depth=2))
    assert got["before"] == ["queued"] * 2 + ["shed"] * 3
    assert all(reason == "shed" and hint > 0
               for reason, hint in got["hints"])


def test_retry_after_estimates_match_jax(toy):
    def shallow(eng):
        eng.submit(_q(toy, 0))
        eng.submit(_q(toy, 1))
        return eng.scheduler.retry_after_estimate("greedy")

    def deep(eng):
        for i in range(7):
            eng.submit(_q(toy, i))
        return eng.scheduler.retry_after_estimate("greedy")

    a = _both(toy, shallow, dict(shed_depth=1))
    b = _both(toy, deep, dict(shed_depth=6))
    assert b > a > 0.0
    fixed = _both(toy, lambda eng: _rec(eng._done[int(eng.submit(
        _q(toy, 0)))]), dict(shed_depth=0, shed_retry_after=42.0))
    assert fixed[0] == "shed" and fixed[-1] == 42.0


def test_graceful_drain_matches_jax(toy):
    """Paged, 2 slots: begin_drain() sheds the queue with retry hints,
    residents finish, a late submission sheds, every page comes back."""

    def workload(eng):
        hs = [eng.submit(_q(toy, i)) for i in range(6)]
        while not any(str(h.status) == "running" for h in hs):
            eng._pump_once()
        before = [str(h.status) for h in hs]
        n_shed = eng.begin_drain()
        late = eng.submit(_q(toy, 7))
        done = eng.serve()
        eng.allocator.check()
        return dict(before=before, n_shed=n_shed,
                    late=str(late.status),
                    records={int(k): _rec(v) for k, v in done.items()},
                    free=eng.allocator.free_pages,
                    n_pages=eng.allocator.n_pages, counters=_counters(eng))

    got = _both(toy, workload, None, n_slots=2, paged=True, page_size=8)
    assert got["n_shed"] == got["before"].count("queued") > 0
    assert got["late"] == "shed"
    assert got["free"] == got["n_pages"] - 1


def test_drain_then_reset_matches_jax(toy):
    def workload(eng):
        eng.submit(_q(toy, 0))
        first = {int(k): _rec(v) for k, v in eng.drain().items()}
        state = (eng.draining, eng.begin_drain())
        eng.reset()
        h = eng.submit(_q(toy, 1))
        return dict(first=first, state=state, reopened=eng.draining,
                    after=_rec(h.result()))

    got = _both(toy, workload)
    assert got["state"] == (True, 0) and got["reopened"] is False
    assert got["after"][0] == "finished"


# ---------------------------------------------------------------------------
# the encoder-output LRU


@pytest.mark.parametrize("mode", ["greedy", "speculative"])
@pytest.mark.parametrize("paged", [True, False])
def test_encode_reuse_identity_and_stats_match_jax(toy, mode, paged):
    """Repeats interleaved with strangers (hits admitted beside misses):
    the port with the LRU == JAX with it == the port without it, and the
    counters equal JAX's."""
    kw = dict(mode=mode, max_new=10, n_slots=2)
    if mode == "speculative":
        kw.update(draft_len=4, n_drafts=6)
    if paged:
        kw.update(paged=True, page_size=8)
    je, te = _engines(toy, None, prefix_cache=True, **kw)
    cold = StreamingEngine(toy["pt"], toy["cfg_t"], toy["tok"],
                           EngineConfig(max_src=96, **kw), device="cpu")
    queries = [_q(toy, i) for i in (0, 1, 0, 2, 1, 0)]
    a, b, c = te.predict(queries), je.predict(queries), cold.predict(queries)
    assert [p.smiles for p in a] == [p.smiles for p in b] == \
        [p.smiles for p in c]
    assert [p.n_calls for p in a] == [p.n_calls for p in b]
    stats = te.prefix_stats()
    assert stats == je.prefix_stats()
    assert stats["lookups"] == len(queries) and stats["hit_tokens"] > 0
    assert stats["nodes"] == 3
    assert cold.prefix_stats()["hit_tokens"] == 0
    assert cold.prefix_stats()["lookups"] == 0


def test_encode_lru_bound_clear_and_reset_match_jax(toy):
    """Two entries: the oldest source is evicted (its repeat misses), the
    counters stay cumulative; ``clear_prefix_cache()`` empties the LRU and
    ``reset()`` starts the counters again."""

    def workload(eng):
        queries = [_q(toy, i) for i in (0, 1, 2, 0, 2, 2)]
        hs = [eng.submit(q) for q in queries]
        done = eng.serve()
        out = [_rec(done[int(h)]) for h in hs]
        stats = [eng.prefix_stats()]
        cleared = eng.clear_prefix_cache()
        eng.submit(queries[-1]).result()      # a miss again
        stats.append(eng.prefix_stats())
        eng.reset()
        stats.append(eng.prefix_stats())
        return dict(out=out, stats=stats, cleared=cleared)

    got = _both(toy, workload, None, prefix_cache=True,
                prefix_cache_entries=2, n_slots=2)
    first, after_clear, after_reset = got["stats"]
    assert first["lookups"] == 6 and first["nodes"] == 2
    assert after_clear["hit_tokens"] == first["hit_tokens"]
    assert after_reset["lookups"] == 0 and after_reset["nodes"] == 0


def test_prefix_cache_builds_no_graph_from_grad_params(toy):
    """Params that require grad (a trainer's): the LRU's entries and the
    cache hold no autograd graph."""
    pt = tree_unflatten(toy["pt"], [x.clone().requires_grad_(True)
                                    for x in tree_leaves(toy["pt"])])
    eng = StreamingEngine(pt, toy["cfg_t"], toy["tok"], EngineConfig(
        mode="greedy", max_new=4, max_src=96, prefix_cache=True),
        device="cpu")
    eng.submit(_q(toy, 0)).result()
    mkv, mask = next(iter(eng._encode_lru.values()))
    assert not mkv["mk"].requires_grad and mkv["mk"].grad_fn is None
    assert all(x.grad_fn is None for x in tree_leaves(
        eng.scheduler.state.cache) if isinstance(x, torch.Tensor))


# ---------------------------------------------------------------------------
# the tree of requests


def test_submit_child_matches_jax_and_plain_submit(toy):
    """A child (parent query + suffix) gives the tokens of a plain submit
    of the concatenated query, in both packages; it inherits the parent's
    mode and priority."""

    def workload(eng):
        root = eng.submit(_q(toy, 3), priority=3)
        r0 = _rec(root.result())
        child = root.submit_child("CC")
        grand = child.submit_child("O")
        rec = eng._lineage[int(child)]
        lineage = (rec["parent"] == int(root), rec["priority"],
                   int(child) in eng._lineage[int(root)]["children"],
                   child.mode == root.mode)
        plain = eng.submit(_q(toy, 3) + "CCO")
        res = (_rec(child.result()), _rec(grand.result()),
               _rec(plain.result()))
        return dict(root=r0, lineage=lineage, res=res)

    got = _both(toy, workload, None, n_slots=2)
    assert got["lineage"] == (True, 3, True, True)
    child, grand, plain = got["res"]
    assert grand[1:4] == plain[1:4]    # tokens, lengths, log-probs


def test_submit_child_validates(toy):
    for eng in _engines(toy):
        h = eng.submit(_q(toy, 0))
        with pytest.raises(KeyError):
            eng.submit_child(10 ** 9, "C")
        with pytest.raises(TypeError):
            eng.submit_child(h, np.array([5, 6], np.int32))
        tok = eng.submit(np.array([5, 6, 7], np.int32))
        kid = tok.submit_child(np.array([8], np.int32))
        np.testing.assert_array_equal(eng._lineage[int(kid)]["query"],
                                      [5, 6, 7, 8])


def test_cancel_subtree_matches_jax(toy):
    """One slot: the root runs, its two children and a grandchild queue.
    ``cancel(recursive=True)`` on the root cancels all four; on a finished
    root it still prunes queued descendants; a second call finds nothing."""

    def workload(eng):
        root = eng.submit(_q(toy, 4))
        kids = [root.submit_child(s) for s in ("C", "N")]
        grand = kids[0].submit_child("O")
        eng._pump_once()
        mid = [str(h.status) for h in (root, *kids, grand)]
        first = root.cancel(recursive=True)
        statuses = [str(h.status) for h in (root, *kids, grand)]
        with pytest.raises((RequestCancelled, JaxCancelled)):
            grand.result()
        again = eng.cancel_subtree(int(root))
        root2 = eng.submit(_q(toy, 5))
        root2.result()
        kid2 = root2.submit_child("C")
        pruned = root2.cancel(recursive=True)
        return dict(mid=mid, first=first, statuses=statuses, again=again,
                    pruned=(pruned, str(root2.status), str(kid2.status)),
                    counters=_counters(eng))

    got = _both(toy, workload)
    assert got["mid"] == ["running", "queued", "queued", "queued"]
    assert got["first"] is True and got["again"] == 0
    assert got["statuses"] == ["cancelled"] * 4
    assert got["pruned"] == (True, "finished", "cancelled")


def test_cancel_subtree_returns_every_page(toy):
    """Paged, one slot: a parent and two queued children cancelled as a
    tree leave the pool's free pages where they were before."""

    def workload(eng):
        free0 = eng.allocator.free_pages
        root = eng.submit(_q(toy, 6))
        kids = [root.submit_child(s) for s in ("C", "CC")]
        eng._pump_once()
        n = eng.cancel_subtree(int(root))
        eng.allocator.reclaim(eng.scheduler.state)
        eng.allocator.check()
        return dict(n=n, statuses=[str(h.status) for h in (root, *kids)],
                    free=(free0, eng.allocator.free_pages))

    got = _both(toy, workload, None, paged=True, page_size=8)
    assert got["n"] == 3 and got["statuses"] == ["cancelled"] * 3
    assert got["free"][0] == got["free"][1]


# ---------------------------------------------------------------------------
# EngineConfig validation


@pytest.mark.parametrize("kw", [dict(prefix_cache_entries=0),
                                dict(prefix_cache_pages=0),
                                dict(n_pages=1), dict(max_new=0),
                                dict(mode="nope"),
                                dict(mode_groups={"greedy": 0})])
def test_engine_config_errors_match_jax(kw):
    with pytest.raises(ValueError) as ej:
        JaxEngineConfig(**kw)
    with pytest.raises(ValueError) as et:
        EngineConfig(**kw)
    if "n_pages" not in kw:   # JAX's n_pages message adds an allocator note
        assert str(et.value) == str(ej.value)
