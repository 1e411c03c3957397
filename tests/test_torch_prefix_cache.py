"""The port's cross-request prefix page sharing (the radix page cache of a
paged decoder-only ``StreamingEngine``) against the JAX package's, on the
reduced ``smollm-135m`` and ``qwen3-8b`` configs with the JAX params
carried across by ``repro_torch.bridge`` (the decoder cases of
``tests/test_prefix_cache.py``):

- sharing is invisible in the tokens: a tree of requests served from
  aliased prefix pages gives the cold run's tokens and JAX's, greedy and
  speculative, and ``prefix_stats()`` (lookups, hit tokens, nodes,
  inserted, evicted, pages) equals JAX's; so with siblings admitted at
  once; a dense decoder-only engine ignores the flag;
- the tree-of-requests API: ``submit_child`` inherits and validates,
  ``cancel_subtree`` drops the subtree's cached pages, and a clear leaves
  every page free;
- under pool pressure the radix tree is reclaimed before residents are
  preempted, with JAX's evictions and preemptions and the cold tokens;
- a stream attached late catches up;
- the pieces: ``radix_cell_coords``, the block-table edits, the page
  plan's copy-on-write over a page an index cell shares, and
  ``RadixPageCache`` against JAX's class on drawn op sequences; the
  allocator's invariants over drawn tree interleavings.

The JAX engines are built once per module (``reset()`` between tests);
the port runs on the CPU (``device="cpu"``) with one torch thread.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st  # noqa: E402
except ImportError:  # hermetic env: the in-repo fallback
    from repro.testing import given, settings, strategies as st  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import session as jsession  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.attention import PagedKVCache as JaxPagedKVCache  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import StreamingEngine as JaxStreamingEngine  # noqa: E402
from repro.serving.api import RequestCancelled as JaxCancelled  # noqa: E402
from repro_torch.bridge import transformer_params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import session as tsession  # noqa: E402
from repro_torch.models.attention import PagedKVCache  # noqa: E402
from repro_torch.serving import EngineConfig, StreamingEngine  # noqa: E402
from repro_torch.serving.api import RequestCancelled  # noqa: E402

ARCHS = ["smollm-135m", "qwen3-8b"]
MAX_NEW = 10
EOS = 2
DL, ND = 4, 5
PS, CHUNK = 8, 8   # page_size == prefill_chunk: every full page shareable
# one engine serves both modes (one JAX compile): the groups share the
# cache, the pool and the radix tree
TREE = dict(mode_groups={"greedy": 2, "speculative": 2}, max_src=96)
# chunks of two pages: a match that ends off the 16-token grid is cut to
# it, and its hit tokens with it
GRID = dict(TREE, prefill_chunk=16)
# pools too small to retain every prompt's pages (one slot's worst case
# plus a little): reclaim must evict radix nodes
PRESSURE = {"greedy": dict(mode="greedy", n_slots=2, n_pages=14, max_src=64,
                           prefix_cache_pages=8),
            "speculative": dict(mode="speculative", n_slots=2, n_pages=32,
                                max_src=64, prefix_cache_pages=8)}
STATS = ("lookups", "hit_tokens", "lookup_tokens", "nodes", "inserted",
         "evicted", "pages_allocated", "requests_admitted")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX cfg, JAX params, port cfg, port params)."""
    out = {}

    def get(arch):
        if arch not in out:
            jcfg = jax_get_config(arch, reduced=True)
            cfg = get_config(arch, reduced=True)
            jp = jtr.init(jax.random.PRNGKey(0), jcfg)
            pt = transformer_params_from_jax(jax.tree.map(np.asarray, jp),
                                             device="cpu")
            out[arch] = (jcfg, jp, cfg, pt)
        return out[arch]

    return get


def _ecfg(**kw):
    base = dict(draft_len=DL, n_drafts=ND, max_new=MAX_NEW, n_slots=2,
                prefill_chunk=CHUNK, eos_id=EOS, paged=True, page_size=PS,
                prefix_cache=True)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def engines(models):
    """(arch, kind) -> (JAX shared, port shared, port cold) engines, built
    once and ``reset()`` for each use. ``kind``: "tree", "grid" or a
    PRESSURE mode."""
    out = {}

    def get(arch, kind):
        if (arch, kind) not in out:
            jcfg, jp, cfg, pt = models(arch)
            kw = _ecfg(**dict(PRESSURE, tree=TREE, grid=GRID)[kind])
            out[arch, kind] = (
                JaxStreamingEngine(jp, jcfg, None, JaxEngineConfig(**kw)),
                StreamingEngine(pt, cfg, None, EngineConfig(**kw),
                                device="cpu"),
                StreamingEngine(pt, cfg, None, EngineConfig(
                    **dict(kw, prefix_cache=False)), device="cpu"))
        for eng in out[arch, kind]:
            eng.reset()
        return out[arch, kind]

    return get


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    root = rng.integers(4, 500, size=25).astype(np.int32)
    suffixes = [rng.integers(4, 500, size=n).astype(np.int32)
                for n in (8, 13, 8, 21)]
    return root, suffixes


def _serve_tree(eng, mode):
    """Root -> two children -> two grandchildren of child 0, each parent
    finished (its pages committed) before its children are admitted.
    Returns the results in submission order."""
    root, sfx = _prompts()
    h = eng.submit(root, mode=mode)
    out = [h.result()]
    kids = [h.submit_child(sfx[0]), h.submit_child(sfx[1])]
    out += [k.result() for k in kids]
    grand = [kids[0].submit_child(sfx[2]), kids[0].submit_child(sfx[3])]
    out += [g.result() for g in grand]
    return out


def _same_results(got, want, label):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(a.tokens),
                                      np.asarray(b.tokens),
                                      err_msg=f"{label} request {i}")
        assert (a.n_calls, a.accepted) == (b.n_calls, b.accepted), \
            (label, i)


def _stats(eng):
    s = eng.prefix_stats()
    return {k: s[k] for k in STATS}


def _all_free(eng) -> bool:
    n_pages, _ = eng._paged_geometry()
    free = int(tsession.device_free_pages(eng.scheduler.state.cache,
                                          n_pages))
    return free == n_pages - 1


# ---------------------------------------------------------------------------
# 1. sharing is token-invisible, and counts as JAX counts


@pytest.mark.parametrize("kind", ["tree", "grid"])
@pytest.mark.parametrize("mode", ["greedy", "speculative"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_identity_and_stats_match_jax(engines, arch, mode, kind,
                                           monkeypatch):
    """A tree served from aliased prefix pages == the cold engine's
    tokens == JAX's, with JAX's ``prefix_stats()``; children prefill only
    their suffixes, so the shared engine maps fewer pages. ``grid``: pages
    of 8 and chunks of 16, so a child whose match ends mid-chunk has it
    cut to the chunk grid (and its hit tokens lowered), as JAX cuts it."""
    je, te, cold = engines(arch, kind)
    matched = []
    radix_match = te.radix.match

    def match(body):
        chain = radix_match(body)
        matched.append(len(chain))
        return chain

    monkeypatch.setattr(te.radix, "match", match)
    got = _serve_tree(te, mode)
    _same_results(got, _serve_tree(cold, mode), "shared vs cold")
    _same_results(got, _serve_tree(je, mode), "port vs JAX")
    assert _stats(te) == _stats(je)
    if kind == "grid":
        assert te._align_pages == 2
        assert any(n % 2 for n in matched), matched   # a cut match
    stats = te.prefix_stats()
    assert stats["prefix_hit_rate"] > 0.0 and stats["nodes"] > 0
    assert stats["pages_per_request"] < cold.prefix_stats()[
        "pages_per_request"]
    assert te.prefill_chunks_written < cold.prefill_chunks_written
    te.allocator.check()
    te.radix.check()
    assert te.cache_footprint()["retained_pages"] == len(te.radix)
    # the index rows count live in every host scan, as JAX pins them
    assert set(range(te.n_rows, te.n_rows + te._n_index_rows)) <= \
        te.allocator._pinned_rows


@pytest.mark.parametrize("mode", ["greedy", "speculative"])
@pytest.mark.parametrize("arch", ARCHS)
def test_siblings_admitted_together_match_jax(engines, arch, mode):
    """The root served alone, then four children submitted at once (the
    later ones wait for a slot): every child aliases the root's pages;
    tokens == cold == JAX, stats == JAX's."""
    je, te, cold = engines(arch, "tree")
    root, sfx = _prompts(seed=1)
    runs = []
    for eng in (te, cold, je):
        h = eng.submit(root, mode=mode)
        eng.serve()
        kids = [h.submit_child(s) for s in sfx]
        eng.serve()
        runs.append([h.result()] + [k.result() for k in kids])
    _same_results(runs[0], runs[1], "shared vs cold")
    _same_results(runs[0], runs[2], "port vs JAX")
    assert _stats(te) == _stats(je)
    assert te.prefix_stats()["hit_tokens"] >= 4 * 24   # 3 pages a child


def test_dense_decoder_engine_ignores_prefix_cache(models):
    """A dense decoder-only cache has nothing to alias: no radix tree, and
    the cold tokens (the JAX package's flag is a no-op there too)."""
    _, _, cfg, pt = models("smollm-135m")
    runs = []
    for share in (True, False):
        eng = StreamingEngine(pt, cfg, None, EngineConfig(**_ecfg(
            mode="speculative", max_src=96, paged=False,
            prefix_cache=share)), device="cpu")
        runs.append(_serve_tree(eng, "speculative"))
        assert eng.radix is None
    _same_results(runs[0], runs[1], "dense shared vs cold")


# ---------------------------------------------------------------------------
# 2. the tree-of-requests API


def test_submit_child_inherits_and_validates(engines):
    _, eng, _ = engines("smollm-135m", "tree")
    root, sfx = _prompts()
    h = eng.submit(root, priority=3, mode="speculative")
    h.result()
    child = h.submit_child(sfx[0])
    assert child.mode == h.mode == "speculative"
    rec = eng._lineage[int(child)]
    assert rec["parent"] == int(h) and rec["priority"] == 3
    assert int(child) in eng._lineage[int(h)]["children"]
    child.result()
    assert eng.prefix_stats()["hit_tokens"] > 0
    with pytest.raises(KeyError):
        eng.submit_child(10 ** 9, sfx[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_cancel_subtree_releases_cached_pages(engines, arch):
    """Pruning a subtree cancels every descendant and drops the radix
    nodes the pruned requests inserted, as JAX's engine does; a clear then
    leaves every page of the pool free."""
    sizes = []
    for eng in engines(arch, "tree")[:2]:
        root, sfx = _prompts()
        h = eng.submit(root, mode="greedy")
        h.result()
        kids = [h.submit_child(s) for s in sfx[:2]]
        for k in kids:
            k.result()
        grand = kids[0].submit_child(sfx[2])
        before = len(eng.radix)
        assert before > 0
        assert h.cancel(recursive=True)
        assert grand.status == "cancelled"
        with pytest.raises((RequestCancelled, JaxCancelled)):
            grand.result()
        after = len(eng.radix)
        assert after < before
        eng.radix.check()
        cleared = eng.clear_prefix_cache()
        assert len(eng.radix) == 0 and cleared == after
        sizes.append((before, after, eng.radix.evicted))
    assert sizes[0] == sizes[1]
    port = engines(arch, "tree")[1]
    assert _all_free(port)
    port.allocator.check()


# ---------------------------------------------------------------------------
# 3. retention is a cache: reclaim under pool pressure


@pytest.mark.parametrize("mode", ["greedy", "speculative"])
@pytest.mark.parametrize("arch", ARCHS)
def test_radix_reclaim_under_pool_pressure(engines, arch, mode):
    """A pool too small to retain every prompt's pages: the scheduler
    evicts LRU radix nodes rather than preempting residents; every request
    finishes with the cold tokens, and evictions, preemptions and stats
    equal JAX's."""
    je, te, cold = engines(arch, mode)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(4, 500, size=41).astype(np.int32)
               for _ in range(6)]
    # a shared stem, so later prompts hit what survives
    for p in prompts[3:]:
        p[:16] = prompts[0][:16]
    runs = []
    for eng in (te, cold, je):
        handles = [eng.submit(p) for p in prompts]
        runs.append([h.result() for h in handles])
        assert all(r.status == "finished" for r in runs[-1])
    _same_results(runs[0], runs[1], "shared vs cold")
    _same_results(runs[0], runs[2], "port vs JAX")
    assert te.radix.evicted > 0, "the pool is sized to force radix reclaim"
    assert _stats(te) == _stats(je)
    assert te.scheduler.n_preemptions == je.scheduler.n_preemptions
    te.allocator.check()
    te.radix.check()


# ---------------------------------------------------------------------------
# 4. streams


def test_stream_late_attach(engines):
    """A stream opened after iterations already committed tokens catches up
    once and then yields deltas that concatenate to the final tokens."""
    _, eng, _ = engines("smollm-135m", "tree")
    root, sfx = _prompts()
    first = eng.submit(root, mode="greedy")
    first.result()
    h = first.submit_child(sfx[1])          # served from the shared pages
    pump = eng.serve_steps()
    for _ in zip(range(6), pump):
        pass
    deltas = list(h.stream())
    got = np.concatenate([d for d in deltas if d.size] or
                         [np.zeros(0, np.int32)])
    r = eng.wait(h.rid)
    np.testing.assert_array_equal(got, np.asarray(r.tokens[0])[:r.lengths[0]])
    assert eng.prefix_stats()["hit_tokens"] > 0


# ---------------------------------------------------------------------------
# 5. the pieces


def test_radix_cell_coords_match_jax():
    for n_rows, n_blocks, cells in ((6, 4, range(10)), (3, 7, [0, 13, 6])):
        a = tsession.radix_cell_coords(n_rows, n_blocks, cells)
        b = jsession.radix_cell_coords(n_rows, n_blocks, cells)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    rows, blocks = tsession.radix_cell_coords(6, 4, range(10))
    assert rows.tolist() == [6, 6, 6, 6, 7, 7, 7, 7, 8, 8]
    assert blocks.tolist() == [0, 1, 2, 3, 0, 1, 2, 3, 0, 1]


def test_block_table_edits_match_jax():
    """write / clear index cells, alias a prefix and read row pages on a
    two-layer table: the port's in-place edits of exactly the live lanes
    give JAX's tables, whose fixed-width edits drop the lanes past
    ``count``."""
    rng = np.random.default_rng(3)
    R, rows, nb, P = 2, 7, 5, 30
    bt = rng.integers(-1, P, (rows, nb)).astype(np.int32)
    tcache = (PagedKVCache(torch.zeros((R, P, 4, 1, 2)),
                           torch.zeros((R, P, 4, 1, 2)),
                           torch.full((R, P, 4), -1, dtype=torch.int32),
                           torch.from_numpy(np.stack([bt] * R))),)
    jcache = (JaxPagedKVCache(jnp.zeros((R, P, 4, 1, 2)),
                              jnp.zeros((R, P, 4, 1, 2)),
                              jnp.full((R, P, 4), -1, jnp.int32),
                              jnp.asarray(np.stack([bt] * R))),)
    r = np.array([5, 6, 6, 0], np.int32)
    b = np.array([1, 0, 4, 0], np.int32)
    pages = np.array([11, 12, 13, 99], np.int32)
    alias = np.array([7, 8, 9, -1], np.int32)
    steps = [("write_index_cells", (r[:3], b[:3], pages[:3]),
              (r, b, pages, 3)),
             ("clear_index_cells", (r[1:2], b[1:2]), (r[1:], b[1:], 1)),
             ("alias_prefix_pages", (2, alias[:3]), (2, alias, 3))]
    for name, targs, args in steps:
        tcache = getattr(tsession, name)(tcache, *targs)
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else
                 jnp.int32(a) for a in args]
        jcache = getattr(jsession, name)(jcache, *jargs)
        np.testing.assert_array_equal(tcache[0].block_tables.numpy(),
                                      np.asarray(jcache[0].block_tables),
                                      err_msg=name)
    np.testing.assert_array_equal(
        tsession.read_row_pages(tcache, [2, 0, 5], 4).numpy(),
        np.asarray(jsession.read_row_pages(jcache, [2, 0, 5], 4)))


def test_page_plan_shared_page_never_kept_by_non_owner():
    """A write-window page an index cell also references is never kept in
    place: the lane takes a new page and copies (a mid-page boundary), so
    the shared page stays read-only and the index row keeps it."""
    spec = tsession.SessionSpec(n_slots=2, n_beams=1, n_drafts=1,
                                draft_len=4, max_new=8, eos_id=EOS)
    ps, n_pages = 4, 12
    n_blocks = -(-spec.cache_len // ps)
    bt = np.full((spec.n_rows + 1, n_blocks), -1, np.int32)
    bt[0, 0] = 3                 # row 0's block 0 ...
    bt[2, 0] = 3                 # ... and the index row share page 3
    k_pool = torch.zeros((1, n_pages, ps, 1, 4))
    k_pool[:, 3] = 7.0
    pos = torch.full((1, n_pages, ps), -1, dtype=torch.int32)
    pos[:, 3] = 2
    cache = PagedKVCache(k_pool=k_pool, v_pool=torch.zeros_like(k_pool),
                         pos=pos, block_tables=torch.from_numpy(bt)[None])
    state = tsession.init_state(spec, None, device="cpu")
    state.active[0] = True
    state.pos[0, 0] = 2
    state.finished[0] = False
    gstate = tsession.GroupedState(groups=(state,), cache=cache)
    plan = tsession.device_page_plan((spec,), (n_blocks,), ps, n_pages,
                                     gstate)
    lanes = plan.need & (plan.cur == 3)
    assert bool(lanes.any()), "the shared page must be replaced, not kept"
    assert bool(plan.copy[lanes].all()), "a mid-page boundary copies"
    assert bool((plan.new[lanes] != 3).all())
    tsession.apply_page_plan(cache, plan)
    new_page = int(plan.new[lanes][0])
    assert torch.equal(cache.k_pool[0, new_page], k_pool.new_full(
        (ps, 1, 4), 7.0))
    assert int(cache.block_tables[0, 0, 0]) == new_page
    assert int(cache.block_tables[0, 2, 0]) == 3, \
        "the index row keeps the original shared page"


def _radix_ops(cache, ops, tokens):
    """Apply one drawn op sequence to a RadixPageCache (either package's)
    and return what each op returned, as plain values."""
    out, chains, page = [], [], 100
    for op in ops:
        kind, arg = op % 6, op // 6
        toks = tokens[arg % len(tokens)]
        if kind == 0:
            chain = cache.match(toks)
            chains.append(chain)
            out.append(("match", [nd.page for nd in chain]))
        elif kind == 1:
            out.append(("peek", [nd.page for nd in cache.peek(toks)]))
        elif kind == 2:
            depth0 = len(cache.peek(toks)) if arg % 2 else 0
            n = len(toks) // cache.page_size
            pages = list(range(page, page + n))
            page += n
            new = cache.insert(toks, pages, depth0)
            out.append(("insert", [(nd.cell, nd.page, nd.depth)
                                   for nd in new]))
        elif kind == 3 and chains:
            chain = chains[arg % len(chains)]
            if arg % 2:
                cache.acquire(chain)
            elif all(nd.active > 0 for nd in chain):
                cache.release(chain)
            out.append(("hold", [nd.active for nd in chain]))
        elif kind == 4:
            out.append(("evict", cache.evict_lru(1 + arg % 3)))
        elif kind == 5 and len(cache):
            node = sorted(cache._nodes_by_cell.items())[
                arg % len(cache)][1]
            out.append(("drop", cache.drop_subtree(node)))
        cache.check()
    out.append(("stats", (len(cache), cache.free_cells, cache.lookups,
                          cache.hit_tokens, cache.lookup_tokens,
                          cache.inserted, cache.evicted)))
    return out


@settings(max_examples=12, deadline=None)
@given(st.lists(st.integers(0, 10 ** 6), min_size=1, max_size=40))
def test_radix_page_cache_matches_jax(ops):
    """The port's tree against JAX's on the same op sequence (prompts that
    share stems, few cells so inserts run out): every op returns the same
    nodes, pages, cells and pairs, the stats agree, the invariants hold."""
    rng = np.random.default_rng(ops[0])
    stem = rng.integers(4, 9, 12)
    tokens = [np.concatenate([stem[:rng.integers(0, 13)],
                              rng.integers(4, 9, rng.integers(0, 14))])
              for _ in range(5)]
    a = _radix_ops(tsession.RadixPageCache(3, 7), ops, tokens)
    b = _radix_ops(jsession.RadixPageCache(3, 7), ops, tokens)
    assert a == b


_HYP_ENGINE = []


def _hyp_engine():
    """One engine across examples (``reset()`` between them)."""
    if not _HYP_ENGINE:
        cfg = get_config("smollm-135m", reduced=True)
        jp = jtr.init(jax.random.PRNGKey(0),
                      jax_get_config("smollm-135m", reduced=True))
        pt = transformer_params_from_jax(jax.tree.map(np.asarray, jp),
                                         device="cpu")
        _HYP_ENGINE.append(StreamingEngine(pt, cfg, None, EngineConfig(
            **_ecfg(mode="greedy", max_new=6, max_src=96)), device="cpu"))
    return _HYP_ENGINE[0]


@settings(max_examples=6, deadline=None)
@given(st.lists(st.integers(0, 10 ** 6), min_size=1, max_size=12))
def test_tree_ops_preserve_allocator_invariants(ops):
    """Any interleaving of submit / submit_child / drain / cancel
    (recursive or not) leaves the allocator and the tree consistent; once
    every tree is pruned and the cache cleared, no page is leaked."""
    torch.set_num_threads(1)
    eng = _hyp_engine()
    eng.reset()
    rng = np.random.default_rng(ops[0])
    handles, roots = [], []
    for op in ops:
        kind = op % 4
        if kind == 1 and handles:
            parent = handles[(op // 4) % len(handles)]
            if len(eng._lineage[int(parent)]["query"]) < 70:
                handles.append(parent.submit_child(
                    rng.integers(4, 500, size=5 + op % 12)
                    .astype(np.int32)))
                continue
        if kind == 2 and handles:
            try:
                handles[(op // 4) % len(handles)].result()
            except RequestCancelled:
                pass
            continue
        if kind == 3 and handles:
            handles[(op // 4) % len(handles)].cancel(
                recursive=bool((op // 4) % 2))
            continue
        h = eng.submit(rng.integers(4, 500, size=9 + op % 30)
                       .astype(np.int32))
        handles.append(h)
        roots.append(h)
    eng.serve()
    rx = eng.radix
    rx.check()
    eng.allocator.check()
    assert all(nd.active == 0 for nd in rx._nodes_by_cell.values())
    for r in roots:
        r.cancel(recursive=True)
    eng.clear_prefix_cache()
    assert len(rx) == 0
    assert _all_free(eng)
