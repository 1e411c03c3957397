"""The port's StreamingEngine (continuous batching, dense and paged KV cache)
against the JAX package's, on the random tiny MT of ``tests/test_session.py``
carried across with ``repro_torch.bridge``.

- layers: ``cached_attention`` / ``decode_step`` on a paged cache against
  JAX's on the same pool and tables (1e-4, fp32 on the CPU);
- page planning: ``device_page_plan`` + ``apply_page_plan`` give JAX's
  tables, lanes and pool contents; the host ``PageAllocator`` keeps its
  invariants on random traces and after a serve;
- the slice end to end: tokens and ``n_calls`` identical to the JAX engine
  in all four modes, dense and paged, with mid-stream admission, more
  requests than slots, pool exhaustion (preempt and replay), mixed mode
  groups, per-request params, streaming and cancellation; beam log-probs
  within 1e-5;
- the fully-masked-row difference: where the port and the JAX einsum read
  differ, and that the difference never reaches committed tokens.

Each JAX engine is built once per module (its jits are kept across
``reset()``); the port's engines run on the CPU (``device="cpu"``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.mt import tiny_config as jax_tiny_config  # noqa: E402
from repro.core import session as jsession  # noqa: E402
from repro.core import tree_batch as jtb  # noqa: E402
from repro.data import SyntheticReactionDataset  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import GenerationParams as JaxGenerationParams  # noqa: E402
from repro.serving import StreamingEngine as JaxStreamingEngine  # noqa: E402
from repro_torch.bridge import seq2seq_params_from_jax  # noqa: E402
from repro_torch.configs.mt import tiny_config  # noqa: E402
from repro_torch.core import session as tsession  # noqa: E402
from repro_torch.core import tree_batch as ttb  # noqa: E402
from repro_torch.data.tokenizer import SmilesTokenizer  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import seq2seq as ts2s  # noqa: E402
from repro_torch.serving import (EngineConfig, GenerationParams,  # noqa: E402
                                 OverloadPolicy, RequestCancelled,
                                 StreamingEngine, make_backend)

MAX_NEW = 20
# the engine configs the tests share (each JAX engine compiles once)
SPEC_PAGED = dict(mode="speculative", draft_len=4, n_drafts=6, n_slots=2,
                  paged=True, page_size=8)
MODES = [
    ("greedy", {}),
    ("speculative", dict(draft_len=4, n_drafts=6)),
    ("beam", dict(n_beams=3)),
    ("speculative_beam", dict(n_beams=3, draft_len=4, n_drafts=6)),
]


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
    """The random tiny MT in both packages (the ``toy`` of
    ``tests/test_session.py``) and a cache of JAX engines by config."""
    ds = SyntheticReactionDataset(16, seed=0)
    V = ds.tokenizer.vocab_size
    cfg_j = jax_tiny_config(V, depth=2, d_model=64, max_len=192)
    pj = js2s.init(jax.random.PRNGKey(0), cfg_j)
    cfg_t = tiny_config(V, depth=2, d_model=64, max_len=192)
    pt = seq2seq_params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    tok = SmilesTokenizer.from_dict(ds.tokenizer.to_dict())
    jax_engines = {}

    def port(**kw):
        """A port engine on the CPU for one EngineConfig."""
        return StreamingEngine(pt, cfg_t, tok, EngineConfig(
            max_new=MAX_NEW, max_src=96, **kw), device="cpu")

    def engines(**kw):
        """(JAX engine, port engine) for one EngineConfig."""
        key = repr(sorted(kw.items()))
        if key not in jax_engines:
            jax_engines[key] = JaxStreamingEngine(
                pj, cfg_j, ds.tokenizer,
                JaxEngineConfig(max_new=MAX_NEW, max_src=96, **kw))
        je = jax_engines[key]
        je.reset()
        return je, port(**kw)

    return dict(ds=ds, cfg_j=cfg_j, pj=pj, cfg_t=cfg_t, pt=pt, tok=tok,
                port=port, engines=engines)


def _queries(toy, n, offset=0):
    return [toy["ds"].pair((i + offset) % 16)[0] for i in range(n)]


def _assert_results_equal(rt, rj, logp_tol=1e-5):
    np.testing.assert_array_equal(rt.tokens, rj.tokens)
    np.testing.assert_array_equal(rt.lengths, rj.lengths)
    assert rt.n_calls == rj.n_calls and rt.accepted == rj.accepted
    np.testing.assert_allclose(rt.logprobs, rj.logprobs, atol=logp_tol,
                               rtol=logp_tol)


def _serve_both(je, te, jobs):
    """Submit ``jobs`` [(query, submit kwargs)] to both engines, serve, and
    return the paired results in submission order."""
    hj = [je.submit(q, **kw) for q, kw in jobs]
    ht = [te.submit(q, **kw) for q, kw in jobs]
    rj, rt = je.serve(), te.serve()
    assert sorted(rt) == [int(h) for h in ht]
    return [(rt[int(a)], rj[int(b)]) for a, b in zip(ht, hj)]


# ---------------------------------------------------------------------------
# the fully-masked-row difference (ROADMAP Queue 3)


def test_fully_masked_row_port_zero_jax_einsum_mean(toy):
    """Where the packages differ: a row whose positions are all -1 (an
    inactive streaming slot) sees no key. The port's read returns 0 there;
    the JAX model's einsum read returns the uniform mean of V. Rows with a
    visible key agree."""
    cfg_j, cfg_t = toy["cfg_j"], toy["cfg_t"]
    pj, pt = toy["pj"], toy["pt"]
    rng = np.random.default_rng(0)
    B, T, S = 2, 3, 12
    x = rng.standard_normal((B, T, cfg_t.d_model)).astype(np.float32)
    positions = np.array([[4, 5, 6], [-1, -1, -1]], np.int32)
    kc = rng.standard_normal((B, S, cfg_t.n_kv_heads, cfg_t.head_dim)
                             ).astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    kpos = np.where(np.arange(S) < 4, np.arange(S), -1)[None].repeat(B, 0
                                                                     ).astype(np.int32)
    p_t = pt["dec_blocks"][0]["self_attn"]
    p_j = jax.tree.map(lambda a: a[0], pj["dec_blocks"])["self_attn"]
    out_t, _ = tattn.cached_attention(
        p_t, cfg_t, torch.from_numpy(x),
        tattn.KVCache(torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()),
                      torch.from_numpy(kpos.copy())),
        torch.from_numpy(positions))
    out_j, _ = jax.jit(lambda *a: jattn.cached_attention(p_j, cfg_j, *a))(
        jnp.asarray(x),
        jattn.KVCache(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kpos)),
        jnp.asarray(positions))
    out_t, out_j = out_t.numpy(), np.asarray(out_j)
    np.testing.assert_allclose(out_t[0], out_j[0], atol=1e-4, rtol=1e-4)
    # the masked row: attention output 0 -> just the output projection's
    # bias on the port's side; the JAX einsum mixes in mean(V)
    bias = p_t["wo"]["b"].numpy()
    np.testing.assert_allclose(out_t[1], np.broadcast_to(bias, out_t[1].shape),
                               atol=1e-6)
    assert np.abs(out_j[1] - out_t[1]).max() > 1e-3


def test_fully_masked_rows_never_reach_committed_tokens(toy):
    """End to end the difference is invisible: one request in a 2-slot
    paged session leaves the other slot inactive every step (its rows fed
    at position -1), yet tokens, lengths and n_calls equal the JAX
    engine's, and the inactive slot commits nothing."""
    je, te = toy["engines"](**SPEC_PAGED)
    [(rt, rj)] = _serve_both(je, te, [(_queries(toy, 1)[0], {})])
    _assert_results_equal(rt, rj)
    gs = te.scheduler.state.groups[0]
    assert int(gs.n_out[1:].sum()) == 0 and not bool(gs.active.any())


# ---------------------------------------------------------------------------
# layers on a paged cache


def _paged_pair(cfg_t, rng, *, R, B, P, ps, nb, n_mapped):
    """The same random stacked paged cache for both packages."""
    kv = (R, P, ps, cfg_t.n_kv_heads, cfg_t.head_dim)
    k_pool = rng.standard_normal(kv).astype(np.float32)
    v_pool = rng.standard_normal(kv).astype(np.float32)
    bt = np.full((B, nb), -1, np.int32)
    bt[:, :n_mapped] = rng.permutation(np.arange(1, P))[:B * n_mapped
                                                        ].reshape(B, n_mapped)
    pos = np.full((P, ps), -1, np.int32)
    for b in range(B):
        for j in range(n_mapped):
            pos[bt[b, j]] = j * ps + np.arange(ps)
    pos = np.broadcast_to(pos, (R, P, ps)).copy()
    bt = np.broadcast_to(bt, (R, B, nb)).copy()
    t = tattn.PagedKVCache(*(torch.from_numpy(a.copy())
                             for a in (k_pool, v_pool, pos, bt)))
    j = jattn.PagedKVCache(*(jnp.asarray(a) for a in (k_pool, v_pool, pos,
                                                      bt)))
    return t, j


def test_cached_attention_paged_matches_jax(toy):
    cfg_j, cfg_t = toy["cfg_j"], toy["cfg_t"]
    rng = np.random.default_rng(1)
    B, T, ps, nb = 3, 5, 8, 4
    ct, cj = _paged_pair(cfg_t, rng, R=1, B=B, P=1 + B * 3, ps=ps, nb=nb,
                         n_mapped=3)
    ct = tattn.PagedKVCache(*(getattr(ct, f)[0] for f in
                              ("k_pool", "v_pool", "pos", "block_tables")))
    cj = jax.tree.map(lambda a: a[0], cj)
    x = rng.standard_normal((B, T, cfg_t.d_model)).astype(np.float32)
    # row 0 writes into mapped blocks, row 1 past them (trash page), row 2
    # is inactive (position -1)
    positions = np.array([17 + np.arange(T), 24 + np.arange(T),
                          np.full(T, -1)], np.int32)
    p_t = toy["pt"]["dec_blocks"][1]["self_attn"]
    p_j = jax.tree.map(lambda a: a[1], toy["pj"]["dec_blocks"])["self_attn"]
    out_t, ct = tattn.cached_attention(p_t, cfg_t, torch.from_numpy(x), ct,
                                       torch.from_numpy(positions))
    out_j, cj = jax.jit(lambda *a: jattn.cached_attention(p_j, cfg_j, *a))(
        jnp.asarray(x), cj, jnp.asarray(positions))
    np.testing.assert_allclose(out_t.numpy()[:2], np.asarray(out_j)[:2],
                               atol=1e-4, rtol=1e-4)
    # the writes land on the same pages (trash page 0 aside)
    np.testing.assert_array_equal(ct.pos.numpy()[1:], np.asarray(cj.pos)[1:])
    np.testing.assert_allclose(ct.k_pool.numpy()[1:],
                               np.asarray(cj.k_pool)[1:], atol=1e-5)


def test_decode_step_paged_matches_jax(toy):
    """``decode_step`` on a paged cache with the memory mask stored in the
    cache, against JAX's: logits within 1e-4 on the rows with keys."""
    cfg_j, cfg_t = toy["cfg_j"], toy["cfg_t"]
    rng = np.random.default_rng(2)
    B, T, M, ps, nb = 2, 3, 10, 8, 4
    src = rng.integers(4, cfg_t.vocab_size, (B, M)).astype(np.int32)
    src[1, 7:] = 0
    mem_t, mask_t = ts2s.encode(toy["pt"], cfg_t, torch.from_numpy(src))
    mem_j, mask_j = js2s.encode(toy["pj"], cfg_j, jnp.asarray(src))
    paged = (1 + B * nb, ps)
    ct = ts2s.init_cache(cfg_t, B, ps * nb, memory=mem_t, params=toy["pt"],
                         memory_mask=mask_t, paged=paged)
    cj = js2s.init_cache(cfg_j, B, ps * nb, memory=mem_j, params=toy["pj"],
                         memory_mask=mask_j, paged=paged)
    bt = np.arange(1, 1 + B * nb, dtype=np.int32).reshape(B, nb)
    ct["self"].block_tables[:] = torch.from_numpy(bt)
    cj["self"] = dataclasses.replace(
        cj["self"], block_tables=jnp.broadcast_to(jnp.asarray(bt),
                                                  cj["self"].block_tables.shape))
    toks = rng.integers(4, cfg_t.vocab_size, (B, T)).astype(np.int32)
    j_step = jax.jit(lambda c, t, p: js2s.decode_step(toy["pj"], cfg_j, c, t,
                                                       p))
    for step in range(2):
        positions = (step * T + np.arange(T))[None].repeat(B, 0).astype(
            np.int32)
        lt, ct = ts2s.decode_step(toy["pt"], cfg_t, ct, torch.from_numpy(toks),
                                  torch.from_numpy(positions))
        lj, cj = j_step(cj, jnp.asarray(toks), jnp.asarray(positions))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                                   rtol=1e-4)


def test_tree_batch_paged_ops_touch_only_tables(toy):
    """Batch-row ops on a paged node move block-table rows exactly as JAX's
    do and leave the pool alone."""
    rng = np.random.default_rng(3)
    ct, cj = _paged_pair(toy["cfg_t"], rng, R=2, B=6, P=19, ps=4, nb=5,
                         n_mapped=3)
    x = rng.standard_normal((2, 6, 3)).astype(np.float32)   # a dense leaf
    tc, jc = {"self": ct, "x": torch.from_numpy(x)}, {"self": cj,
                                                      "x": jnp.asarray(x)}

    def same(t, j):
        np.testing.assert_array_equal(t["self"].block_tables.numpy(),
                                      np.asarray(j["self"].block_tables))
        np.testing.assert_array_equal(t["x"].numpy(), np.asarray(j["x"]))
        assert t["self"].k_pool is ct.k_pool

    best = np.array([2, 0], np.int32)
    same(ttb.sync_winner(tc, torch.from_numpy(best), 3),
         jtb.sync_winner(jc, jnp.asarray(best), 3))
    src = np.array([5, 5, 0, 1, 3, 2], np.int32)
    same(ttb.gather_rows(tc, torch.from_numpy(src)),
         jtb.gather_rows(jc, jnp.asarray(src)))
    same(ttb.expand_batch(tc, 2), jtb.expand_batch(jc, 2))
    same(ttb.slice_rows(tc, 1, 4), jtb.slice_rows(jc, 1, 4))
    same(ttb.take_rows(tc, [4, 0]), jtb.take_rows(jc, [4, 0]))
    same(ttb.dynamic_slice_rows(tc, 2, 3), jtb.dynamic_slice_rows(jc, 2, 3))
    # the port's merges write in place: each starts from a fresh copy
    fresh = lambda: {"self": dataclasses.replace(  # noqa: E731
        ct, block_tables=ct.block_tables.clone()), "x": torch.from_numpy(
            x.copy())}
    part_t = ttb.gather_rows(ttb.slice_rows(tc, 1, 4),
                             torch.tensor([2, 2, 0]))
    part_j = jtb.gather_rows(jtb.slice_rows(jc, 1, 4), jnp.asarray([2, 2, 0]))
    same(ttb.merge_rows(fresh(), part_t, 1, 4),
         jtb.merge_rows(jc, part_j, 1, 4))
    sub_t = ttb.gather_rows(ttb.take_rows(fresh(), [4, 0]),
                            torch.tensor([1, 0]))
    sub_j = jtb.gather_rows(jtb.take_rows(jc, [4, 0]), jnp.asarray([1, 0]))
    same(ttb.put_rows(fresh(), sub_t, [4, 0]), jtb.put_rows(jc, sub_j, [4, 0]))
    sub_t = ttb.gather_rows(ttb.dynamic_slice_rows(fresh(), 2, 3),
                            torch.tensor([2, 1, 0]))
    sub_j = jtb.gather_rows(jtb.dynamic_slice_rows(jc, 2, 3),
                            jnp.asarray([2, 1, 0]))
    same(ttb.dynamic_merge_rows(fresh(), sub_t, 2),
         jtb.dynamic_merge_rows(jc, sub_j, 2))
    vals = rng.standard_normal((2, 1, 3)).astype(np.float32)
    rows = np.array([1, 3])
    t_set = fresh()
    t_set["x"] = ttb.set_rows({"x": t_set["x"]}, torch.from_numpy(rows),
                              {"x": torch.from_numpy(vals)})["x"]
    j_set = dict(jc, x=jtb.set_rows({"x": jc["x"]}, jnp.asarray(rows),
                                    {"x": jnp.asarray(vals)})["x"])
    same(t_set, j_set)


def test_backend_row_helpers_match_jax(toy):
    """The decoder-only backend's cache-row helpers (recycle rows, adopt
    row 0) on a paged and a dense leaf, against JAX's."""
    from repro.serving.backend import _adopt_row0 as j_adopt
    from repro.serving.backend import _clean_rows as j_clean
    from repro_torch.serving.backend import _adopt_row0, _clean_rows
    rng = np.random.default_rng(4)
    ct, cj = _paged_pair(toy["cfg_t"], rng, R=2, B=6, P=19, ps=4, nb=5,
                         n_mapped=3)
    x = rng.standard_normal((2, 6, 3)).astype(np.float32)
    rows = np.array([2, 3, 4])
    for t_fn, j_fn in ((_clean_rows, j_clean), (_adopt_row0, j_adopt)):
        t = t_fn({"self": dataclasses.replace(
            ct, block_tables=ct.block_tables.clone()),
            "x": torch.from_numpy(x.copy())}, rows)
        j = j_fn({"self": cj, "x": jnp.asarray(x)}, jnp.asarray(rows))
        np.testing.assert_array_equal(t["self"].block_tables.numpy(),
                                      np.asarray(j["self"].block_tables))
        np.testing.assert_array_equal(t["x"].numpy(), np.asarray(j["x"]))


# ---------------------------------------------------------------------------
# page planning


def _plan_states(seed):
    """A seeded grouped state over a small paged cache: two groups (greedy
    and a speculative group with 3 drafts), rows aliasing pages the way
    winner sync leaves them, some slots inactive."""
    rng = np.random.default_rng(seed)
    specs = (tsession.SessionSpec(n_slots=2, n_beams=1, n_drafts=1,
                                  draft_len=0, max_new=12, eos_id=1),
             tsession.SessionSpec(n_slots=2, n_beams=1, n_drafts=3,
                                  draft_len=3, max_new=12, eos_id=1))
    ps, P = 4, 40
    n_rows = sum(s.n_rows for s in specs)
    nb = -(-max(s.cache_len for s in specs) // ps)
    bt = np.full((n_rows, nb), -1, np.int32)
    pages = list(rng.permutation(np.arange(1, P)))
    pos = [rng.integers(0, 10, (2, 1)), rng.integers(0, 10, (2, 1))]
    active = [rng.random(2) < 0.8, rng.random(2) < 0.8]
    for r in range(n_rows):
        for j in range(int(rng.integers(0, 4))):
            bt[r, j] = pages.pop()
    # aliasing: the speculative slot 0's rows share its row 0's pages
    bt[3:5, :2] = bt[2, :2]
    k_pool = rng.standard_normal((1, P, ps, 2, 4)).astype(np.float32)
    pos_pool = rng.integers(-1, 12, (1, P, ps)).astype(np.int32)
    blocks = tuple(-(-s.cache_len // ps) for s in specs)
    return specs, blocks, ps, P, bt, k_pool, pos_pool, pos, active


_JAX_PLANS = {}


def _jax_plan(specs, blocks, ps, P):
    """The JAX plan, jitted once per geometry (op by op it compiles every
    small op anew)."""
    key = (specs, blocks, ps, P)
    if key not in _JAX_PLANS:
        _JAX_PLANS[key] = jax.jit(
            lambda g: jsession.device_page_plan(specs, blocks, ps, P, g))
    return _JAX_PLANS[key]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_page_plan_matches_jax(seed):
    specs, blocks, ps, P, bt, k_pool, pos_pool, pos, active = _plan_states(
        seed)
    j_specs = tuple(jsession.SessionSpec(**s._asdict()) for s in specs)

    def t_state():
        cache = {"self": tattn.PagedKVCache(
            torch.from_numpy(k_pool.copy()), torch.from_numpy(k_pool.copy()),
            torch.from_numpy(pos_pool.copy()), torch.from_numpy(bt[None].copy()))}
        g = tsession.grouped_init_state(specs, cache)
        groups = tuple(gs._replace(pos=torch.from_numpy(p.astype(np.int32)),
                                   active=torch.from_numpy(a))
                       for gs, p, a in zip(g.groups, pos, active))
        return tsession.GroupedState(groups=groups, cache=cache)

    def j_state():
        cache = {"self": jattn.PagedKVCache(
            jnp.asarray(k_pool), jnp.asarray(k_pool), jnp.asarray(pos_pool),
            jnp.asarray(bt[None]))}
        g = jsession.grouped_init_state(j_specs, cache)
        groups = tuple(gs._replace(pos=jnp.asarray(p, jnp.int32),
                                   active=jnp.asarray(a))
                       for gs, p, a in zip(g.groups, pos, active))
        return jsession.GroupedState(groups=groups, cache=cache)

    gt, gj = t_state(), j_state()
    pt = tsession.device_page_plan(specs, blocks, ps, P, gt)
    pj = _jax_plan(j_specs, blocks, ps, P)(gj)
    for f in ("exhausted", "n_free", "need_by_group", "rows", "blocks",
              "need", "copy", "cur"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                      np.asarray(getattr(pj, f)), err_msg=f)
    need = pt.need.numpy()
    np.testing.assert_array_equal(pt.new.numpy()[need],
                                  np.asarray(pj.new)[need])
    assert int(tsession.device_free_pages(gt.cache, P)) == int(
        jsession.device_free_pages(gj.cache, P))
    if bool(pt.exhausted):
        return
    ct = tsession.apply_page_plan(gt.cache, pt)["self"]
    cj = jsession.apply_page_plan(gj.cache, pj)["self"]
    np.testing.assert_array_equal(ct.block_tables.numpy(),
                                  np.asarray(cj.block_tables))
    # pool contents agree on every page but the trash page
    np.testing.assert_array_equal(ct.pos.numpy()[:, 1:],
                                  np.asarray(cj.pos)[:, 1:])
    np.testing.assert_array_equal(ct.k_pool.numpy()[:, 1:],
                                  np.asarray(cj.k_pool)[:, 1:])


def _window_refs(alloc, state, spec):
    """(live-row window pages, their refcounts across ALL rows)."""
    bt = state.cache["self"].block_tables[0].numpy()
    refs = np.bincount(bt[bt >= 0].ravel(), minlength=alloc.n_pages)
    out = []
    for s in np.flatnonzero(state.active.numpy()):
        for d in range(spec.n_drafts):
            r = s * spec.n_drafts + d
            for j in alloc.window_blocks(int(state.pos[s, 0])):
                out.append((int(bt[r, j]), int(refs[bt[r, j]])
                            if bt[r, j] >= 0 else 0))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_allocator_invariants(seed):
    """The host walk against random admit / step / release traces (the
    counterpart of the JAX package's property test): every live
    write-window page is mapped and privately owned, exhaustion raises
    ``PoolExhausted``, and releasing everything returns the whole pool."""
    rng = np.random.default_rng(seed)
    N_d, DL = int(rng.integers(1, 4)), 3
    spec = tsession.SessionSpec(n_slots=3, n_beams=1, n_drafts=N_d,
                                draft_len=DL, max_new=12, eos_id=1)
    ps = int(rng.choice([2, 4, 8]))
    n_blocks = -(-spec.cache_len // ps)
    n_pages = 1 + spec.rows_per_slot * n_blocks + int(rng.integers(0, 12))
    cfg = tiny_config(32, depth=1, d_model=16)
    pc = tattn.init_paged_kv_cache(cfg, spec.n_rows, spec.cache_len,
                                   n_pages=n_pages, page_size=ps,
                                   device="cpu")
    pc = tattn.PagedKVCache(*(getattr(pc, f)[None] for f in
                              ("k_pool", "v_pool", "pos", "block_tables")))
    state = tsession.init_state(spec, {"self": pc})
    alloc = tsession.PageAllocator(spec, n_pages=n_pages, page_size=ps)
    resident: set[int] = set()
    drafts = torch.zeros((N_d, DL), dtype=torch.int32)
    dmask = torch.ones((N_d,), dtype=torch.bool)
    for _ in range(25):
        op = rng.choice(["admit", "step", "release"])
        if op == "admit" and len(resident) < spec.n_slots:
            slot = int(rng.choice(sorted(set(range(spec.n_slots)) - resident)))
            state = tsession.unmap_slot_pages(spec, state, slot)
            state = tsession.reset_slot(spec, state, slot, 2, 0, drafts,
                                        dmask)
            resident.add(slot)
        elif op == "step" and resident:
            try:
                state = alloc.prepare_step(state)
            except tsession.PoolExhausted:
                alloc.reclaim(state)
                alloc.check()
                continue
            alloc.check()
            for page, nref in _window_refs(alloc, state, spec):
                assert page >= 1, "write-window block left unmapped"
                assert nref == 1, "write-window page shared between rows"
            adv = rng.integers(0, DL + 2, size=(spec.n_slots, 1))
            state = state._replace(pos=torch.from_numpy(np.minimum(
                state.pos.numpy() + adv, spec.max_new).astype(np.int32)))
            if N_d > 1:
                best = torch.from_numpy(rng.integers(0, N_d, spec.n_slots))
                state = state._replace(
                    cache=ttb.sync_winner(state.cache, best, N_d))
        elif op == "release" and resident:
            slot = int(rng.choice(sorted(resident)))
            state = tsession.release_slot(state, slot)
            state = tsession.unmap_slot_pages(spec, state, slot)
            resident.discard(slot)
            alloc.reclaim(state)
            alloc.check()
    for slot in sorted(resident):
        state = tsession.release_slot(state, slot)
        state = tsession.unmap_slot_pages(spec, state, slot)
    alloc.reclaim(state)
    alloc.check()
    assert alloc.free_pages == n_pages - 1, "pages leaked after full release"
    assert alloc.can_admit(state), "an empty pool must admit"


def test_reset_slots_equals_reset_slot_per_slot():
    """``reset_slots`` over several slots (one copy, one write a field)
    leaves every field of every slot as ``reset_slot`` slot by slot does,
    from the same garbage, with and without the generation params."""
    spec = tsession.SessionSpec(n_slots=5, n_beams=2, n_drafts=3,
                                draft_len=2, max_new=7, eos_id=1, pad_id=0,
                                kind="beam", n_stop=2)
    rng = np.random.default_rng(0)
    base = tsession.init_state(spec, None, device="cpu")
    base = base._replace(**{
        f: torch.from_numpy(rng.integers(0, 9, tuple(getattr(base, f).shape))
                            .astype(getattr(base, f).numpy().dtype))
        for f in tsession.SessionState._fields if f != "cache"})
    slots = [3, 0, 4]
    n = len(slots)
    last, pos = rng.integers(0, 30, n), rng.integers(0, 5, n)
    drafts = rng.integers(0, 30, (n, 3, 2))
    dmask = rng.random((n, 3)) < 0.5
    gen = dict(max_out=rng.integers(1, 8, n), stop_ids=rng.integers(
        -1, 30, (n, 2)), eff_dl=rng.integers(0, 3, n),
        eff_beams=rng.integers(1, 3, n))
    for kw in (gen, {}):
        def copy():
            return base._replace(**{f: getattr(base, f).clone()
                                    for f in base._fields if f != "cache"})

        a, b = copy(), copy()
        tsession.reset_slots(spec, a, slots, last, pos, drafts, dmask, **kw)
        for j, slot in enumerate(slots):
            tsession.reset_slot(spec, b, slot, int(last[j]), int(pos[j]),
                                torch.from_numpy(drafts[j]), dmask[j],
                                **{k: v[j] for k, v in kw.items()})
        for f in tsession.SessionState._fields:
            if f != "cache":
                np.testing.assert_array_equal(getattr(a, f).numpy(),
                                              getattr(b, f).numpy(),
                                              err_msg=f)
        # the other slots are untouched, the reset ones are fresh
        np.testing.assert_array_equal(a.tokens[[1, 2]].numpy(),
                                      base.tokens[[1, 2]].numpy())
        assert bool(a.active[slots].all()) and int(a.n_out[slots].sum()) == 0


# ---------------------------------------------------------------------------
# the slice end to end


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("mode,kw", MODES, ids=[m for m, _ in MODES])
def test_streaming_matches_jax_all_modes(toy, mode, kw, paged):
    """Tokens, lengths, n_calls and accepted counts identical to the JAX
    engine, beam log-probs within 1e-5, through ``predict`` /
    ``predict_topn`` (the counterparts of ``test_session.py``'s engine
    identity and paged == dense tests)."""
    extra = dict(paged=True, page_size=8) if paged else {}
    je, te = toy["engines"](mode=mode, n_slots=2, **kw, **extra)
    if mode in ("greedy", "speculative"):
        qs = _queries(toy, 4)
        for pt_, pj_ in zip(te.predict(qs), je.predict(qs)):
            assert pt_.smiles == pj_.smiles and pt_.n_calls == pj_.n_calls
            assert pt_.acceptance_rate == pytest.approx(pj_.acceptance_rate)
    else:
        for q in _queries(toy, 2):
            pt_, pj_ = te.predict_topn(q), je.predict_topn(q)
            assert pt_.smiles == pj_.smiles and pt_.n_calls == pj_.n_calls
            np.testing.assert_allclose(pt_.logprobs, pj_.logprobs, atol=1e-5,
                                       rtol=1e-5)
    if paged:
        te.allocator.check()
        fp = te.cache_footprint()
        assert 0 < fp["peak_bytes"] <= fp["capacity_bytes"]


def test_mid_stream_admission_is_isolated(toy):
    """A request admitted into a recycled slot next to strangers gives the
    tokens it gives alone, and both equal the JAX engine's."""
    qs = _queries(toy, 6)
    je, te = toy["engines"](**SPEC_PAGED)
    jobs = [(q, {}) for q in qs[:-1]] + [(qs[-1], dict(arrival=7.0))]
    pairs = _serve_both(je, te, jobs)
    for rt, rj in pairs:
        _assert_results_equal(rt, rj)
    alone = te.submit(qs[-1]).result()
    np.testing.assert_array_equal(pairs[-1][0].tokens, alone.tokens)


def test_more_requests_than_slots(toy):
    """Seven requests through two greedy slots: all complete, slots recycle,
    tokens equal the JAX engine's."""
    je, te = toy["engines"](mode="greedy", n_slots=2)
    pairs = _serve_both(je, te, [(q, {}) for q in _queries(toy, 7)])
    assert len(pairs) == 7
    for rt, rj in pairs:
        _assert_results_equal(rt, rj)
    assert te.scheduler.max_resident == 2


# ---------------------------------------------------------------------------
# batched admission: a pass's admissions written by one flush


def _spy_encoder(te):
    """Record the batch size of every encoder pass ``te`` makes."""
    sizes = []
    encode = te.backend.encode_kv

    def spy(params, srcs):
        sizes.append(int(srcs.shape[0]))
        return encode(params, srcs)

    te.backend.encode_kv = spy
    return sizes


@pytest.mark.parametrize("arrivals", ["together", "staggered"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("mode,kw", MODES[1::2],
                         ids=[m for m, _ in MODES[1::2]])
def test_batched_admission_matches_jax(toy, mode, kw, paged, arrivals):
    """Six queries into an 8-slot engine, all at once (one flush: one
    encoder pass of six sources, one scatter, one ``reset_slots``) or one
    an iteration (six flushes of one): tokens, lengths, n_calls and
    accepted counts identical to the JAX engine, which admits one at a
    time; beam log-probs within 1e-5."""
    extra = dict(paged=True, page_size=8) if paged else {}
    je, te = toy["engines"](mode=mode, n_slots=8, **kw, **extra)
    sizes = _spy_encoder(te)
    staggered = arrivals == "staggered"
    jobs = [(q, dict(arrival=float(i) if staggered else 0.0))
            for i, q in enumerate(_queries(toy, 6))]
    for rt, rj in _serve_both(je, te, jobs):
        _assert_results_equal(rt, rj)
    st = te.loop_stats()
    if staggered:
        assert st["admit_batches"] == st["admit_batch_queries"] == 6
        assert sizes == [1] * 6
    else:
        assert (st["admit_batches"], st["admit_batch_queries"]) == (1, 6)
        assert sizes == [6]
    if paged:
        te.allocator.check()


@pytest.mark.parametrize("entries", [8, 1])
def test_batched_admission_encodes_a_repeat_once(toy, entries):
    """With the encoder-output LRU, five queries of three sources in one
    flush: each distinct source missing the LRU is encoded once, in one
    pass, and the LRU's counters equal those of the JAX engine's
    admissions one at a time, also where a one-entry LRU evicts a source
    that then misses again; the tokens equal the JAX engine's."""
    je, te = toy["engines"](**dict(SPEC_PAGED, n_slots=8), prefix_cache=True,
                            prefix_cache_entries=entries)
    sizes = _spy_encoder(te)
    qs = _queries(toy, 3)
    jobs = [(qs[i], {}) for i in (0, 1, 0, 2, 1)]
    for rt, rj in _serve_both(je, te, jobs):
        _assert_results_equal(rt, rj)
    assert sizes == [3]
    assert te.prefix_stats() == je.prefix_stats()
    assert (te.prefix_stats()["hit_tokens"] > 0) == (entries > 1)
    # a later flush reads the entries this one left
    [(rt, rj)] = _serve_both(je, te, [(qs[2], {})])
    _assert_results_equal(rt, rj)
    assert sizes == [3] + ([] if entries > 1 else [1])
    assert te.prefix_stats() == je.prefix_stats()


@pytest.mark.parametrize("how", ["cancel", "preempt"])
def test_release_before_the_flush_leaves_the_slot_clean(toy, how):
    """A request admitted and then cancelled or preempted in the same
    pass, before the flush: nothing of it is written (its slot stays
    inactive), and every request served, the next tenant of its slot and
    (preempted) the request itself on its return, gives the JAX engine's
    tokens."""
    qs = _queries(toy, 3)
    je, te = toy["engines"](**SPEC_PAGED)
    hj = [je.submit(q) for q in qs]
    ref = je.serve()
    hs = [te.submit(q) for q in qs]
    flush, seen = te.scheduler._admit_flush, {}

    def release_first(state):
        if not seen:
            slot = next(s for s, r in te.scheduler._resident.items()
                        if r.rid == int(hs[1]))
            seen["slot"] = slot
            if how == "cancel":
                assert hs[1].cancel()
            else:
                te.scheduler._preempt_youngest()
            assert slot not in te.scheduler._resident
            state = flush(state)
            seen["active"] = bool(state.groups[0].active[slot])
            seen["batch"] = te.loop_stats()["admit_batch_queries"]
            return state
        return flush(state)

    te.scheduler._admit_flush = release_first
    res = te.serve()
    assert seen["active"] is False and seen["batch"] == 1
    served = [0, 1, 2] if how == "preempt" else [0, 2]
    for i in served:
        _assert_results_equal(res[int(hs[i])], ref[int(hj[i])])
    if how == "cancel":
        assert hs[1].status == "cancelled"
    else:
        assert te.scheduler.n_preemptions == 1
    te.allocator.reclaim(te.scheduler.state)
    te.allocator.check()
    assert te.allocator.used_pages == 0


def _jax_single_mode_results(toy, jobs):
    """{job index: JAX SlotResult} from the single-mode engines of the mode
    tests (a request's tokens do not depend on its neighbours or on the
    slot count: the session's rows are independent)."""
    configs = {"greedy": dict(mode="greedy", n_slots=2),
               "speculative": dict(mode="speculative", n_slots=2,
                                   draft_len=4, n_drafts=6),
               "beam": dict(mode="beam", n_slots=2, n_beams=3)}
    out = {}
    for mode, cfg in configs.items():
        idx = [i for i, (_, kw) in enumerate(jobs)
               if kw.get("mode", "speculative") == mode]
        if not idx:
            continue
        je, _ = toy["engines"](**cfg)
        handles = [je.submit(jobs[i][0]) for i in idx]
        res = je.serve()
        out.update({i: res[int(h)] for i, h in zip(idx, handles)})
    return out


def test_pool_exhaustion_preempts_and_replays(toy):
    """A pool of ~1.2 slots' worst case under a 4-slot speculative session:
    the device plan runs dry, the exhausted step applies nothing, the host
    preempts and replays. Every request still gives the JAX engine's
    tokens, and the page accounting balances."""
    te = toy["port"](mode="speculative", draft_len=4, n_drafts=6, n_slots=4,
                     paged=True, page_size=8, n_pages=1 + 6 * 4 + 4)
    jobs = [(q, {}) for q in _queries(toy, 8)]
    ref = _jax_single_mode_results(toy, jobs)
    handles = [te.submit(q) for q, _ in jobs]
    res = te.serve()
    for i, h in enumerate(handles):
        _assert_results_equal(res[int(h)], ref[i])
    assert te.scheduler.n_preemptions > 0
    te.allocator.check()
    te.allocator.reclaim(te.scheduler.state)
    assert te.allocator.used_pages == 0


def test_mixed_mode_groups_on_a_tight_shared_pool(toy):
    """One session serving greedy, speculative and beam groups over one
    paged pool far below their combined worst case (the counterpart of
    ``test_mixed_mode.py``'s identity and shared-pool exhaustion tests):
    admissions defer, residents are preempted, and every request equals
    the JAX single-mode engine's, with its mode tag."""
    te = toy["port"](draft_len=4, n_drafts=6, n_beams=3,
                     mode_groups={"greedy": 2, "speculative": 2, "beam": 1},
                     paged=True, page_size=8, n_pages=1 + 24 + 4)
    mix = ("greedy", "speculative", "beam")
    jobs = [(q, dict(mode=mix[i % 3])) for i, q in enumerate(_queries(toy, 9))]
    ref = _jax_single_mode_results(toy, jobs)
    handles = [te.submit(q, **kw) for q, kw in jobs]
    res = te.serve()
    for i, (h, (_, kw)) in enumerate(zip(handles, jobs)):
        _assert_results_equal(res[int(h)], ref[i])
        assert res[int(h)].mode == kw["mode"]
    assert te.scheduler.n_preemptions > 0
    te.allocator.check()


def test_per_request_params_match_jax(toy):
    """Ragged per-request params under the group's ceilings: token budget,
    draft window, beam width and stop ids, against the JAX engine."""
    qs = _queries(toy, 3)
    je, te = toy["engines"](mode="speculative_beam", n_slots=2, n_beams=3,
                            draft_len=4, n_drafts=6, paged=True, page_size=8)
    stop = int(te.submit(qs[0]).result().tokens[0][3])
    te.reset()
    params = [dict(max_new=9), dict(draft_len=2, n_drafts=3, n_beams=2),
              dict(stop_ids=(stop,))]
    jobs_t = [(q, dict(params=GenerationParams(**p)))
              for q, p in zip(qs, params)]
    hj = [je.submit(q, params=JaxGenerationParams(**p))
          for q, p in zip(qs, params)]
    ht = [te.submit(q, **kw) for q, kw in jobs_t]
    rj, rt = je.serve(), te.serve()
    for a, b in zip(ht, hj):
        _assert_results_equal(rt[int(a)], rj[int(b)])
    assert rt[int(ht[0])].tokens.shape[1] == 9
    assert rt[int(ht[1])].tokens.shape[0] == 2


@pytest.mark.parametrize("mode", ["greedy", "speculative"])
def test_stream_deltas_equal_result(toy, mode):
    te = toy["port"](**dict(SPEC_PAGED, mode=mode))
    hs = [te.submit(q) for q in _queries(toy, 4)]
    deltas = list(hs[0].stream())        # consumed while others decode
    r0 = hs[0].result()
    np.testing.assert_array_equal(np.concatenate(deltas),
                                  r0.tokens[0][:int(r0.lengths[0])])
    assert 1 <= len(deltas) <= int(r0.lengths[0])
    if mode == "greedy":
        assert len(deltas) > 1           # delivered mid-flight
    res = te.serve()
    assert all(int(h) in res for h in hs[1:])


def test_cancel_frees_the_slot_and_its_pages(toy):
    """A resident request cancelled mid-flight is evicted with its pages
    reclaimed; the co-residents' tokens equal an unperturbed JAX run."""
    qs = _queries(toy, 4)
    je, te = toy["engines"](**SPEC_PAGED)
    hj = [je.submit(q) for q in qs]
    ref = je.serve()
    hs = [te.submit(q) for q in qs]
    pump = te.serve_steps()
    next(pump)
    next(pump)
    running = [h for h in hs if h.status == "running"]
    victim = running[0]
    assert victim.cancel() and victim.status == "cancelled"
    assert not victim.cancel()
    res = te.serve()
    with pytest.raises(RequestCancelled):
        victim.result()
    for h, r in zip(hs, hj):
        if h is not victim:
            np.testing.assert_array_equal(res[int(h)].tokens,
                                          ref[int(r)].tokens)
    te.allocator.reclaim(te.scheduler.state)
    te.allocator.check()
    assert te.allocator.used_pages == 0


def test_refusals_name_the_roadmap_item(toy, tmp_path):
    """What the port does not serve yet is refused at construction, naming
    the queue item that will port it; a front door over a mesh engine
    (item 9c) is ported and builds, here on a one-rank world. A mesh that
    is not a
    ('data', 'model') DeviceMesh is a
    TypeError. Item 5's prefix cache and overload policy are ported and
    build, and so do the decoder-only patterns, cross-attention among them
    since item 6.4 is ported, and on a mesh since item 9b is (a one-rank
    world here); the paged cache adds no parameter."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import MeshShape, make_serving_mesh
    from repro_torch.models import transformer as ttr
    from repro_torch.serving import FrontDoorServer

    cfg_t, pt, tok = toy["cfg_t"], toy["pt"], toy["tok"]
    with pytest.raises(TypeError, match="DeviceMesh"):
        StreamingEngine(pt, cfg_t, tok, EngineConfig(mesh=object()),
                        device="cpu")
    for kw in (dict(prefix_cache=True), dict(overload=OverloadPolicy())):
        StreamingEngine(pt, cfg_t, tok, EngineConfig(**kw), device="cpu")
    decoder = dataclasses.replace(cfg_t, family="dense",
                                  layer_pattern=("xattn",), pos="rope")
    with pytest.raises(TypeError, match="DeviceMesh"):
        StreamingEngine({}, decoder, tok, EngineConfig(
            mesh=MeshShape(("data", "model"), (2, 2))), device="cpu")
    assert make_backend(decoder, EngineConfig()).cfg is decoder
    dparams = ttr.init(torch.Generator().manual_seed(0), decoder,
                       device="cpu")
    StreamingEngine(dparams, decoder, tok, EngineConfig(), device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        meng = StreamingEngine(dparams, decoder, tok, EngineConfig(
            mesh=make_serving_mesh((1, 1))), device="cpu")
        srv = FrontDoorServer(meng)
        assert srv.port is None and srv.error is None
    finally:
        dist.destroy_process_group()
    eng = StreamingEngine(pt, cfg_t, tok, EngineConfig(paged=True),
                          device="cpu")
    assert (len(jax.tree_util.tree_leaves(eng.params))
            == len(jax.tree_util.tree_leaves(pt)))
