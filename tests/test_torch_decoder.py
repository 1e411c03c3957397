"""The port's decoder-only language model and its serving path against the
JAX package's, on the four dense architectures' ``reduced()`` configs
(SmolLM: GQA, tied embeddings; Qwen3: qk-norm; StarCoder2: LayerNorm with
bias, GELU, biases everywhere; Command-R: bias-free LayerNorm, SwiGLU),
with the JAX params carried across by ``repro_torch.bridge``.

- the model: ``prefill`` (ragged ``lengths``, ``logits_mode`` "all" and
  "last") and multi-token ``decode_step`` logits within 1e-4 of JAX's, also
  with a sliding window of 8;
- the slice end to end: ``StreamingEngine(params, cfg, None,
  EngineConfig(eos_id=...))`` tokens (and beam log-probs within 1e-5)
  identical to the JAX engine's in greedy, speculative, beam and SBS, dense
  and paged, with ragged prompts (a one-token prompt among them),
  staggered arrivals and ``prefill_chunk`` 5; streaming equals the port's
  one-shot prefill + decode; the chunk size is invisible; pool exhaustion
  preempts a mid-prefill slot and replays identical tokens; the minimum
  pool admits and completes;
- routing: ``make_backend`` keys off the family; a cross-attention
  pattern builds, serves and runs ``apply``; the sliding-window paged
  engine is refused by name; the param bridge round-trips every arch's
  tree, MoE, recurrent, VLM and audio ones too; the registry equals the
  JAX package's twelve archs.

The JAX engines are built once per module; the port runs on the CPU
(``device="cpu"``) with one torch thread.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import prompt_lookup_drafts as jax_prompt_lookup  # noqa: E402
from repro.core.session import device_page_plan as jax_page_plan  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import StreamingEngine as JaxStreamingEngine  # noqa: E402
from repro_torch.bridge import (transformer_params_from_jax,  # noqa: E402
                                transformer_params_to_jax)
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.mt import tiny_config  # noqa: E402
from repro_torch.core import (greedy_decode, prompt_lookup_drafts,  # noqa: E402
                              speculative_greedy_decode, transformer_handle)
from repro_torch.core import session as tsession  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serving import (DecoderOnlyBackend, EngineConfig,  # noqa: E402
                                 Seq2SeqBackend, StreamingEngine,
                                 make_backend)

ARCHS = ["smollm-135m", "qwen3-8b", "starcoder2-15b", "command-r-35b"]
MAX_NEW = 12
MAX_SRC = 28
DL, ND = 4, 5
EOS = 2
MODES = ("greedy", "speculative", "beam", "speculative_beam")
# every mode in one engine (one JAX compile per engine): the groups share
# the cache, the pool and the step, as mixed traffic does
GROUPS = {"greedy": 2, "speculative": 2, "beam": 1, "speculative_beam": 1}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced models' ops are far too small to share out between
    threads, and under pytest-xdist every worker's pool would contend for
    the same cores; one thread, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX cfg, JAX params, port cfg, port params), built once."""
    out = {}

    def get(arch, window=0):
        key = (arch, window)
        if key not in out:
            jcfg = jax_get_config(arch, reduced=True)
            cfg = get_config(arch, reduced=True)
            if window:
                jcfg = dataclasses.replace(jcfg, sliding_window=window)
                cfg = dataclasses.replace(cfg, sliding_window=window)
            jp = jtr.init(jax.random.PRNGKey(0), jcfg)
            pt = transformer_params_from_jax(jax.tree.map(np.asarray, jp),
                                             device="cpu")
            out[key] = (jcfg, jp, cfg, pt)
        return out[key]

    return get


@pytest.fixture(scope="module")
def prompts():
    """``tests/test_backend.py``'s prompt set: ragged lengths with a
    one-token prompt (no prefill chunk) and a partial last chunk."""
    rng = np.random.default_rng(0)
    return [rng.integers(4, 500, size=L).astype(np.int32)
            for L in (9, 17, 24, 1, 21, 5)]


def _ecfg_kw(**kw):
    base = dict(draft_len=DL, n_drafts=ND, n_beams=3, max_new=MAX_NEW,
                max_src=MAX_SRC, n_slots=2, prefill_chunk=5, eos_id=EOS)
    base.update(kw)
    return base


def _engine(cfg, pt, **kw):
    return StreamingEngine(pt, cfg, None, EngineConfig(**_ecfg_kw(**kw)),
                           device="cpu")


# ---------------------------------------------------------------------------
# the model


# the MoE and recurrent archs the port also serves (tests/test_torch_moe.py,
# tests/test_torch_recurrent.py), the VLM and the audio encoder
# (tests/test_torch_vlm.py, tests/test_torch_apply.py)
MORE_ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b",
              "jamba-v0.1-52b", "rwkv6-1.6b", "llama-3.2-vision-11b",
              "hubert-xlarge"]
MT_ARCHS = ["mt-product", "mt-retro"]


def test_config_registry_matches_jax():
    from repro.configs import list_archs as jax_list_archs

    assert list_archs() == sorted(ARCHS + MORE_ARCHS + MT_ARCHS)
    assert list_archs() == jax_list_archs()
    for arch in ARCHS + MORE_ARCHS + MT_ARCHS:
        for reduced in (False, True):
            a = jax_get_config(arch, reduced=reduced)
            b = get_config(arch, reduced=reduced)
            for f in dataclasses.fields(b):
                x, y = getattr(b, f.name), getattr(a, f.name)
                if dataclasses.is_dataclass(x):   # the MoE / Mamba / RWKV
                    x, y = dataclasses.asdict(x), dataclasses.asdict(y)
                assert x == y, (arch, f)
            assert b.n_repeats == a.n_repeats


@pytest.mark.parametrize("arch", ARCHS + MORE_ARCHS)
def test_bridge_round_trip(models, arch):
    _, jp, _, pt = models(arch)
    back = transformer_params_to_jax(pt)
    flat_a = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,window", [(a, 0) for a in ARCHS]
                         + [("smollm-135m", 8)])
def test_prefill_and_decode_logits_match_jax(models, arch, window):
    """Ragged prefill, then multi-token decode steps (as verification
    feeds them): logits within 1e-4 at every valid position. Padded
    prefill positions are pads (their query sees no key: the port's read
    gives 0, JAX's einsum the mean of V) and are not compared."""
    jcfg, jp, cfg, pt = models(arch, window)
    rng = np.random.default_rng(3)
    T = 7 if window else 10
    toks = rng.integers(4, cfg.vocab_size, (2, T + 6)).astype(np.int32)
    lengths = np.array([T, T - 3], np.int32)
    jc = jtr.init_cache(jcfg, 2, 32)
    tc = tr.init_cache(cfg, 2, 32, device="cpu")
    if window:
        assert tc[0].k.shape[2] == window       # (R, B, S = window, ...)
    jl, jc = jtr.prefill(jp, jcfg, jc, jnp.asarray(toks[:, :T]),
                         lengths=jnp.asarray(lengths))
    tl, tc = tr.prefill(pt, cfg, tc, torch.from_numpy(toks[:, :T]),
                        lengths=torch.from_numpy(lengths))
    for b in range(2):
        np.testing.assert_allclose(tl[b, :lengths[b]].numpy(),
                                   np.asarray(jl[b, :lengths[b]]),
                                   rtol=1e-4, atol=1e-4)
    for start in range(0, 6, 3):
        chunk = toks[:, T + start:T + start + 3]
        pos = (lengths[:, None] + start + np.arange(3)[None]).astype(np.int32)
        jl, jc = jtr.decode_step(jp, jcfg, jc, jnp.asarray(chunk),
                                 jnp.asarray(pos))
        tl, tc = tr.decode_step(pt, cfg, tc, torch.from_numpy(chunk),
                                torch.from_numpy(pos))
        tc = tr.commit_cache(cfg, tc, torch.full((2,), 3))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_last_logits_match_jax(models, arch):
    jcfg, jp, cfg, pt = models(arch)
    toks = np.random.default_rng(4).integers(
        4, cfg.vocab_size, (3, 9)).astype(np.int32)
    lengths = np.array([9, 1, 5], np.int32)
    jl, _ = jtr.prefill(jp, jcfg, jtr.init_cache(jcfg, 3, 16),
                        jnp.asarray(toks), lengths=jnp.asarray(lengths),
                        logits_mode="last")
    tl, _ = tr.prefill(pt, cfg, tr.init_cache(cfg, 3, 16, device="cpu"),
                       torch.from_numpy(toks),
                       lengths=torch.from_numpy(lengths), logits_mode="last")
    assert tl.shape == (3, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


def test_prompt_lookup_drafts_match_jax(prompts):
    for p in prompts:
        for dl, nd in ((DL, ND), (1, 3), (30, 2)):
            a = prompt_lookup_drafts(p, dl, nd, dilations=(1, 2))
            b = jax_prompt_lookup(p, dl, nd, dilations=(1, 2))
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_device_page_plan_prefill_lanes_match_jax(models):
    """The plan's frontier growth for prompt chunks: with two mid-prefill
    slots (one lane idle, one chunk straddling a page boundary, one
    already-mapped block) beside a decoding slot, the port's lanes and the
    JAX plan's agree."""
    jcfg, jp, cfg, pt = models("smollm-135m")
    ps, C = 4, 5
    eng = _engine(cfg, pt, mode="speculative", n_slots=3, paged=True,
                  page_size=ps, prefill_chunk=C)
    gs = eng.scheduler.state
    spec = eng.spec
    n_pages, _ = eng._paged_geometry()
    bt = gs.cache[0].block_tables
    bt[:, 0, :2] = torch.tensor([3, 4], dtype=torch.int32)   # slot 0 row 0
    tsession.reset_slot(spec, gs.groups[0], 2, 7, 6, np.zeros((ND, DL)),
                        np.ones(ND, bool))
    bt[:, 2 * ND, :2] = torch.tensor([5, 6], dtype=torch.int32)
    blocks = (eng.allocator._blocks["speculative"],)
    pos0 = torch.tensor([4, 0, 0], dtype=torch.int32)
    nval = torch.tensor([5, 0, 0], dtype=torch.int32)
    rows0 = eng._chunk_rows0("speculative")
    tp = tsession.device_page_plan((spec,), blocks, ps, n_pages, gs,
                                   prefill=((rows0, pos0, nval, C),))
    from repro.core import session as jsession
    from repro.models.attention import PagedKVCache
    g, c = gs.groups[0], gs.cache[0]
    jg = jsession.SessionState(**{
        f: None if f == "cache" else jnp.asarray(getattr(g, f).numpy())
        for f in g._fields})
    jcache = (PagedKVCache(*(jnp.asarray(getattr(c, f).numpy()) for f in
                             ("k_pool", "v_pool", "pos", "block_tables"))),)
    jp_ = jax_page_plan((spec,), blocks, ps, n_pages,
                        jsession.GroupedState(groups=(jg,), cache=jcache),
                        prefill=((rows0, jnp.asarray(pos0.numpy()),
                                  jnp.asarray(nval.numpy()), C),))
    for f in ("exhausted", "n_free", "need_by_group", "rows", "blocks",
              "need", "copy", "cur", "new"):
        a, b = getattr(tp, f).numpy(), np.asarray(getattr(jp_, f))
        need = tp.need.numpy()
        if f == "new":
            a, b = a[need], b[need]
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_page_allocator_chunked_prefill_accounting_matches_jax(models):
    """``prefill_blocks`` sizing (one slot's worst case, an admission's
    pages), ``map_prefill`` (fresh pages for unmapped blocks of one row,
    mapped blocks skipped, exhaustion naming the group) and pinned rows
    (live in every scan while the slot is inactive), against the JAX
    allocator on the same trace."""
    from repro.core import session as jsession

    jcfg, _, cfg, _ = models("smollm-135m")
    spec = tsession.SessionSpec(n_slots=2, n_beams=1, n_drafts=3,
                                draft_len=2, max_new=6, eos_id=EOS)
    P, ps, row_len = 20, 4, 20
    kw = dict(n_pages=P, page_size=ps, row_lens={None: row_len},
              prefill_blocks={None: 3})
    ta = tsession.PageAllocator(spec, **kw)
    jspec = jsession.SessionSpec(*spec)
    ja = jsession.PageAllocator(jspec, **kw)
    assert ta._slot_worst == ja._slot_worst
    assert ta.admit_pages_for() == ja.admit_pages_for()
    ts = tsession.init_state(spec, tr.init_cache(
        cfg, spec.n_rows, row_len, paged=(P, ps), device="cpu"))
    js = jsession.init_state(jspec, jtr.init_cache(jcfg, spec.n_rows,
                                                   row_len, paged=(P, ps)))
    for row, blocks in ((0, range(3)), (0, (2, 3)), (3, range(2))):
        ta.map_prefill(ts, row, blocks)
        js = ja.map_prefill(js, row, blocks)
    np.testing.assert_array_equal(ts.cache[0].block_tables.numpy(),
                                  np.asarray(js.cache[0].block_tables))
    mapped = ts.cache[0].block_tables[0, 0, :4].long()
    assert (ts.cache[0].pos[:, mapped] == -1).all()
    ta.pin_rows(range(3))                  # slot 0 mid-prefill: kept
    ta.reclaim(ts)
    assert ta.used_pages == 4
    ta.unpin_rows(range(3))                # released: both rows' pages go
    ta.reclaim(ts)
    assert ta.used_pages == 0
    ta.check()
    with pytest.raises(tsession.PoolExhausted) as e:
        for row in range(spec.n_rows):     # 6 rows x 5 blocks > 19 pages
            ta.map_prefill(ts, row, range(5), group="greedy")
    assert e.value.group == "greedy"


def test_prompt_chunks_and_body(models):
    """The prompt minus its last token in fixed-shape chunks at absolute
    positions; ``m0`` starts the plan at a matched prefix."""
    _, _, cfg, _ = models("smollm-135m")
    be = DecoderOnlyBackend(cfg, EngineConfig(prefill_chunk=4, max_src=16,
                                              eos_id=EOS))
    prompt = np.arange(10, 21, dtype=np.int32)
    spec = tsession.SessionSpec(n_slots=1, n_beams=1, n_drafts=2,
                                draft_len=3, max_new=4, eos_id=EOS)
    req = be.make_request(prompt, spec)
    np.testing.assert_array_equal(be.prompt_body(req), prompt[:-1])
    assert req.args[:2] == (20, 10)
    assert [(c0, n) for _, c0, n in req.chunks] == [(0, 4), (4, 4), (8, 2)]
    np.testing.assert_array_equal(req.chunks[2][0], [18, 19, 0, 0])
    assert [(c0, n) for _, c0, n in be.suffix_chunks(prompt[:-1], 8)] == \
        [(8, 2)]
    assert be.make_request(prompt[:1], spec).chunks == []


# ---------------------------------------------------------------------------
# the slice end to end


@pytest.fixture(scope="module")
def mixed_runs(models, prompts):
    """(arch, paged) -> (JAX results, port results) of one mixed-group
    engine each, every prompt submitted to every mode, arrivals staggered
    so admissions and their chunks interleave with strangers' steps."""
    out = {}

    def get(arch, paged):
        if (arch, paged) not in out:
            jcfg, jp, cfg, pt = models(arch)
            kw = _ecfg_kw(mode_groups=GROUPS, paged=paged, page_size=8)
            je = JaxStreamingEngine(jp, jcfg, None, JaxEngineConfig(**kw))
            te = StreamingEngine(pt, cfg, None, EngineConfig(**kw),
                                 device="cpu")
            runs = []
            for eng in (je, te):
                rids = [(m, eng.submit(p, arrival=float(i), mode=m))
                        for i, p in enumerate(prompts) for m in MODES]
                res = eng.serve()
                runs.append([(m, res[int(r)]) for m, r in rids])
            if paged:
                te.allocator.check()
            out[arch, paged] = (runs, te)
        return out[arch, paged]

    return get


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_streaming_matches_jax_in_all_modes(mixed_runs, prompts, arch,
                                            paged):
    (want, got), te = mixed_runs(arch, paged)
    for (m, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(b.tokens, np.asarray(a.tokens),
                                      err_msg=m)
        np.testing.assert_array_equal(b.lengths, np.asarray(a.lengths))
        assert b.n_calls == a.n_calls and b.accepted == a.accepted, m
        if m in ("beam", "speculative_beam"):
            np.testing.assert_allclose(b.logprobs, np.asarray(a.logprobs),
                                       rtol=1e-5, atol=1e-5)
    assert te.prefill_chunks_written == len(MODES) * sum(
        -(-(len(p) - 1) // 5) for p in prompts)


def _one_shot(cfg, pt, prompt, mode):
    """The port's one-shot path: ``transformer.prefill`` of the prompt
    minus its last token into a 1-row cache, then the core decode."""
    handle = transformer_handle(pt, cfg)
    P = len(prompt)
    cache = tr.init_cache(cfg, 1, P + MAX_NEW + DL + 4, device="cpu")
    if P > 1:
        _, cache = tr.prefill(pt, cfg, cache,
                              torch.from_numpy(prompt[None, :-1]))
    last = torch.tensor([int(prompt[-1])], dtype=torch.int32)
    pos = torch.tensor([P - 1], dtype=torch.int32)
    if mode == "greedy":
        r = greedy_decode(handle, cache, last, pos, max_new=MAX_NEW,
                          eos_id=EOS)
    else:
        d, m = prompt_lookup_drafts(prompt, DL, ND)
        r = speculative_greedy_decode(
            handle, cache, last, pos, torch.from_numpy(d[None]),
            torch.from_numpy(m[None]), max_new=MAX_NEW, eos_id=EOS)
    return r.tokens[0].numpy()


@pytest.mark.parametrize("mode", ["greedy", "speculative"])
def test_streaming_matches_one_shot(models, mixed_runs, prompts, mode):
    """Chunked ragged prefill in recycled slots == one monolithic prefill."""
    _, cfg, pt = models("smollm-135m")[1:]
    (_, got), _ = mixed_runs("smollm-135m", True)
    streamed = [r for m, r in got if m == mode]
    for p, r in zip(prompts, streamed):
        np.testing.assert_array_equal(r.tokens[0],
                                      _one_shot(cfg, pt, p, mode))


def test_chunk_size_is_invisible(models, prompts):
    _, _, cfg, pt = models("smollm-135m")
    runs = []
    for chunk in (3, 5, 32):
        eng = _engine(cfg, pt, mode="speculative", prefill_chunk=chunk)
        rids = [eng.submit(p) for p in prompts]
        res = eng.serve()
        runs.append([res[int(r)].tokens for r in rids])
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            np.testing.assert_array_equal(a, b)


def test_paged_exhaustion_preempts_mid_prefill_and_replays(models, prompts):
    """A pool one page above one slot's worst case serving 3 slots: prompts
    and resident decodes fight over pages, a mid-prefill slot is preempted
    (its record dropped, its rows unpinned), and every request still ends
    token-identical to the dense run."""
    _, _, cfg, pt = models("smollm-135m")
    dense = _engine(cfg, pt, mode="speculative", n_slots=3)
    spec, ps = dense.spec, 8
    be = DecoderOnlyBackend(cfg, dense.ecfg, None)
    need = be.prefill_blocks(ps) + spec.rows_per_slot * (
        -(-spec.cache_len // ps) + 1)
    paged = _engine(cfg, pt, mode="speculative", n_slots=3, paged=True,
                    page_size=ps, n_pages=1 + need + 1)
    assert paged.n_slots > paged.cache_footprint()["contiguous_equiv_slots"]
    mid_prefill = []
    release = paged.scheduler._release

    def spy(state, slot):
        mid_prefill.append(slot in paged._prefilling)
        return release(state, slot)

    paged.scheduler._release = spy
    long_prompts = prompts + [p[::-1].copy() for p in prompts]
    rd = [dense.submit(p) for p in long_prompts]
    rp = [paged.submit(p) for p in long_prompts]
    res_d, res_p = dense.serve(), paged.serve()
    assert paged.scheduler.n_preemptions > 0
    assert any(mid_prefill), "no mid-prefill slot was preempted"
    for a, b in zip(rd, rp):
        np.testing.assert_array_equal(res_d[int(a)].tokens,
                                      res_p[int(b)].tokens)
    assert not paged.allocator._pinned_rows
    paged.allocator.check()


def test_minimum_pool_admits_and_completes(models, prompts):
    _, _, cfg, pt = models("smollm-135m")
    probe = _engine(cfg, pt, mode="greedy", paged=True, page_size=16)
    need = probe.allocator._slot_worst["greedy"]
    assert probe.allocator.admit_pages_for("greedy") <= need
    tight = _engine(cfg, pt, mode="greedy", paged=True, page_size=16,
                    n_pages=1 + need)
    dense = _engine(cfg, pt, mode="greedy")
    rt = [tight.submit(p) for p in prompts[:3]]
    rd = [dense.submit(p) for p in prompts[:3]]
    res_t, res_d = tight.serve(), dense.serve()
    for a, b in zip(rt, rd):
        np.testing.assert_array_equal(res_t[int(a)].tokens,
                                      res_d[int(b)].tokens)
    tight.allocator.check()


def test_prompt_length_bounds_and_eos_required(models):
    _, _, cfg, pt = models("smollm-135m")
    eng = _engine(cfg, pt, mode="greedy")
    with pytest.raises(ValueError):
        eng.submit(np.zeros((0,), np.int32))
    with pytest.raises(ValueError):
        eng.submit(np.arange(MAX_SRC + 1, dtype=np.int32) + 4)
    with pytest.raises(ValueError, match="eos_id"):
        StreamingEngine(pt, cfg, None, EngineConfig(), device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        EngineConfig(prefill_chunk=0)


# ---------------------------------------------------------------------------
# routing and refusals


def test_make_backend_routes_on_family():
    cfg = get_config("smollm-135m", reduced=True)
    assert isinstance(make_backend(cfg, EngineConfig()), DecoderOnlyBackend)
    assert isinstance(make_backend(cfg, EngineConfig(backend="decoder_only")),
                      DecoderOnlyBackend)
    from repro_torch.data import SyntheticReactionDataset
    tok = SyntheticReactionDataset(4, seed=0).tokenizer
    mt = tiny_config(tok.vocab_size, depth=1, d_model=32)
    assert isinstance(make_backend(mt, EngineConfig(), tok), Seq2SeqBackend)
    with pytest.raises(ValueError):
        DecoderOnlyBackend(mt, EngineConfig(), None)       # seq2seq family
    with pytest.raises(ValueError):
        Seq2SeqBackend(cfg, EngineConfig(), None)          # tokenizer needed
    with pytest.raises(ValueError, match="unknown backend"):
        make_backend(cfg, EngineConfig(backend="rnn"))


@pytest.mark.parametrize("pattern,ffn,item", [
    (("attn", "xattn"), ("dense", "dense"), "6.4")], ids=["xattn"])
def test_unported_patterns_refused_by_name(pattern, ffn, item):
    """Item 6.4 is ported: a cross-attention pattern (here on SmolLM's
    reduced widths, memory of 4 tokens of 48) routes to the decoder-only
    backend, builds (``xattn_gate``, K/V from ``memory_dim``, a zero
    memory cache) and serves one request; no refusal names the item."""
    cfg = dataclasses.replace(get_config("smollm-135m", reduced=True),
                              layer_pattern=pattern, ffn_pattern=ffn,
                              memory_tokens=4, memory_dim=48)
    assert isinstance(make_backend(cfg, EngineConfig()), DecoderOnlyBackend)
    params = tr.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    xp = params["blocks"][1][0]
    assert not xp["xattn_gate"].any()
    assert xp["attn"]["wk"]["w"].shape == (48, cfg.n_heads * cfg.head_dim)
    cache = tr.init_cache(cfg, 2, 16, device="cpu")
    assert cache[1]["mk"].shape == (cfg.n_repeats, 2, 4, cfg.n_heads,
                                    cfg.head_dim)
    eng = _engine(cfg, params, mode="speculative")
    rid = eng.submit(np.arange(4, 13, dtype=np.int32))
    assert eng.serve()[int(rid)].lengths[0] > 0
    with pytest.raises(ValueError, match="unknown layer kind"):
        tr.init(torch.Generator().manual_seed(0), dataclasses.replace(
            cfg, layer_pattern=("attn", "conv")), device="cpu")


def test_unported_entry_points_refused_by_name(models):
    """Item 6.5 is ported: ``transformer.apply`` runs and its logits equal
    ``prefill``'s; the sliding-window engine refusal stays."""
    _, _, cfg, pt = models("smollm-135m")
    toks = torch.arange(4, 10).reshape(2, 3)
    logits, aux = tr.apply(pt, cfg, toks)
    pre, _ = tr.prefill(pt, cfg, tr.init_cache(cfg, 2, 8, device="cpu"),
                        toks)
    assert aux == {} and logits.shape == (2, 3, cfg.vocab_size)
    torch.testing.assert_close(logits, pre, atol=1e-5, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="sliding_window"):
        _engine(dataclasses.replace(cfg, sliding_window=8), pt, paged=True)
