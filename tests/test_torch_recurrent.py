"""The port's recurrent decoder-only families against the JAX package's:
the Mamba mixer (reduced ``jamba-v0.1-52b``: Mamba and attention 7:1, MoE
FFNs on every other layer) and RWKV6 (reduced ``rwkv6-1.6b``, attention
free), with the JAX params carried across by ``repro_torch.bridge``:

- the modules: ``mamba_mixer`` (ragged lengths, its end state),
  ``mamba_step``, ``rwkv_mixer`` (ragged lengths, a carried state) and
  ``rwkv_channel_mix`` within 1e-5 of JAX's;
- the model: prefill + multi-token decode (per-step checkpoints, then
  ``commit_cache``) within 2e-4 of JAX's full-sequence ``apply``, and a
  short row of a ragged prefill equal to the row alone;
- the speculative rollback: speculative == greedy == JAX tokens
  (``tests/test_speculative.py``'s decoder-only case);
- the slice end to end: a mixed-mode ``StreamingEngine`` (RWKV6 dense,
  Jamba dense and paged) gives JAX's tokens, ``n_calls`` and beam
  log-probs in all four modes, and equals the port's one-shot path; an
  idle prefill lane leaves a row's recurrent state bitwise as it was;
- refusals by name: paging an attention-free pattern, ``prefix_cache`` on
  a recurrent pattern (the JAX engine's shared Jamba child differs from
  its cold run: the radix tree holds no recurrent state) and multi-draft
  verification; the fleet replica serves a reduced recurrent arch.

The JAX engines are built once per module; the port runs on the CPU with
one torch thread.
"""

import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import greedy_decode as jax_greedy  # noqa: E402
from repro.core import speculative_greedy_decode as jax_spec  # noqa: E402
from repro.core import transformer_handle as jax_handle  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import StreamingEngine as JaxStreamingEngine  # noqa: E402
from repro_torch.bridge import transformer_params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (extract_drafts, greedy_decode,  # noqa: E402
                              multidraft_speculative_decode,
                              prompt_lookup_drafts,
                              speculative_greedy_decode, transformer_handle)
from repro_torch.models import mamba, rwkv  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serving import EngineConfig, StreamingEngine  # noqa: E402

JAMBA, RWKV = "jamba-v0.1-52b", "rwkv6-1.6b"
ARCHS = [JAMBA, RWKV]
EOS = 2
MAX_NEW, MAX_SRC, DL, ND = 10, 28, 4, 3
MODES = ("greedy", "speculative", "beam", "speculative_beam")
GROUPS = {"greedy": 2, "speculative": 2, "beam": 1, "speculative_beam": 1}
ENGINE = dict(draft_len=DL, n_drafts=ND, n_beams=3, max_new=MAX_NEW,
              max_src=MAX_SRC, prefill_chunk=5, eos_id=EOS)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


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


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# the modules


def test_mamba_mixer_and_step_match_jax():
    jcfg = jax_get_config(JAMBA, reduced=True)
    cfg = get_config(JAMBA, reduced=True)
    jp = jmamba.mamba_init(jax.random.PRNGKey(1), jcfg)
    pt = _tensors(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 9, cfg.d_model)).astype(np.float32)
    lengths = np.array([9, 4, 1], np.int32)
    jout, jc = jmamba.mamba_mixer(jp, jcfg, jnp.asarray(x),
                                  lengths=jnp.asarray(lengths),
                                  return_state=True)
    tout, tc = mamba.mamba_mixer(pt, cfg, torch.from_numpy(x),
                                 lengths=torch.from_numpy(lengths),
                                 return_state=True)
    for b, L in enumerate(lengths):
        _close(tout[b, :L], jout[b, :L])
    for k in ("conv", "ssm"):
        _close(tc[k], jc[k])
    # three steps on from that state
    x2 = rng.standard_normal((3, 3, cfg.d_model)).astype(np.float32)
    jout, jc = jmamba.mamba_step(jp, jcfg, jc, jnp.asarray(x2))
    tout, tc = mamba.mamba_step(pt, cfg, tc, torch.from_numpy(x2))
    _close(tout, jout)
    for k in ("conv", "ssm"):
        _close(tc[k], jc[k])


def test_rwkv_mixer_and_channel_mix_match_jax():
    jcfg = jax_get_config(RWKV, reduced=True)
    cfg = get_config(RWKV, reduced=True)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    jp = jrwkv.rwkv_init(k1, jcfg)
    jc = jrwkv.rwkv_channel_init(k2, jcfg)
    pt = _tensors(jax.tree.map(np.asarray, jp))
    tc = _tensors(jax.tree.map(np.asarray, jc))
    rng = np.random.default_rng(4)
    B, T, d = 3, 7, cfg.d_model
    H, hd = d // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    S = rng.standard_normal((B, H, hd, hd)).astype(np.float32) * 0.1
    x_last = rng.standard_normal((B, d)).astype(np.float32)
    lengths = np.array([7, 3, 0], np.int32)
    jout, (jS, jx) = jrwkv.rwkv_mixer(
        jp, jcfg, jnp.asarray(x), state=jnp.asarray(S),
        x_last=jnp.asarray(x_last), lengths=jnp.asarray(lengths))
    tout, (tS, tx) = rwkv.rwkv_mixer(
        pt, cfg, torch.from_numpy(x), state=torch.from_numpy(S),
        x_last=torch.from_numpy(x_last), lengths=torch.from_numpy(lengths))
    _close(tout, jout)
    _close(tS, jS)
    _close(tx, jx)
    jout, jx = jrwkv.rwkv_channel_mix(jc, jnp.asarray(x),
                                      x_last=jnp.asarray(x_last))
    tout, tx = rwkv.rwkv_channel_mix(tc, torch.from_numpy(x),
                                     x_last=torch.from_numpy(x_last))
    _close(tout, jout)
    _close(tx, jx)


# ---------------------------------------------------------------------------
# the model


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_full_sequence(models, arch):
    """Prefill 6 tokens, then decode the next 6 in steps of 3 (per-step
    checkpoints, committed whole): logits within 2e-4 of JAX's
    full-sequence ``apply`` over all 12."""
    jcfg, jp, cfg, pt = models(arch)
    B = 2
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (B, 12), 4,
                                         cfg.vocab_size)).astype(np.int32)
    full, _ = jtr.apply(jp, jcfg, jnp.asarray(toks))
    cache = tr.init_cache(cfg, B, 32, device="cpu")
    logits, cache = tr.prefill(pt, cfg, cache, torch.from_numpy(toks[:, :6]))
    _close(logits, full[:, :6], 2e-4)
    for start in (6, 9):
        pos = np.tile(np.arange(start, start + 3, dtype=np.int32), (B, 1))
        logits, ckpt = tr.decode_step(pt, cfg, cache,
                                      torch.from_numpy(toks[:, start:
                                                            start + 3]),
                                      torch.from_numpy(pos))
        cache = tr.commit_cache(cfg, ckpt, torch.full((B,), 3))
        _close(logits, full[:, start:start + 3], 2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_ragged_lengths(models, arch):
    """A short row of a padded prefill decodes as the same row alone (its
    recurrent state stops at its length), and both equal JAX's."""
    jcfg, jp, cfg, pt = models(arch)
    rng = np.random.default_rng(3)
    toks = rng.integers(4, cfg.vocab_size, (2, 10)).astype(np.int32)
    nxt = rng.integers(4, cfg.vocab_size, (2, 1)).astype(np.int32)
    cache = tr.init_cache(cfg, 2, 32, device="cpu")
    tr.prefill(pt, cfg, cache, torch.from_numpy(toks),
               lengths=torch.tensor([10, 6], dtype=torch.int32))
    step, _ = tr.decode_step(pt, cfg, cache, torch.from_numpy(nxt),
                             torch.tensor([[10], [6]], dtype=torch.int32))
    solo = tr.init_cache(cfg, 1, 32, device="cpu")
    tr.prefill(pt, cfg, solo, torch.from_numpy(toks[1:2, :6]))
    one, _ = tr.decode_step(pt, cfg, solo, torch.from_numpy(nxt[1:2]),
                            torch.tensor([[6]], dtype=torch.int32))
    _close(step[1], one[0], 2e-4)
    jc = jtr.init_cache(jcfg, 2, 32)
    _, jc = jtr.prefill(jp, jcfg, jc, jnp.asarray(toks),
                        lengths=jnp.asarray([10, 6], jnp.int32))
    jstep, _ = jtr.decode_step(jp, jcfg, jc, jnp.asarray(nxt),
                               jnp.asarray([[10], [6]], jnp.int32))
    _close(step, jstep, 2e-4)


def test_commit_keeps_the_checkpoint_at_n_keep(models):
    """``decode_step`` leaves the cache's state as it was; ``commit_cache``
    at 0 gives it back bitwise, at n the state after n fed tokens."""
    _, _, cfg, pt = models(RWKV)
    cache = tr.init_cache(cfg, 2, 16, device="cpu")
    tr.prefill(pt, cfg, cache, torch.arange(4, 12).reshape(2, 4))
    before = {k: v.clone() for k, v in cache[0].items()}
    toks = torch.arange(20, 26).reshape(2, 3)
    pos = torch.tensor([[4, 5, 6], [4, 5, 6]], dtype=torch.int32)
    _, ckpt = tr.decode_step(pt, cfg, cache, toks, pos)
    assert ckpt[0]["S"].shape[2] == 4                 # (R, B, T+1, ...)
    kept = tr.commit_cache(cfg, ckpt, torch.tensor([0, 2]))
    _, one = tr.decode_step(pt, cfg, cache, toks[:, :2], pos[:, :2])
    for k, v in before.items():
        assert torch.equal(cache[0][k], v)
        assert torch.equal(kept[0][k][:, 0], v[:, 0])
        assert torch.equal(kept[0][k][:, 1], one[0][k][:, 1, 2])


@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_equals_greedy_and_jax(models, arch):
    """The speculative rollback keeps the accepted checkpoint: speculative
    tokens == greedy tokens == JAX's, one-shot prefill of 9 tokens."""
    jcfg, jp, cfg, pt = models(arch)
    B, P, max_new = 2, 10, 12
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (B, P), 4,
                                           cfg.vocab_size)).astype(np.int32)
    prompt[:, P // 2:] = prompt[:, :P - P // 2]
    S = P + max_new + DL + 4
    ds, ms = zip(*(extract_drafts(r, DL, ND) for r in prompt))
    drafts, mask = np.stack(ds).astype(np.int32), np.stack(ms)

    def port_cache():
        c = tr.init_cache(cfg, B, S, device="cpu")
        tr.prefill(pt, cfg, c, torch.from_numpy(prompt[:, :P - 1]))
        return c

    def jax_cache():
        c = jtr.init_cache(jcfg, B, S)
        return jtr.prefill(jp, jcfg, c, jnp.asarray(prompt[:, :P - 1]))[1]

    last = torch.from_numpy(prompt[:, P - 1])
    pos = torch.full((B,), P - 1, dtype=torch.int32)
    handle = transformer_handle(pt, cfg)
    g = greedy_decode(handle, port_cache(), last, pos, max_new=max_new,
                      eos_id=EOS)
    s = speculative_greedy_decode(handle, port_cache(), last, pos,
                                  torch.from_numpy(drafts),
                                  torch.from_numpy(mask), max_new=max_new,
                                  eos_id=EOS)
    js = jax_spec(jax_handle(jp, jcfg), jax_cache(),
                  jnp.asarray(prompt[:, P - 1]), jnp.asarray(pos.numpy()),
                  jnp.asarray(drafts), jnp.asarray(mask), max_new=max_new,
                  eos_id=EOS)
    jg = jax_greedy(jax_handle(jp, jcfg), jax_cache(),
                    jnp.asarray(prompt[:, P - 1]), jnp.asarray(pos.numpy()),
                    max_new=max_new, eos_id=EOS)
    np.testing.assert_array_equal(s.tokens.numpy(), g.tokens.numpy())
    np.testing.assert_array_equal(g.tokens.numpy(), np.asarray(jg.tokens))
    np.testing.assert_array_equal(s.tokens.numpy(), np.asarray(js.tokens))
    assert s.n_calls == int(js.n_calls) <= g.n_calls


# ---------------------------------------------------------------------------
# the slice end to end


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(4, 500, size=L).astype(np.int32)
            for L in (9, 17, 24, 1, 21, 5)]


@pytest.fixture(scope="module")
def mixed_runs(models, prompts):
    """(arch, paged) -> (JAX results, port results) of one mixed-group
    engine each, every prompt in every mode, arrivals staggered."""
    out = {}

    def get(arch, paged):
        if (arch, paged) not in out:
            jcfg, jp, cfg, pt = models(arch)
            kw = dict(ENGINE, mode_groups=GROUPS, paged=paged, page_size=8)
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
            out[arch, paged] = runs
        return out[arch, paged]

    return get


@pytest.mark.parametrize("arch,paged", [(RWKV, False), (JAMBA, False),
                                        (JAMBA, True)],
                         ids=["rwkv-dense", "jamba-dense", "jamba-paged"])
def test_streaming_matches_jax_in_all_modes(mixed_runs, arch, paged):
    want, got = mixed_runs(arch, paged)
    for (m, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(b.tokens, np.asarray(a.tokens),
                                      err_msg=m)
        np.testing.assert_array_equal(b.lengths, np.asarray(a.lengths))
        assert b.n_calls == a.n_calls and b.accepted == a.accepted, m
        if m.endswith("beam"):
            np.testing.assert_allclose(b.logprobs, np.asarray(a.logprobs),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["greedy", "speculative"])
def test_streaming_matches_one_shot(models, mixed_runs, prompts, mode):
    """RWKV6: chunked ragged prefill in recycled slots (state committed at
    each chunk's length) == one monolithic prefill + decode."""
    _, _, cfg, pt = models(RWKV)
    streamed = [r for m, r in mixed_runs(RWKV, False)[1] if m == mode]
    handle = transformer_handle(pt, cfg)
    for p, r in zip(prompts, streamed):
        P = len(p)
        cache = tr.init_cache(cfg, 1, P + MAX_NEW + DL + 4, device="cpu")
        if P > 1:
            tr.prefill(pt, cfg, cache, torch.from_numpy(p[None, :-1]))
        last = torch.tensor([int(p[-1])], dtype=torch.int32)
        pos = torch.tensor([P - 1], dtype=torch.int32)
        if mode == "greedy":
            o = greedy_decode(handle, cache, last, pos, max_new=MAX_NEW,
                              eos_id=EOS)
        else:
            d, m = prompt_lookup_drafts(p, DL, ND)
            o = speculative_greedy_decode(
                handle, cache, last, pos, torch.from_numpy(d[None]),
                torch.from_numpy(m[None]), max_new=MAX_NEW, eos_id=EOS)
        np.testing.assert_array_equal(r.tokens[0], o.tokens[0].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_idle_prefill_lane_keeps_recurrent_state(models, arch):
    """A chunk lane with ``n_valid == 0`` leaves its row's recurrent state
    bitwise as it was, beside a lane that writes."""
    _, _, cfg, pt = models(arch)
    eng = StreamingEngine(pt, cfg, None, EngineConfig(
        mode="greedy", n_slots=2, **ENGINE), device="cpu")
    cache = eng.scheduler.state.cache
    gen = torch.Generator().manual_seed(5)
    rec = [i for i, k in enumerate(cfg.layer_pattern) if k in tr.RECURRENT]
    for i in rec:
        for v in cache[i].values():
            v.copy_(torch.randn(v.shape, generator=gen))
    before = [{k: v.clone() for k, v in cache[i].items()} for i in rec]
    C = ENGINE["prefill_chunk"]
    tokens = torch.randint(4, 500, (2, C), generator=gen, dtype=torch.int32)
    eng.backend.prefill_chunks_cache(
        pt, cache, eng._chunk_rows0("greedy"), tokens,
        torch.tensor([0, 3], dtype=torch.int32),
        torch.tensor([0, 4], dtype=torch.int32))
    for i, b in zip(rec, before):
        for k, v in cache[i].items():
            assert torch.equal(v[:, 0], b[k][:, 0]), (i, k)   # idle lane
            assert not torch.equal(v[:, 1], b[k][:, 1]), (i, k)


# ---------------------------------------------------------------------------
# refusals and the fleet replica


def test_paged_attention_free_pattern_refused(models):
    _, _, cfg, pt = models(RWKV)
    with pytest.raises(ValueError, match="nothing to page"):
        StreamingEngine(pt, cfg, None, EngineConfig(paged=True, **ENGINE),
                        device="cpu")
    with pytest.raises(ValueError, match="no attention positions"):
        from repro_torch.serving import DecoderOnlyBackend
        DecoderOnlyBackend(cfg, EngineConfig(**ENGINE)).init_cache(
            2, 16, paged=(4, 8), device="cpu")


def test_prefix_cache_refused_on_recurrent_patterns(models):
    """The port refuses ``prefix_cache`` on Jamba by name, paged or dense.
    The JAX engine turns radix sharing on there (Jamba has an attention
    position to page), and its shared child differs from the cold run: the
    child skips the prefix's prefill and its Mamba state starts from
    zero."""
    jcfg, jp, cfg, pt = models(JAMBA)
    for paged in (True, False):
        with pytest.raises(ValueError, match="recurrent"):
            StreamingEngine(pt, cfg, None, EngineConfig(
                prefix_cache=True, paged=paged, page_size=8, **ENGINE),
                device="cpu")
    rng = np.random.default_rng(0)
    prefix = rng.integers(4, 500, size=40).astype(np.int32)
    suffix = rng.integers(4, 500, size=9).astype(np.int32)
    kw = dict(ENGINE, mode="greedy", n_slots=2, max_src=96, prefill_chunk=8,
              paged=True, page_size=8)
    out = {}
    for share in (False, True):
        eng = JaxStreamingEngine(jp, jcfg, None, JaxEngineConfig(
            prefix_cache=share, **kw))
        h = eng.submit(prefix)
        eng.serve()
        c = (h.submit_child(suffix) if share
             else eng.submit(np.concatenate([prefix, suffix])))
        out[share] = np.asarray(eng.serve()[int(c)].tokens[0])
        if share:
            assert eng.prefix_stats()["hit_tokens"] > 0
    assert not np.array_equal(out[True], out[False])


@pytest.mark.parametrize("arch", ARCHS)
def test_multidraft_refused_on_recurrent_patterns(models, arch):
    _, _, cfg, pt = models(arch)
    cache = tr.init_cache(cfg, 1, 32, device="cpu")
    with pytest.raises(NotImplementedError, match="recurrent"):
        multidraft_speculative_decode(
            pt, cfg, cache, torch.tensor([5]), torch.tensor([0]),
            torch.zeros((1, 2, 3), dtype=torch.int32),
            torch.ones((1, 2), dtype=torch.bool), max_new=4, eos_id=EOS)


def test_fleet_replica_serves_a_recurrent_arch():
    """``--model arch --arch rwkv6-1.6b --reduced`` builds, warms and
    serves (dense: nothing to page)."""
    from repro_torch.serving.fleet.replica import build_engine

    args = argparse.Namespace(
        model="arch", arch=RWKV, reduced=True, device="cpu", mode="greedy",
        max_new=6, max_src=24, slots=2, draft_len=4, n_drafts=2,
        paged=False, page_size=8, prefix_cache=False, prefill_chunk=8)
    eng = build_engine(args)
    h = eng.submit(np.arange(4, 15, dtype=np.int32))
    r = eng.serve()[int(h)]
    assert r.tokens.shape == (1, 6) and int(r.lengths[0]) >= 1
