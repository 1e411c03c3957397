"""The port's cross-attention (VLM) family against the JAX package's, on
reduced Llama-3.2-Vision (four self-attention layers, then one gated
cross-attention layer reading a frontend memory), with the JAX params
carried across by ``repro_torch.bridge`` (the cross-attention gates set
away from their init of 0, where tanh(0) hides the memory):

- ``prefill(memory=, memory_mask=)`` then ``decode_step(memory_mask=)``
  logits within 1e-4 of JAX's;
- greedy, speculative (expanded drafts) and single-pass multi-draft
  decoding through ``transformer_handle(memory_mask=)`` and
  ``multidraft_speculative_decode(memory_mask=)``: tokens and calls
  identical to JAX's (``tests/test_multidraft.py``'s set-up), and equal to
  each other;
- the decoder-only ``StreamingEngine`` on the VLM (no memory path, as in
  the JAX package: the cross-attention reads the cache's zero memory K/V)
  == the JAX engine, greedy and speculative, paged; the audio encoder is
  refused by both packages' backends.

The port runs on the CPU with one torch thread.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import extract_drafts  # noqa: E402
from repro.core import greedy_decode as jax_greedy  # noqa: E402
from repro.core import speculative_greedy_decode as jax_spec  # noqa: E402
from repro.core import transformer_handle as jax_handle  # noqa: E402
from repro.core.multidraft import (  # noqa: E402
    multidraft_speculative_decode as jax_multidraft)
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import StreamingEngine as JaxStreamingEngine  # noqa: E402
from repro.serving.backend import (  # noqa: E402
    DecoderOnlyBackend as JaxDecoderOnlyBackend)
from repro_torch.bridge import transformer_params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (greedy_decode, multidraft_speculative_decode,  # noqa: E402
                              speculative_greedy_decode, transformer_handle)
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serving import (DecoderOnlyBackend, EngineConfig,  # noqa: E402
                                 StreamingEngine, make_backend)

ARCH = "llama-3.2-vision-11b"
MAX_NEW, DL, N_D, EOS = 20, 4, 5, 2
B, P = 2, 12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vlm():
    """(JAX cfg, JAX params, port cfg, port params, prompt (B, P), memory
    (B, M, memory_dim), memory mask (B, M) with a ragged second row)."""
    jcfg = jax_get_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jp = jtr.init(jax.random.PRNGKey(11), jcfg)
    blocks = list(jp["blocks"])
    for i, kind in enumerate(jcfg.layer_pattern):
        if kind == "xattn":
            blocks[i] = dict(blocks[i], xattn_gate=jnp.full_like(
                blocks[i]["xattn_gate"], 0.8))
    jp = dict(jp, blocks=tuple(blocks))
    pt = transformer_params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    rng = np.random.default_rng(11)
    prompt = rng.integers(4, cfg.vocab_size, (B, P)).astype(np.int32)
    M = cfg.memory_tokens
    memory = (rng.standard_normal((B, M, cfg.memory_dim))
              * 0.5).astype(np.float32)
    mask = np.arange(M)[None] < np.array([M, 5])[:, None]
    return jcfg, jp, cfg, pt, prompt, memory, mask


def test_prefill_and_decode_step_memory_mask_match_jax(vlm):
    jcfg, jp, cfg, pt, prompt, memory, mask = vlm
    toks = np.concatenate([prompt, prompt[:, ::-1]], axis=1)
    jc = jtr.init_cache(jcfg, B, 32)
    tc = tr.init_cache(cfg, B, 32, device="cpu")
    jl, jc = jtr.prefill(jp, jcfg, jc, jnp.asarray(toks[:, :P]),
                         memory=jnp.asarray(memory),
                         memory_mask=jnp.asarray(mask))
    tl, tc = tr.prefill(pt, cfg, tc, torch.from_numpy(toks[:, :P]),
                        memory=torch.from_numpy(memory),
                        memory_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for start in range(P, 2 * P, 4):
        chunk = toks[:, start:start + 4]
        pos = np.tile(start + np.arange(4, dtype=np.int32), (B, 1))
        jl, jc = jtr.decode_step(jp, jcfg, jc, jnp.asarray(chunk),
                                 jnp.asarray(pos),
                                 memory_mask=jnp.asarray(mask))
        tl, tc = tr.decode_step(pt, cfg, tc, torch.from_numpy(chunk),
                                torch.from_numpy(pos),
                                memory_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    # the memory K/V prefill keeps equals JAX's
    i = jcfg.layer_pattern.index("xattn")
    for k in ("mk", "mv"):
        np.testing.assert_allclose(tc[i][k].numpy(), np.asarray(jc[i][k]),
                                   atol=1e-5, rtol=1e-5)


def test_prefill_with_a_memory_of_other_length_matches_jax(vlm):
    """A memory of 10 tokens into a cache sized for ``memory_tokens`` (16):
    the cache's memory K/V takes the memory's length, as JAX's prefill
    replaces the entry, and decoding reads it."""
    jcfg, jp, cfg, pt, prompt, memory, _ = vlm
    jc, tc = jtr.init_cache(jcfg, B, 24), tr.init_cache(cfg, B, 24,
                                                       device="cpu")
    _, jc = jtr.prefill(jp, jcfg, jc, jnp.asarray(prompt[:, :8]),
                        memory=jnp.asarray(memory[:, :10]))
    _, tc = tr.prefill(pt, cfg, tc, torch.from_numpy(prompt[:, :8]),
                       memory=torch.from_numpy(memory[:, :10]))
    i = cfg.layer_pattern.index("xattn")
    assert tc[i]["mk"].shape[2] == 10
    pos = np.tile(np.arange(8, 12, dtype=np.int32), (B, 1))
    jl, _ = jtr.decode_step(jp, jcfg, jc, jnp.asarray(prompt[:, 8:]),
                            jnp.asarray(pos))
    tl, _ = tr.decode_step(pt, cfg, tc, torch.from_numpy(prompt[:, 8:]),
                           torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "ragged"])
def test_greedy_speculative_multidraft_match_jax(vlm, masked):
    jcfg, jp, cfg, pt, prompt, memory, mask = vlm
    mm = mask if masked else None
    ds, ms = zip(*(extract_drafts(r, DL, N_D) for r in prompt))
    drafts, dmask = np.stack(ds), np.stack(ms)
    last, pos = prompt[:, P - 1], np.full((B,), P - 1, np.int32)
    size = P + MAX_NEW + DL + 4

    def jfresh():
        c = jtr.init_cache(jcfg, B, size)
        _, c = jtr.prefill(jp, jcfg, c, jnp.asarray(prompt[:, :P - 1]),
                           memory=jnp.asarray(memory),
                           memory_mask=None if mm is None
                           else jnp.asarray(mm))
        return c

    def tfresh():
        c = tr.init_cache(cfg, B, size, device="cpu")
        _, c = tr.prefill(pt, cfg, c, torch.from_numpy(prompt[:, :P - 1]),
                          memory=torch.from_numpy(memory),
                          memory_mask=None if mm is None
                          else torch.from_numpy(mm))
        return c

    jmm = None if mm is None else jnp.asarray(mm)
    tmm = None if mm is None else torch.from_numpy(mm)
    jh = jax_handle(jp, jcfg, memory_mask=jmm)
    th = transformer_handle(pt, cfg, memory_mask=tmm)
    jargs = (jnp.asarray(last), jnp.asarray(pos))
    targs = (torch.from_numpy(last), torch.from_numpy(pos))
    jd, jm = jnp.asarray(drafts), jnp.asarray(dmask)
    td, tm = torch.from_numpy(drafts), torch.from_numpy(dmask)
    kw = dict(max_new=MAX_NEW, eos_id=EOS)
    want = {
        "greedy": jax_greedy(jh, jfresh(), *jargs, **kw),
        "speculative": jax_spec(jh, jfresh(), *jargs, jd, jm, **kw),
        "multidraft": jax_multidraft(jp, jcfg, jfresh(), *jargs, jd, jm,
                                     memory_mask=jmm, **kw)}
    got = {
        "greedy": greedy_decode(th, tfresh(), *targs, **kw),
        "speculative": speculative_greedy_decode(th, tfresh(), *targs, td,
                                                 tm, **kw),
        "multidraft": multidraft_speculative_decode(
            pt, cfg, tfresh(), *targs, td, tm, memory_mask=tmm, **kw)}
    for name in want:
        np.testing.assert_array_equal(got[name].tokens.numpy(),
                                      np.asarray(want[name].tokens),
                                      err_msg=name)
        np.testing.assert_array_equal(got[name].lengths.numpy(),
                                      np.asarray(want[name].lengths))
        assert int(got[name].n_calls) == int(want[name].n_calls), name
    for name in ("speculative", "multidraft"):
        assert torch.equal(got[name].tokens, got["greedy"].tokens)
    assert got["multidraft"].n_calls == got["speculative"].n_calls


def test_streaming_engine_on_the_vlm_matches_jax(vlm):
    """The engine has no memory path in either package: the VLM serves on
    the cache's zero memory K/V. Greedy and speculative groups of one
    paged engine, ragged prompts, tokens and calls == the JAX engine's."""
    jcfg, jp, cfg, pt, _, _, _ = vlm
    rng = np.random.default_rng(5)
    prompts = [rng.integers(4, 500, size=L).astype(np.int32)
               for L in (9, 17, 1, 14)]
    kw = dict(draft_len=DL, n_drafts=N_D, max_new=12, max_src=24,
              n_slots=2, prefill_chunk=5, eos_id=EOS, paged=True,
              page_size=8, mode_groups={"greedy": 2, "speculative": 2})
    runs = []
    for eng in (JaxStreamingEngine(jp, jcfg, None, JaxEngineConfig(**kw)),
                StreamingEngine(pt, cfg, None, EngineConfig(**kw),
                                device="cpu")):
        rids = [(m, eng.submit(p, arrival=float(i), mode=m))
                for i, p in enumerate(prompts)
                for m in ("greedy", "speculative")]
        res = eng.serve()
        runs.append([(m, res[int(r)]) for m, r in rids])
    for (m, a), (_, b) in zip(*runs):
        np.testing.assert_array_equal(b.tokens, np.asarray(a.tokens),
                                      err_msg=m)
        assert b.n_calls == a.n_calls and b.accepted == a.accepted, m


def test_audio_encoder_is_refused_by_both_backends():
    """HuBERT has no decode step: both packages' decoder-only backends
    refuse it by family, and the port's routing and decode entry points
    refuse it too; it trains through ``transformer.apply``."""
    jcfg = jax_get_config("hubert-xlarge", reduced=True)
    cfg = get_config("hubert-xlarge", reduced=True)
    with pytest.raises(ValueError, match="encoder-only"):
        JaxDecoderOnlyBackend(jcfg, JaxEngineConfig(eos_id=EOS))
    with pytest.raises(ValueError, match="encoder-only"):
        DecoderOnlyBackend(cfg, EngineConfig(eos_id=EOS))
    with pytest.raises(ValueError, match="encoder-only"):
        make_backend(cfg, EngineConfig(eos_id=EOS))
    with pytest.raises(ValueError, match="encoder-only"):
        tr.check_serves(cfg)
    params = tr.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert "tok" not in params
    logits, aux = tr.apply(params, cfg, embeddings=torch.zeros(
        (1, 5, cfg.d_model)))
    assert logits.shape == (1, 5, cfg.vocab_size) and aux == {}
