"""The port's single-pass multi-draft verification against the JAX
package's (``repro.core.multidraft``, ``repro.models.transformer.
multidraft_verify_step`` / ``commit_multidraft``), on the reduced
``smollm-135m`` and ``qwen3-8b`` configs with the JAX params carried
across by ``repro_torch.bridge``:

- ``build_local_mask`` equals JAX's;
- one verify step's logits and local K/V within 1e-4 of JAX's, and the
  cache ``commit_multidraft`` leaves equal to JAX's;
- ``multidraft_speculative_decode``'s tokens, lengths and ``n_calls``
  equal JAX's, and its tokens equal the port's greedy and expanded-batch
  speculative decoders' (with random drafts, and with drafts cut from the
  greedy output, so that whole drafts are accepted and committed).

The port runs on the CPU with one torch thread.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import multidraft as jmd  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.bridge import transformer_params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (build_local_mask, extract_drafts,  # noqa: E402
                              greedy_decode, multidraft_speculative_decode,
                              speculative_greedy_decode, transformer_handle)
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

ARCHS = ["smollm-135m", "qwen3-8b"]
MAX_NEW, DL, N_D = 20, 4, 5
B, P = 2, 12
EOS = 2


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
            jp = jtr.init(jax.random.PRNGKey(11), jcfg)
            pt = transformer_params_from_jax(jax.tree.map(np.asarray, jp),
                                             device="cpu")
            out[arch] = (jcfg, jp, cfg, pt)
        return out[arch]

    return get


def _prompt(vocab: int, seed: int = 0) -> np.ndarray:
    """B prompts of P tokens whose second half repeats the first, so the
    source-copy drafts hold some of the model's own continuations."""
    rng = np.random.default_rng(seed)
    p = rng.integers(4, vocab, (B, P)).astype(np.int32)
    p[:, P // 2:] = p[:, :P - P // 2]
    return p


def _drafts(prompt):
    ds, ms = zip(*(extract_drafts(r, DL, N_D) for r in prompt))
    return np.stack(ds), np.stack(ms)


def _caches(models, arch, prompt):
    """Fresh JAX and port caches with the prompt minus its last token
    prefilled."""
    jcfg, jp, cfg, pt = models(arch)
    S = P + MAX_NEW + DL + 4

    def jax_cache():
        c = jtr.init_cache(jcfg, B, S)
        _, c = jtr.prefill(jp, jcfg, c, jnp.asarray(prompt[:, :P - 1]))
        return c

    def port_cache():
        c = tr.init_cache(cfg, B, S, device="cpu")
        tr.prefill(pt, cfg, c, torch.from_numpy(prompt[:, :P - 1]))
        return c

    return jax_cache, port_cache


@pytest.mark.parametrize("n_drafts,draft_len", [(2, 3), (5, 4), (1, 1),
                                                (3, 0)])
def test_build_local_mask_matches_jax(n_drafts, draft_len):
    np.testing.assert_array_equal(build_local_mask(n_drafts, draft_len),
                                  jmd.build_local_mask(n_drafts, draft_len))


@pytest.mark.parametrize("arch", ARCHS)
def test_verify_step_and_commit_match_jax(models, arch):
    """One verify step: logits and every layer's local K/V within 1e-4;
    then ``commit_multidraft`` of a winner with a partial accept gives
    JAX's cache (stored positions exactly, K/V within 1e-4)."""
    jcfg, jp, cfg, pt = models(arch)
    prompt = _prompt(cfg.vocab_size)
    drafts, _ = _drafts(prompt)
    jax_cache, port_cache = _caches(models, arch, prompt)
    T = 1 + N_D * DL
    toks = np.concatenate([prompt[:, -1:], drafts.reshape(B, -1)], axis=1)
    start = np.full((B,), P - 1, np.int32)
    rel = np.arange(DL, dtype=np.int32)
    positions = np.concatenate(
        [start[:, None], np.tile(start[:, None] + 1 + rel[None], (1, N_D))],
        axis=1).astype(np.int32)
    mask = build_local_mask(N_D, DL)
    jc, tc = jax_cache(), port_cache()
    jl, jkv = jtr.multidraft_verify_step(jp, jcfg, jc, jnp.asarray(toks),
                                         jnp.asarray(positions),
                                         jnp.asarray(mask))
    tl, tkv = tr.multidraft_verify_step(pt, cfg, tc, torch.from_numpy(toks),
                                        torch.from_numpy(positions),
                                        torch.from_numpy(mask))
    assert tl.shape == (B, T, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for (tk, tv), (jk, jv) in zip(tkv, jkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                                   atol=1e-4)
    best = np.array([3, 1], np.int32)
    n_acc = np.array([2, 0], np.int32)
    jc = jtr.commit_multidraft(jcfg, jc, jkv, jnp.asarray(best),
                               jnp.asarray(n_acc), jnp.asarray(start),
                               draft_len=DL)
    tc = tr.commit_multidraft(cfg, tc, tkv, torch.from_numpy(best),
                              torch.from_numpy(n_acc),
                              torch.from_numpy(start), draft_len=DL)
    for t, j in zip(tc, jc):
        np.testing.assert_array_equal(t.pos.numpy(), np.asarray(j.pos))
        np.testing.assert_allclose(t.k.numpy(), np.asarray(j.k), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(t.v.numpy(), np.asarray(j.v), rtol=1e-4,
                                   atol=1e-4)


def test_multidraft_attention_refuses_a_paged_cache(models):
    _, _, cfg, pt = models("smollm-135m")
    paged = tr.init_cache(cfg, 1, 16, paged=(4, 8), device="cpu")
    x = torch.zeros((1, 3, cfg.d_model))
    with pytest.raises(TypeError, match="PagedKVCache"):
        attn_mod.multidraft_attention(
            pt["blocks"][0][0]["attn"], cfg, x, tr._layer(paged[0], 0),
            torch.zeros((1, 3), dtype=torch.int32),
            torch.ones((3, 3), dtype=torch.bool))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("drafts_from", ["prompt", "greedy"])
def test_multidraft_decode_matches_jax_greedy_and_expanded(models, arch,
                                                           drafts_from):
    """Tokens, lengths and n_calls equal JAX's multi-draft decoder; tokens
    equal the port's greedy and expanded-batch speculative decoders' and
    n_calls the expanded one's. ``greedy`` drafts are cut from the greedy
    output at each call's position (one masked off), so drafts are
    accepted whole and the commit keeps DL + 1 tokens a call."""
    jcfg, jp, cfg, pt = models(arch)
    prompt = _prompt(cfg.vocab_size, seed=1)
    jax_cache, port_cache = _caches(models, arch, prompt)
    last = torch.from_numpy(prompt[:, P - 1])
    pos = torch.full((B,), P - 1, dtype=torch.int32)
    handle = transformer_handle(pt, cfg)
    g = greedy_decode(handle, port_cache(), last, pos, max_new=MAX_NEW,
                      eos_id=EOS)
    if drafts_from == "prompt":
        drafts, mask = _drafts(prompt)
    else:
        gt = np.concatenate([g.tokens.numpy(),
                             np.zeros((B, N_D * (DL + 1)), np.int32)], 1)
        drafts = np.stack([[gt[b, j * (DL + 1):j * (DL + 1) + DL]
                            for j in range(N_D)] for b in range(B)])
        mask = np.ones((B, N_D), bool)
        mask[1, 2] = False
    drafts = drafts.astype(np.int32)
    j = jmd.multidraft_speculative_decode(
        jp, jcfg, jax_cache(), jnp.asarray(prompt[:, P - 1]),
        jnp.asarray(pos.numpy()), jnp.asarray(drafts), jnp.asarray(mask),
        max_new=MAX_NEW, eos_id=EOS)
    m = multidraft_speculative_decode(
        pt, cfg, port_cache(), last, pos, torch.from_numpy(drafts),
        torch.from_numpy(mask), max_new=MAX_NEW, eos_id=EOS)
    s = speculative_greedy_decode(handle, port_cache(), last, pos,
                                  torch.from_numpy(drafts),
                                  torch.from_numpy(mask), max_new=MAX_NEW,
                                  eos_id=EOS)
    np.testing.assert_array_equal(m.tokens.numpy(), np.asarray(j.tokens))
    np.testing.assert_array_equal(m.lengths.numpy(), np.asarray(j.lengths))
    np.testing.assert_array_equal(m.accepted_tokens.numpy(),
                                  np.asarray(j.accepted_tokens))
    assert m.n_calls == int(j.n_calls) == s.n_calls
    np.testing.assert_array_equal(m.tokens.numpy(), g.tokens.numpy())
    np.testing.assert_array_equal(m.tokens.numpy(), s.tokens.numpy())
    if drafts_from == "greedy":
        assert m.n_calls < g.n_calls
        assert int(m.accepted_tokens.min()) > 0
