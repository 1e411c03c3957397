"""The port's Mixture-of-Experts FFN and the MoE decoder-only models
against the JAX package's, on the reduced ``phi3.5-moe-42b-a6.6b`` (4
experts, top-2, every layer MoE) and ``llama4-maverick-400b-a17b`` (4
experts, top-1, shared expert, dense and MoE FFNs interleaved) configs,
with the JAX params carried across by ``repro_torch.bridge``:

- ``moe_ffn`` at capacity factors 0.5 (drops), 1.25 (the default) and
  E/k, with and without the shared expert: outputs within 1e-5 of JAX's,
  the router's experts and keep mask equal, the dropped and top-1
  fractions equal and the two losses within 1e-6;
- the model: prefill + multi-token decode logits within 2e-4 of JAX's
  full-sequence ``apply`` (``tests/test_models.py::
  test_decode_matches_full``) and a short row of a ragged prefill equal to
  the row alone (``test_prefill_ragged_lengths``);
- the slice end to end: a paged mixed-mode ``StreamingEngine`` on Phi
  and Llama-4 reduced gives JAX's tokens, ``n_calls`` and beam log-probs
  in all four modes, and so does Phi at capacity factor 0.5, where
  routing drops choices and a row's output depends on the strangers in
  its call;
- multi-draft verification on Phi reduced equals JAX's decoder and the
  port's greedy one.

The JAX engines are built once per module; the port runs on the CPU with
one torch thread.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import multidraft as jmd  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import StreamingEngine as JaxStreamingEngine  # noqa: E402
from repro_torch.bridge import transformer_params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (extract_drafts, greedy_decode,  # noqa: E402
                              multidraft_speculative_decode,
                              transformer_handle)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serving import EngineConfig, StreamingEngine  # noqa: E402

PHI, LLAMA4 = "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"
ARCHS = [PHI, LLAMA4]
EOS = 2
MODES = ("greedy", "speculative", "beam", "speculative_beam")
GROUPS = {"greedy": 2, "speculative": 2, "beam": 1, "speculative_beam": 1}
ENGINE = dict(draft_len=4, n_drafts=3, n_beams=3, max_new=10, max_src=28,
              prefill_chunk=5, eos_id=EOS, mode_groups=GROUPS)


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
    """(arch, capacity factor or None) -> (JAX cfg, JAX params, port cfg,
    port params): the same weights at every capacity factor."""
    out = {}

    def get(arch, cf=None):
        if (arch, cf) not in out:
            jcfg = jax_get_config(arch, reduced=True)
            cfg = get_config(arch, reduced=True)
            if cf is not None:
                jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
                    jcfg.moe, capacity_factor=cf))
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=cf))
            jp = jtr.init(jax.random.PRNGKey(0), jcfg)
            pt = transformer_params_from_jax(jax.tree.map(np.asarray, jp),
                                             device="cpu")
            out[arch, cf] = (jcfg, jp, cfg, pt)
        return out[arch, cf]

    return get


def _jax_keep(p, cfg, x):
    """JAX ``moe_ffn``'s experts and keep mask (its lines, which it does
    not return)."""
    m = cfg.moe
    tokens = x.reshape(-1, x.shape[-1])
    n_tok, E, k = tokens.shape[0], m.n_experts, m.top_k
    probs = jax.nn.softmax((tokens @ p["router"]["w"]).astype(jnp.float32))
    _, gate_idx = jax.lax.top_k(probs, k)
    capacity = max(1, int(k * n_tok / E * m.capacity_factor))
    flat = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32).reshape(n_tok * k, E)
    pos = jnp.max((jnp.cumsum(flat, axis=0) * flat - 1).reshape(n_tok, k, E),
                  axis=-1)
    return np.asarray(gate_idx), np.asarray(pos < capacity)


@pytest.mark.parametrize("cf", [0.5, 1.25, "E/k"])
@pytest.mark.parametrize("arch", ARCHS, ids=["no_shared", "shared"])
def test_moe_ffn_matches_jax(arch, cf):
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    if cf == "E/k":
        cf = cfg.moe.n_experts / cfg.moe.top_k
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    assert cfg.moe.shared_expert == (arch == LLAMA4)
    jp = jmoe.moe_init(jax.random.PRNGKey(1), jcfg)
    pt = _tensors(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(2).standard_normal(
        (3, 7, cfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.moe_ffn(jp, jcfg, jnp.asarray(x))
    tout, taux = moe.moe_ffn(pt, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    gate_idx, keep = _jax_keep(jp, jcfg, jnp.asarray(x))
    r = moe.moe_route(pt, cfg, torch.from_numpy(x).reshape(-1, cfg.d_model))
    np.testing.assert_array_equal(r["gate_idx"].numpy(), gate_idx)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    if cf < 1:
        assert not keep.all()      # drops happen
    for name in ("moe_dropped_frac", "moe_top1_frac"):
        assert float(taux[name]) == float(jaux[name]), name
    for name in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_full_sequence(models, arch):
    """Prefill 6 tokens, then decode the next 6 in steps of 3 (as
    verification feeds them): logits within 2e-4 of JAX's full-sequence
    ``apply`` over all 12."""
    jcfg, jp, cfg, pt = models(arch)
    B = 2
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (B, 12), 4,
                                         cfg.vocab_size)).astype(np.int32)
    full, _ = jtr.apply(jp, jcfg, jnp.asarray(toks))
    cache = tr.init_cache(cfg, B, 32, device="cpu")
    logits, cache = tr.prefill(pt, cfg, cache, torch.from_numpy(toks[:, :6]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(full[:, :6]),
                               rtol=2e-4, atol=2e-4)
    for start in (6, 9):
        pos = np.tile(np.arange(start, start + 3, dtype=np.int32), (B, 1))
        logits, cache = tr.decode_step(pt, cfg, cache,
                                       torch.from_numpy(toks[:, start:
                                                             start + 3]),
                                       torch.from_numpy(pos))
        cache = tr.commit_cache(cfg, cache, torch.full((B,), 3))
        np.testing.assert_allclose(logits.numpy(),
                                   np.asarray(full[:, start:start + 3]),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_ragged_lengths(models, arch):
    """A short row of a padded prefill decodes as the same row alone, and
    both equal JAX's."""
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
    np.testing.assert_allclose(step[1].numpy(), one[0].numpy(), rtol=2e-4,
                               atol=2e-4)
    jc = jtr.init_cache(jcfg, 2, 32)
    _, jc = jtr.prefill(jp, jcfg, jc, jnp.asarray(toks),
                        lengths=jnp.asarray([10, 6], jnp.int32))
    jstep, _ = jtr.decode_step(jp, jcfg, jc, jnp.asarray(nxt),
                               jnp.asarray([[10], [6]], jnp.int32))
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), rtol=2e-4,
                               atol=2e-4)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(4, 500, size=L).astype(np.int32)
            for L in (9, 17, 24, 1, 21, 5)]


def _serve(eng, prompts):
    rids = [(m, eng.submit(p, arrival=float(i), mode=m))
            for i, p in enumerate(prompts) for m in MODES]
    res = eng.serve()
    return [(m, res[int(r)]) for m, r in rids]


@pytest.mark.parametrize("arch,cf", [(PHI, None), (PHI, 0.5),
                                     (LLAMA4, None)],
                         ids=["phi-dropless", "phi-drops", "llama4"])
def test_streaming_matches_jax_in_all_modes(models, prompts, arch, cf):
    """Paged, every mode in one engine with staggered arrivals: tokens,
    lengths, calls and accepted counts equal JAX's (beam log-probs within
    1e-5). At capacity factor 0.5 routing drops choices, so idle slots, pad
    lanes and draft rows take capacity: the port must feed the MoE what
    the JAX engine feeds it (a pad row reads JAX's mean of V)."""
    jcfg, jp, cfg, pt = models(arch, cf)
    kw = dict(ENGINE, paged=True, page_size=8)
    want = _serve(JaxStreamingEngine(jp, jcfg, None, JaxEngineConfig(**kw)),
                  prompts)
    te = StreamingEngine(pt, cfg, None, EngineConfig(**kw), device="cpu")
    got = _serve(te, prompts)
    te.allocator.check()
    for (m, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(b.tokens, np.asarray(a.tokens),
                                      err_msg=m)
        np.testing.assert_array_equal(b.lengths, np.asarray(a.lengths))
        assert b.n_calls == a.n_calls and b.accepted == a.accepted, m
        if m.endswith("beam"):
            np.testing.assert_allclose(b.logprobs, np.asarray(a.logprobs),
                                       rtol=1e-5, atol=1e-5)


def test_multidraft_matches_jax_and_greedy(models):
    """Phi reduced (dropless): multi-draft verification's tokens, lengths
    and calls equal JAX's, and its tokens the port's greedy decoder's."""
    jcfg, jp, cfg, pt = models(PHI)
    B, P, DL, N_D, max_new = 2, 12, 4, 3, 16
    rng = np.random.default_rng(1)
    prompt = rng.integers(4, cfg.vocab_size, (B, P)).astype(np.int32)
    prompt[:, P // 2:] = prompt[:, :P - P // 2]
    ds, ms = zip(*(extract_drafts(r, DL, N_D) for r in prompt))
    drafts, mask = np.stack(ds).astype(np.int32), np.stack(ms)
    S = P + max_new + DL + 4

    def port_cache():
        c = tr.init_cache(cfg, B, S, device="cpu")
        tr.prefill(pt, cfg, c, torch.from_numpy(prompt[:, :P - 1]))
        return c

    jc = jtr.init_cache(jcfg, B, S)
    _, jc = jtr.prefill(jp, jcfg, jc, jnp.asarray(prompt[:, :P - 1]))
    last = torch.from_numpy(prompt[:, P - 1])
    pos = torch.full((B,), P - 1, dtype=torch.int32)
    j = jmd.multidraft_speculative_decode(
        jp, jcfg, jc, jnp.asarray(prompt[:, P - 1]), jnp.asarray(pos.numpy()),
        jnp.asarray(drafts), jnp.asarray(mask), max_new=max_new, eos_id=EOS)
    m = multidraft_speculative_decode(
        pt, cfg, port_cache(), last, pos, torch.from_numpy(drafts),
        torch.from_numpy(mask), max_new=max_new, eos_id=EOS)
    g = greedy_decode(transformer_handle(pt, cfg), port_cache(), last, pos,
                      max_new=max_new, eos_id=EOS)
    np.testing.assert_array_equal(m.tokens.numpy(), np.asarray(j.tokens))
    np.testing.assert_array_equal(m.lengths.numpy(), np.asarray(j.lengths))
    assert m.n_calls == int(j.n_calls)
    np.testing.assert_array_equal(m.tokens.numpy(), g.tokens.numpy())
