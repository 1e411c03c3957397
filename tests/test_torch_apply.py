"""The port's full-sequence ``transformer.apply`` against the JAX
package's, on every reduced config of JAX's ``ALL_ARCHS`` (the dense,
MoE, Mamba-hybrid, RWKV, VLM and audio families), with the JAX params
carried across by ``repro_torch.bridge``:

- logits and the MoE auxiliary losses within 1e-4, HuBERT on frame
  ``embeddings``, the VLM with a ``memory`` and a ragged ``memory_mask``;
- ``lengths`` (padding masks, recurrent mixers skipping the pads; on an
  MoE pattern a row of length 0, whose attention sees no key and takes the
  JAX model's mean of V), explicit ``positions`` that are not the indices,
  a sliding window and ``causal=False``;
- the port's ``prefill`` + chunked ``decode_step`` == its own ``apply`` on
  every reduced decoder arch (the sliding-window variant too), the VLM's
  memory read through ``decode_step(memory_mask=)``.

The port runs on the CPU with one torch thread; the JAX side runs eagerly
(no jit), so the file costs no compiles beyond the scan bodies.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.bridge import transformer_params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

DECODER_ARCHS = [
    "command-r-35b", "qwen3-8b", "llama-3.2-vision-11b", "jamba-v0.1-52b",
    "llama4-maverick-400b-a17b", "starcoder2-15b", "smollm-135m",
    "rwkv6-1.6b", "phi3.5-moe-42b-a6.6b",
]
ALL_ARCHS = DECODER_ARCHS + ["hubert-xlarge"]
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(arch, **replace):
    """(JAX cfg, JAX params, port cfg, port params): the same weights,
    JAX's init carried across."""
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    if replace:
        jcfg = dataclasses.replace(jcfg, **replace)
        cfg = dataclasses.replace(cfg, **replace)
    jp = open_gates(jtr.init(jax.random.PRNGKey(0), jcfg), jcfg)
    pt = transformer_params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return jcfg, jp, cfg, pt


def open_gates(jp, jcfg):
    """The JAX params with each cross-attention gate set to 0.7 (init
    leaves it 0, where tanh(0) hides the cross-attention entirely)."""
    blocks = list(jp["blocks"])
    for i, kind in enumerate(jcfg.layer_pattern):
        if kind == "xattn":
            blocks[i] = dict(blocks[i], xattn_gate=jnp.full_like(
                blocks[i]["xattn_gate"], 0.7))
    return dict(jp, blocks=tuple(blocks))


def inputs(cfg, B=2, T=12, seed=0):
    """numpy model inputs: (tokens or None, kwargs): frame embeddings for
    the audio family, a memory and a ragged memory mask for the VLM."""
    rng = np.random.default_rng(seed)
    kw = {}
    tokens = None
    if cfg.family == "audio":
        kw["embeddings"] = (0.1 * rng.standard_normal(
            (B, T, cfg.d_model))).astype(np.float32)
    else:
        tokens = rng.integers(4, cfg.vocab_size, (B, T)).astype(np.int32)
    if cfg.family == "vlm":
        M = cfg.memory_tokens
        kw["memory"] = (0.1 * rng.standard_normal(
            (B, M, cfg.memory_dim))).astype(np.float32)
        kw["memory_mask"] = (np.arange(M)[None]
                             < np.array([M, M // 3])[:, None])
    return tokens, kw


def _jax(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def both_apply(arch, *, tokens=None, kw=None, replace=None, **akw):
    """(port logits, port aux, JAX logits, JAX aux) as numpy."""
    jcfg, jp, cfg, pt = models(arch, **(replace or {}))
    if tokens is None and kw is None:
        tokens, kw = inputs(cfg)
    jl, ja = jtr.apply(jp, jcfg, _jax(tokens),
                       **{k: _jax(v) for k, v in {**kw, **akw}.items()})
    tl, ta = tr.apply(pt, cfg, _torch(tokens),
                      **{k: _torch(v) for k, v in {**kw, **akw}.items()})
    return (tl.detach().numpy(), {k: float(v) for k, v in ta.items()},
            np.asarray(jl), {k: float(v) for k, v in ja.items()})


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_apply_matches_jax(arch):
    tl, ta, jl, ja = both_apply(arch)
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)
    assert ta.keys() == ja.keys()
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch,lengths", [
    ("smollm-135m", [12, 7]),
    ("jamba-v0.1-52b", [12, 5]),
    ("rwkv6-1.6b", [9, 12]),
    # a row of length 0: its attention sees no key; on an MoE pattern its
    # hidden state takes expert capacity, so it must be JAX's mean of V
    ("phi3.5-moe-42b-a6.6b", [12, 0]),
    ("llama4-maverick-400b-a17b", [0, 6]),
    ("hubert-xlarge", [12, 4]),
])
def test_apply_with_lengths_matches_jax(arch, lengths):
    tl, ta, jl, ja = both_apply(arch, lengths=np.array(lengths, np.int32))
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], atol=TOL, rtol=TOL)


def _positions(B, T, seed=3):
    """Positions that are not the indices: an offset and a shuffle a row
    (the kernels' position masks) and a restart in the middle (packed
    sequences)."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.integers(0, 30) + rng.permutation(T)
                    for _ in range(B)]).astype(np.int32)
    pos[-1] = np.concatenate([np.arange(T // 2), np.arange(T - T // 2)])
    return pos


@pytest.mark.parametrize("arch,replace,causal", [
    ("smollm-135m", {}, None),
    ("qwen3-8b", {}, None),
    ("smollm-135m", {"sliding_window": 4}, None),
    ("phi3.5-moe-42b-a6.6b", {}, None),
    ("llama-3.2-vision-11b", {}, False),
])
def test_apply_with_positions_matches_jax(arch, replace, causal):
    """Explicit positions (RoPE at them, causal and window masks on them),
    also bidirectional."""
    tl, _, jl, _ = both_apply(arch, replace=replace,
                              positions=_positions(2, 12), causal=causal)
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)


def test_apply_sliding_window_matches_jax():
    tl, _, jl, _ = both_apply("starcoder2-15b",
                              replace={"sliding_window": 5})
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch,window", [(a, 0) for a in DECODER_ARCHS]
                         + [("smollm-135m", 8)])
def test_prefill_and_decode_match_own_apply(arch, window):
    """``prefill`` of 6 tokens, then ``decode_step`` in chunks of 3
    (committed), against the port's own full-sequence ``apply`` at every
    position, within 2e-4 (the JAX package's own test tolerance). The VLM
    prefills its memory's K/V and decodes under the memory mask. The
    sliding-window variant (a ring buffer of 8 slots) prefills 4 tokens
    and decodes one at a time, as the JAX package's test does: a chunk
    that wraps the ring overwrites keys its own queries still see."""
    cfg = get_config(arch, reduced=True)
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    params = tr.init(torch.Generator().manual_seed(2), cfg, device="cpu")
    for i, kind in enumerate(cfg.layer_pattern):
        for p in params["blocks"][i]:
            if kind == "xattn":
                p["xattn_gate"].fill_(0.7)
    B, T = 2, 12
    T_pre, step = (4, 1) if window else (6, 3)
    tokens, kw = inputs(cfg, B=B, T=T, seed=2)
    tokens = torch.from_numpy(tokens)
    kw = {k: torch.from_numpy(v) for k, v in kw.items()}
    full, _ = tr.apply(params, cfg, tokens, **kw)
    full = full.detach().numpy()
    cache = tr.init_cache(cfg, B, 32, device="cpu")
    pre, cache = tr.prefill(params, cfg, cache, tokens[:, :T_pre], **kw)
    np.testing.assert_allclose(pre.numpy(), full[:, :T_pre], atol=2e-4,
                               rtol=2e-4)
    for start in range(T_pre, T, step):
        chunk = tokens[:, start:start + step]
        pos = (torch.arange(chunk.shape[1], dtype=torch.int32)
               + start)[None].repeat(B, 1)
        logits, cache = tr.decode_step(params, cfg, cache, chunk, pos,
                                       memory_mask=kw.get("memory_mask"))
        cache = tr.commit_cache(cfg, cache, torch.full((B,), chunk.shape[1]))
        np.testing.assert_allclose(logits.numpy(),
                                   full[:, start:start + step], atol=2e-4,
                                   rtol=2e-4)
