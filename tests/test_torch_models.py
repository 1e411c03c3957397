"""The port's Molecular Transformer against the JAX package's, layer by
layer and end to end, on random tiny params (depth 2, d_model 64, 4 heads)
carried across by ``repro_torch.bridge``. fp32 on the CPU, atol = rtol =
1e-4 (the packages sum in different orders).

Also: the port imports nothing of JAX or of the JAX package.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.mt import tiny_config as jax_tiny_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro_torch.bridge import seq2seq_params_from_jax  # noqa: E402
from repro_torch.configs.mt import tiny_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import seq2seq as ts2s  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ROOT = Path(__file__).resolve().parent.parent
VOCAB = 48


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_tiny_config(VOCAB, depth=2, d_model=64)
    cfg_t = tiny_config(VOCAB, depth=2, d_model=64)
    pj = js2s.init(jax.random.PRNGKey(5), cfg_j)
    # non-trivial norms and biases, so the bridge's mapping is really tested
    rng = np.random.default_rng(0)
    pj = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        jax.tree.map(np.asarray, pj))
    pt = seq2seq_params_from_jax(pj, device="cpu")
    return cfg_j, cfg_t, jax.tree.map(jnp.asarray, pj), pt


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _x(shape, seed=1):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _tokens(shape, seed=2):
    a = np.random.default_rng(seed).integers(4, VOCAB, shape).astype(np.int32)
    return jnp.asarray(a), torch.from_numpy(a)


def test_bridge_splits_stacked_layers(model):
    cfg_j, cfg_t, pj, pt = model
    assert len(pt["enc_blocks"]) == 2 and len(pt["dec_blocks"]) == 2
    _close(pt["dec_blocks"][1]["cross_attn"]["wk"]["w"],
           pj["dec_blocks"]["cross_attn"]["wk"]["w"][1])
    _close(pt["tok"]["embed"], pj["tok"]["embed"])


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_apply_norm(model, kind):
    _, _, pj, pt = model
    jx, tx = _x((2, 5, 64))
    pj_n = {"scale": pj["enc_norm"]["scale"]}
    pt_n = {"scale": pt["enc_norm"]["scale"]}
    if kind == "layernorm":
        pj_n["bias"], pt_n["bias"] = pj["enc_norm"]["bias"], pt["enc_norm"]["bias"]
    _close(tlayers.apply_norm(pt_n, tx, kind),
           jlayers.apply_norm(pj_n, jx, kind))


def test_ffn(model):
    _, _, pj, pt = model
    jx, tx = _x((2, 5, 64))
    _close(tlayers.ffn(pt["dec_blocks"][0]["ffn"], tx),
           jlayers.ffn(jax.tree.map(lambda a: a[0], pj["dec_blocks"]["ffn"]),
                       jx))


@pytest.mark.parametrize("causal", [False, True])
def test_attention(model, causal):
    cfg_j, cfg_t, pj, pt = model
    jx, tx = _x((2, 7, 64))
    pad = np.array([[True] * 7, [True] * 4 + [False] * 3])
    kw_j = dict(causal=causal, padding_mask=jnp.asarray(pad))
    kw_t = dict(causal=causal, padding_mask=torch.from_numpy(pad))
    _close(tattn.attention(pt["enc_blocks"][1]["attn"], cfg_t, tx, **kw_t),
           jattn.attention(jax.tree.map(lambda a: a[1],
                                        pj["enc_blocks"]["attn"]),
                           cfg_j, jx, **kw_j))


def test_cross_attention(model):
    cfg_j, cfg_t, pj, pt = model
    jx, tx = _x((2, 3, 64))
    jm, tm = _x((2, 9, 64), seed=3)
    mask = np.array([[True] * 9, [True] * 5 + [False] * 4])
    pj1 = jax.tree.map(lambda a: a[0], pj["dec_blocks"]["cross_attn"])
    pt1 = pt["dec_blocks"][0]["cross_attn"]
    _close(tattn.cross_attention(pt1, cfg_t, tx, tm,
                                 memory_mask=torch.from_numpy(mask)),
           jattn.cross_attention(pj1, cfg_j, jx, jm,
                                 memory_mask=jnp.asarray(mask)))
    # the precomputed-K/V decode-time form
    _close(tattn.cached_cross_attention(pt1, cfg_t, tx,
                                        tattn.memory_kv(pt1, cfg_t, tm),
                                        memory_mask=torch.from_numpy(mask)),
           jattn.cached_cross_attention(pj1, cfg_j, jx,
                                        jattn.memory_kv(pj1, cfg_j, jm),
                                        memory_mask=jnp.asarray(mask)))


def test_cached_attention(model):
    """A prefill, then a DL+1-token verify feed, then a step where one row
    feeds position -1 (written to slot S-1 with stored position -1). Rows
    with no visible key (the -1 query) differ by design — the port's kernel
    returns 0 where the JAX einsum returns a uniform mean — so outputs are
    compared on the rows that see at least one key; caches everywhere."""
    cfg_j, cfg_t, pj, pt = model
    pj1 = jax.tree.map(lambda a: a[0], pj["dec_blocks"]["self_attn"])
    pt1 = pt["dec_blocks"][0]["self_attn"]
    B, S = 2, 24
    cj = jattn.init_kv_cache(cfg_j, B, S)
    ct = tattn.init_kv_cache(cfg_t, B, S, device="cpu")
    feeds = [np.tile(np.arange(5), (B, 1)),                   # prefill 0..4
             np.array([np.arange(4, 15), np.arange(2, 13)]),  # DL+1 = 11 verify
             np.array([[15], [-1]])]                          # -1 write
    for i, pos in enumerate(feeds):
        pos = pos.astype(np.int32)
        jx, tx = _x(pos.shape + (64,), seed=10 + i)
        oj, cj = jattn.cached_attention(pj1, cfg_j, jx, cj, jnp.asarray(pos))
        ot, ct = tattn.cached_attention(pt1, cfg_t, tx, ct,
                                        torch.from_numpy(pos))
        valid = pos >= 0
        _close(ot[torch.from_numpy(valid)], np.asarray(oj)[valid])
        for f in ("k", "v", "pos"):
            _close(getattr(ct, f), getattr(cj, f))
    assert int(ct.pos[1, S - 1]) == -1


@pytest.fixture(scope="module")
def encoded(model):
    cfg_j, cfg_t, pj, pt = model
    src = np.random.default_rng(4).integers(4, VOCAB, (2, 14)).astype(np.int32)
    src[1, 10:] = 0                                   # padded row
    mj, smj = js2s.encode(pj, cfg_j, jnp.asarray(src))
    mt, smt = ts2s.encode(pt, cfg_t, torch.from_numpy(src))
    return mj, smj, mt, smt


def test_encode(encoded):
    mj, smj, mt, smt = encoded
    _close(mt, mj)
    np.testing.assert_array_equal(smt.numpy(), np.asarray(smj))


def test_decode_and_apply(model, encoded):
    cfg_j, cfg_t, pj, pt = model
    mj, smj, mt, smt = encoded
    jt, tt = _tokens((2, 10))
    _close(ts2s.decode(pt, cfg_t, tt, mt, smt),
           js2s.decode(pj, cfg_j, jt, mj, smj))
    lengths = np.array([10, 6], np.int32)
    src = np.random.default_rng(4).integers(4, VOCAB, (2, 14)).astype(np.int32)
    lt, _ = ts2s.apply(pt, cfg_t, torch.from_numpy(src), tt,
                       lengths=torch.from_numpy(lengths))
    lj, _ = js2s.apply(pj, cfg_j, jnp.asarray(src), jt,
                       lengths=jnp.asarray(lengths))
    _close(lt, lj)


def test_decode_step_logits(model, encoded):
    """Cached decode in chunks (incl. an 11-token verify feed), port vs JAX."""
    cfg_j, cfg_t, pj, pt = model
    mj, smj, mt, smt = encoded
    jt, tt = _tokens((2, 16), seed=6)
    cj = js2s.init_cache(cfg_j, 2, max_len=32, memory=mj, params=pj)
    ct = ts2s.init_cache(cfg_t, 2, max_len=32, memory=mt, params=pt)
    for start, n in ((0, 1), (1, 11), (12, 4)):
        pos = np.tile(np.arange(start, start + n, dtype=np.int32), (2, 1))
        lj, cj = js2s.decode_step(pj, cfg_j, cj, jt[:, start:start + n],
                                  jnp.asarray(pos), memory_mask=smj)
        lt, ct = ts2s.decode_step(pt, cfg_t, ct, tt[:, start:start + n],
                                  torch.from_numpy(pos), memory_mask=smt)
        _close(lt, lj)


def test_cached_decode_matches_full(model, encoded):
    """Port-internal: cached multi-token decode == teacher-forced decode
    (the analogue of test_models.py::test_seq2seq_decode_matches_full)."""
    cfg_j, cfg_t, pj, pt = model
    _, _, mt, smt = encoded
    _, tgt = _tokens((2, 10), seed=7)
    full = ts2s.decode(pt, cfg_t, tgt, mt, smt)
    cache = ts2s.init_cache(cfg_t, 2, max_len=32, memory=mt, params=pt)
    for start in range(0, 10, 4):
        chunk = tgt[:, start:start + 4]
        pos = (torch.arange(chunk.shape[1], dtype=torch.int32)
               + start).expand(2, -1)
        logits, cache = ts2s.decode_step(pt, cfg_t, cache, chunk, pos,
                                         memory_mask=smt)
        torch.testing.assert_close(logits, full[:, start:start + 4],
                                   atol=2e-4, rtol=2e-4)


def test_init_from_generator_is_deterministic():
    cfg = tiny_config(VOCAB, depth=2, d_model=64)
    a = ts2s.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = ts2s.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert torch.equal(a["dec_blocks"][1]["ffn"]["w_in"]["w"],
                       b["dec_blocks"][1]["ffn"]["w_in"]["w"])
    assert a["lm_head"]["w_vocab"].shape == (64, VOCAB)


def test_entry_points_refuse_a_missing_card():
    """Without device="cpu", a machine with no card is an error, not a
    silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from repro_torch.serving import ReactionEngine
    cfg = tiny_config(VOCAB, depth=2, d_model=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        ts2s.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ReactionEngine({}, cfg, None)


# ---------------------------------------------------------------------------
# independence from JAX and the JAX package

_IMPORT_RE = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(?!_torch)\b"
    r"|from\s+repro(?!_torch)\b)", re.M)


# the port's scripts outside src/: the examples and the benchmark substrate
# they share
SCRIPTS = [ROOT / "examples" / "speculative_lm_torch.py",
           ROOT / "examples" / "quickstart_torch.py",
           ROOT / "examples" / "serve_retrosynthesis_torch.py",
           ROOT / "benchmarks" / "common_torch.py"]


def test_port_imports_no_jax_and_no_repro():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = (
        "import importlib, runpy, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"for s in {[str(s) for s in SCRIPTS]!r}:\n"
        "    runpy.run_path(s)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'repro' or m.startswith('repro.')"
        " or m == 'msgpack' or m.startswith('msgpack.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    files = [*(ROOT / "src" / "repro_torch").rglob("*.py"),
             ROOT / "chip_smoke.py",
             *SCRIPTS]
    offenders = [str(f) for f in files
                 if _IMPORT_RE.search(f.read_text(encoding="utf-8"))]
    assert not offenders, offenders
