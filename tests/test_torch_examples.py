"""The paper's two example scripts in the PyTorch port
(``examples/quickstart_torch.py``, ``examples/serve_retrosynthesis_torch.py``)
and the benchmark substrate they share (``benchmarks/common_torch.py``)
against the JAX package on the CPU, fp32:

- quickstart's ``run`` at a reduced size (one epoch of training from JAX's
  initial weights, bridged), then JAX's ``ReactionEngine`` on the port's
  trained weights, bridged back: the same SMILES, ``n_calls`` and
  acceptance a query in greedy and speculative mode; speculative ==
  greedy; ``main`` prints the identity line;
- serve_retrosynthesis's ``run`` on JAX's initial weights (bridged; a
  shorter ``max_new``) against JAX's ``ReactionEngine.predict_topn`` in
  beam and speculative-beam mode: identical SMILES lists and ``n_calls``,
  log-probs within 1e-4; the streamed top-n == the per-request top-n;
- ``common_torch.trained_model`` for one epoch into a temp dir: reloaded
  weights equal the trained ones bit for bit, JAX's
  ``repro.checkpoint.load_checkpoint`` reads the file (the layout
  contract), and a cache of another config is removed and trained again.
"""

import contextlib
import io
import runpy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import load_checkpoint as jax_load  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.configs.mt import tiny_config as jax_tiny  # noqa: E402
from repro.data import SyntheticReactionDataset as JaxDataset  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ReactionEngine as JaxReactionEngine  # noqa: E402
from repro_torch.bridge import (seq2seq_params_from_jax,  # noqa: E402
                                seq2seq_params_to_jax)
from repro_torch.models import seq2seq as ts2s  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOGPROB_TOL = dict(atol=1e-4, rtol=1e-4)
RETRO_MAX_NEW = 24


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def quickstart():
    return runpy.run_path(str(ROOT / "examples" / "quickstart_torch.py"))


@pytest.fixture(scope="module")
def retro():
    return runpy.run_path(str(ROOT / "examples" /
                              "serve_retrosynthesis_torch.py"))


@pytest.fixture(scope="module")
def common():
    return runpy.run_path(str(ROOT / "benchmarks" / "common_torch.py"))


def jax_init(vocab: int):
    jcfg = jax_tiny(vocab, depth=2, d_model=128, max_len=192)
    return jcfg, js2s.init(jax.random.PRNGKey(0), jcfg)


def to_jax(params):
    return jax.tree.map(jax.numpy.asarray, seq2seq_params_to_jax(params))


def test_quickstart_matches_jax(quickstart):
    jds = JaxDataset(quickstart["N_REACTIONS"], seed=0)
    jcfg, jp = jax_init(jds.tokenizer.vocab_size)
    tp = seq2seq_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    out = quickstart["run"](device="cpu", params=tp, epochs=1, n_queries=6)
    assert len(out["history"]) == 1 and np.isfinite(out["history"][0]["loss"])
    assert out["identical"]
    trained = to_jax(out["params"])
    for mode, ecfg in quickstart["engine_configs"]().items():
        eng = JaxReactionEngine(trained, jcfg, jds.tokenizer,
                                JaxEngineConfig(**{
                                    f: getattr(ecfg, f) for f in (
                                        "mode", "draft_len", "n_drafts",
                                        "max_new")}))
        for q, got in zip(out["queries"], out[mode]):
            want = eng.predict([q])[0]
            assert got.smiles == want.smiles, (mode, q)
            assert got.n_calls == want.n_calls, (mode, q)
            assert got.acceptance_rate == pytest.approx(want.acceptance_rate,
                                                        abs=1e-6)
    assert [p.smiles for p in out["speculative"]] == [
        p.smiles for p in out["greedy"]]
    assert out["calls"]["speculative"] <= out["calls"]["greedy"]


def test_quickstart_main_prints_identity(quickstart):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        quickstart["main"](["--device", "cpu", "--epochs", "1",
                            "--queries", "2"])
    text = buf.getvalue()
    assert "dataset: 384 reactions" in text
    assert "outputs identical: True" in text
    assert "decoder calls" in text and "prediction for query 0:" in text


def test_serve_retrosynthesis_matches_jax(retro, common):
    train_ds, test_ds = common["datasets"]("retro")
    jtrain = JaxDataset(common["N_TRAIN"], seed=0, direction="retro")
    jcfg, jp = jax_init(train_ds.tokenizer.vocab_size)
    tcfg = common["model_config"](train_ds.tokenizer.vocab_size)
    tp = seq2seq_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    out = retro["run"](2, device="cpu", model=(tcfg, tp, train_ds, test_ds),
                       max_new=RETRO_MAX_NEW)
    for mode in retro["MODES"]:
        ecfg = retro["cfg_for"](mode, RETRO_MAX_NEW)
        eng = JaxReactionEngine(jp, jcfg, jtrain.tokenizer, JaxEngineConfig(
            **{f: getattr(ecfg, f) for f in ("mode", "n_beams", "draft_len",
                                             "n_drafts", "max_new",
                                             "n_slots")}))
        r = out[mode]
        calls = 0
        for q, got, streamed in zip(out["requests"], r["per_request"],
                                    r["streamed"]):
            want = eng.predict_topn(q)
            calls += want.n_calls
            assert got.smiles == want.smiles, (mode, q)
            assert got.n_calls == want.n_calls, (mode, q)
            np.testing.assert_allclose(got.logprobs, want.logprobs,
                                       **LOGPROB_TOL)
            # continuous batching returns what one request at a time does
            assert streamed["smiles"] == got.smiles, (mode, q)
            np.testing.assert_allclose(streamed["logprobs"], got.logprobs,
                                       **LOGPROB_TOL)
        assert r["calls"] == calls
        assert r["shared_steps"] > 0 and r["resident_calls"] > 0
    last = out["last"]
    assert last.smiles == out["speculative_beam"]["per_request"][-1].smiles


def test_trained_model_cache_round_trip(common, tmp_path):
    path = str(tmp_path / "mt.msgpack")
    cfg, trained, train_ds, _ = common["trained_model"](
        epochs=1, device="cpu", cache=path)
    assert Path(path).exists()
    _, loaded, _, _ = common["trained_model"](epochs=1, device="cpu",
                                              cache=path)
    a, b = seq2seq_params_to_jax(trained), seq2seq_params_to_jax(loaded)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    # the JAX package reads the port's file: the layout contract
    _, like = jax_init(train_ds.tokenizer.vocab_size)
    got = jax_load(path, params_like=like)["params"]
    for x, y in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(a)):
        assert np.array_equal(np.asarray(x), y)
    init = seq2seq_params_to_jax(ts2s.init(torch.Generator().manual_seed(0),
                                           cfg, device="cpu"))
    assert not all(np.array_equal(x, y) for x, y in zip(
        jax.tree_util.tree_leaves(init), jax.tree_util.tree_leaves(a)))


def test_stale_cache_is_trained_again(common, tmp_path):
    path = str(tmp_path / "mt.msgpack")
    jcfg = jax_tiny(16, depth=1, d_model=32, max_len=192)
    jax_save(path, params=js2s.init(jax.random.PRNGKey(0), jcfg))
    cfg, params, train_ds, _ = common["trained_model"](
        epochs=0, device="cpu", cache=path)
    assert cfg.vocab_size == train_ds.tokenizer.vocab_size
    _, like = jax_init(train_ds.tokenizer.vocab_size)
    got = jax_load(path, params_like=like)["params"]   # rewritten, this config
    for x, y in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(
            seq2seq_params_to_jax(params))):
        assert np.array_equal(np.asarray(x), y)
