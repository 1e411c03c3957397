"""The port's ReactionEngine against the JAX ReactionEngine on the trained
toy MT (the ``trained_mt`` session fixture), with the engine configs of
``tests/test_serving.py``, in all four modes: SMILES and n_calls identical,
acceptance rates equal, log-probs within 1e-4 (fp32 on the CPU).

This is the only port test file that uses ``trained_mt``: each xdist
worker trains its own copy of it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ReactionEngine as JaxReactionEngine  # noqa: E402
from repro_torch.bridge import seq2seq_params_from_jax  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data.tokenizer import SmilesTokenizer  # noqa: E402
from repro_torch.serving import EngineConfig, ReactionEngine  # noqa: E402

PREDICT = [dict(mode="greedy"),
           dict(mode="speculative", draft_len=6, n_drafts=16),
           dict(mode="speculative", draft_len=8, n_drafts=20)]
TOPN = [dict(mode="beam", n_beams=4),
        dict(mode="speculative_beam", n_beams=4, draft_len=8, n_drafts=12)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models' ops are far too small to share out between threads,
    and under pytest-xdist every worker's own thread pool would contend for
    the same cores; one thread, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines(trained_mt):
    ds, cfg, params = trained_mt
    pt = seq2seq_params_from_jax(jax.tree.map(np.asarray, params),
                                 device="cpu")
    cfg_t = ModelConfig(**{f: getattr(cfg, f) for f in (
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab_size", "head_dim", "use_bias", "gated_ffn", "norm",
        "n_encoder_layers", "max_len")})
    tok_t = SmilesTokenizer.from_dict(ds.tokenizer.to_dict())
    built = {}   # one engine pair per config: the JAX engine keeps its jits

    def make(**kw):
        kw = dict(max_new=72, max_src=96, **kw)
        key = tuple(sorted(kw.items()))
        if key not in built:
            built[key] = (JaxReactionEngine(params, cfg, ds.tokenizer,
                                            JaxEngineConfig(**kw)),
                          ReactionEngine(pt, cfg_t, tok_t, EngineConfig(**kw),
                                         device="cpu"))
        return built[key]

    return ds, make


def _assert_same(pt, pj):
    assert pt.smiles == pj.smiles
    assert pt.n_calls == pj.n_calls
    assert pt.acceptance_rate == pytest.approx(pj.acceptance_rate, abs=1e-12)
    np.testing.assert_allclose(pt.logprobs, pj.logprobs, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("kw", PREDICT, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_predict_matches_jax(engines, kw):
    ds, make = engines
    queries = [ds.pair(i)[0] for i in range(6)]
    jax_eng, port_eng = make(**kw)
    for pt, pj in zip(port_eng.predict(queries), jax_eng.predict(queries)):
        _assert_same(pt, pj)


@pytest.mark.parametrize("kw", TOPN, ids=lambda kw: kw["mode"])
@pytest.mark.parametrize("i", [3, 5])
def test_predict_topn_matches_jax(engines, kw, i):
    ds, make = engines
    jax_eng, port_eng = make(**kw)
    query = ds.pair(i)[0]
    _assert_same(port_eng.predict_topn(query), jax_eng.predict_topn(query))


def test_speculative_matches_greedy_in_port(engines):
    """The paper's accuracy-neutrality at the string level, in the port."""
    ds, make = engines
    queries = [ds.pair(i)[0] for i in range(6, 10)]
    g = make(mode="greedy")[1].predict(queries)
    s = make(mode="speculative", draft_len=6, n_drafts=16)[1].predict(queries)
    assert [p.smiles for p in g] == [p.smiles for p in s]
    assert sum(p.n_calls for p in s) < sum(p.n_calls for p in g)
