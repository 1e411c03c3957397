"""The port's decoding core against the JAX package's: source-copy drafts,
and greedy / speculative / beam / speculative beam on a random tiny MT
(tokens, lengths and n_calls identical; log-probs within 1e-4). Plus the
paper's guarantees inside the port: speculative == greedy for any drafts,
and SBS with DL=0 == beam search."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.configs.mt import tiny_config as jax_tiny_config  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro_torch.bridge import seq2seq_params_from_jax  # noqa: E402
from repro_torch.configs.mt import tiny_config  # noqa: E402
from repro_torch.models import seq2seq as ts2s  # noqa: E402

MAX_NEW, DL, N_D, VOCAB = 20, 4, 6, 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models' ops are far too small to share out between threads,
    and under pytest-xdist every worker's own thread pool would contend for
    the same cores; one thread, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dilations", [(1,), (1, 2)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drafting_matches_jax(dilations, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, 30, (5, 24)).astype(np.int32)
    for b, n in enumerate((24, 15, 7, 3, 0)):       # ragged, short, empty
        rows[b, n:] = 0
    rows[0, 5] = 0                                   # an interior pad
    for dl, nd in ((4, 6), (10, 25), (6, 40)):
        got = tcore.batch_drafts(rows, dl, nd, dilations=dilations)
        want = jcore.batch_drafts(rows, dl, nd, dilations=dilations)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for r in rows:
            for g, w in zip(tcore.extract_drafts(r, dl, nd, dilations=dilations),
                            jcore.extract_drafts(r, dl, nd, dilations=dilations)):
                np.testing.assert_array_equal(g, w)


class _Pair:
    """One random tiny MT in both packages, with encoded sources."""

    def __init__(self, seed: int, B: int):
        self.cfg_j = jax_tiny_config(VOCAB, depth=2, d_model=64, max_len=64)
        self.cfg_t = tiny_config(VOCAB, depth=2, d_model=64, max_len=64)
        self.pj = js2s.init(jax.random.PRNGKey(seed), self.cfg_j)
        self.pt = seq2seq_params_from_jax(jax.tree.map(np.asarray, self.pj),
                                          device="cpu")
        self.src = np.random.default_rng(seed + 1).integers(
            4, VOCAB, (B, 12)).astype(np.int32)
        self.B = B
        self.mj, smj = js2s.encode(self.pj, self.cfg_j, jnp.asarray(self.src))
        self.mt, smt = ts2s.encode(self.pt, self.cfg_t,
                                   torch.from_numpy(self.src))
        self.hj = jcore.seq2seq_handle(self.pj, self.cfg_j, memory_mask=smj)
        self.ht = tcore.seq2seq_handle(self.pt, self.cfg_t, memory_mask=smt)

    def caches(self, dl=DL):
        n = MAX_NEW + dl + 4
        return (js2s.init_cache(self.cfg_j, self.B, n, memory=self.mj,
                                params=self.pj),
                ts2s.init_cache(self.cfg_t, self.B, n, memory=self.mt,
                                params=self.pt))

    def drafts(self):
        d, m = tcore.batch_drafts(self.src, DL, N_D)
        return d, m


def _start(B):
    return (np.full((B,), 1, np.int32), np.zeros((B,), np.int32))


def _same(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.fixture(scope="module", params=[0, 3])
def pair2(request):
    return _Pair(request.param, B=2)


@pytest.fixture(scope="module", params=[0, 7])
def pair1(request):
    return _Pair(request.param, B=1)


def test_greedy_matches_jax(pair2):
    p = pair2
    cj, ct = p.caches()
    last, pos = _start(p.B)
    j = jcore.greedy_decode(p.hj, cj, jnp.asarray(last), jnp.asarray(pos),
                            max_new=MAX_NEW, eos_id=2)
    t = tcore.greedy_decode(p.ht, ct, torch.from_numpy(last),
                            torch.from_numpy(pos), max_new=MAX_NEW, eos_id=2)
    _same(t.tokens, j.tokens)
    _same(t.lengths, j.lengths)
    assert t.n_calls == int(j.n_calls)


def test_speculative_matches_jax(pair2):
    p = pair2
    cj, ct = p.caches()
    last, pos = _start(p.B)
    d, m = p.drafts()
    j = jcore.speculative_greedy_decode(
        p.hj, cj, jnp.asarray(last), jnp.asarray(pos), jnp.asarray(d),
        jnp.asarray(m), max_new=MAX_NEW, eos_id=2)
    t = tcore.speculative_greedy_decode(
        p.ht, ct, torch.from_numpy(last), torch.from_numpy(pos),
        torch.from_numpy(d), torch.from_numpy(m), max_new=MAX_NEW, eos_id=2)
    _same(t.tokens, j.tokens)
    _same(t.lengths, j.lengths)
    _same(t.accepted_tokens, j.accepted_tokens)
    assert t.n_calls == int(j.n_calls)


def test_beam_matches_jax(pair1):
    p = pair1
    cj, ct = p.caches(dl=0)
    j = jcore.beam_search(p.hj, cj, 1, 0, n_beams=4, max_new=MAX_NEW, eos_id=2)
    t = tcore.beam_search(p.ht, ct, 1, 0, n_beams=4, max_new=MAX_NEW, eos_id=2)
    _same(t.tokens, j.tokens)
    _same(t.lengths, j.lengths)
    np.testing.assert_allclose(t.logprobs.numpy(), np.asarray(j.logprobs),
                               atol=1e-4, rtol=1e-4)
    assert t.n_calls == int(j.n_calls)


def test_speculative_beam_matches_jax(pair1):
    p = pair1
    cj, ct = p.caches()
    d, m = p.drafts()
    j = jcore.speculative_beam_search(p.hj, cj, 1, 0, jnp.asarray(d[0]),
                                      jnp.asarray(m[0]), n_beams=4,
                                      max_new=MAX_NEW, eos_id=2)
    t = tcore.speculative_beam_search(p.ht, ct, 1, 0, torch.from_numpy(d[0]),
                                      torch.from_numpy(m[0]), n_beams=4,
                                      max_new=MAX_NEW, eos_id=2)
    _same(t.tokens, j.tokens)
    _same(t.lengths, j.lengths)
    np.testing.assert_allclose(t.logprobs.numpy(), np.asarray(j.logprobs),
                               atol=1e-4, rtol=1e-4)
    assert t.n_calls == int(j.n_calls)
    assert int(t.accepted_tokens) == int(j.accepted_tokens)


@pytest.mark.parametrize("seed,dl,n_d", [(0, 1, 1), (11, 3, 5), (23, 6, 8),
                                         (42, 2, 3)])
def test_speculative_equals_greedy_for_any_drafts(seed, dl, n_d):
    """Port-internal: ANY draft content (even garbage) never changes the
    output, only the call count (the paper's guarantee)."""
    p = _Pair(seed % 1000, B=2)
    rng = np.random.default_rng(seed)
    drafts = torch.from_numpy(rng.integers(0, VOCAB, (2, n_d, dl)).astype(
        np.int32))
    mask = torch.from_numpy(rng.random((2, n_d)) < 0.8)
    last, pos = (torch.from_numpy(a) for a in _start(2))
    g = tcore.greedy_decode(p.ht, p.caches(dl)[1], last, pos,
                            max_new=MAX_NEW, eos_id=2)
    s = tcore.speculative_greedy_decode(p.ht, p.caches(dl)[1], last, pos,
                                        drafts, mask, max_new=MAX_NEW,
                                        eos_id=2)
    assert torch.equal(g.tokens, s.tokens)
    assert s.n_calls <= g.n_calls


def test_speculative_with_perfect_drafts_cuts_calls(pair2):
    p = pair2
    last, pos = (torch.from_numpy(a) for a in _start(2))
    g = tcore.greedy_decode(p.ht, p.caches()[1], last, pos, max_new=MAX_NEW,
                            eos_id=2)
    s = tcore.speculative_greedy_decode(
        p.ht, p.caches()[1], last, pos, g.tokens[:, None, :DL],
        torch.ones((2, 1), dtype=torch.bool), max_new=MAX_NEW, eos_id=2)
    assert torch.equal(g.tokens, s.tokens)
    assert s.n_calls < g.n_calls
    assert float(s.acceptance_rate.mean()) > 0.1


def test_sbs_dl0_equals_beam_search(pair1):
    """Port-internal: SBS with a single empty draft == beam search."""
    p = pair1
    bs = tcore.beam_search(p.ht, p.caches(0)[1], 1, 0, n_beams=4,
                           max_new=MAX_NEW, eos_id=2)
    sbs = tcore.speculative_beam_search(
        p.ht, p.caches(0)[1], 1, 0, torch.zeros((1, 0), dtype=torch.int32),
        torch.ones((1,), dtype=torch.bool), n_beams=4, max_new=MAX_NEW,
        eos_id=2)
    assert torch.equal(bs.tokens, sbs.tokens)
    torch.testing.assert_close(bs.logprobs, sbs.logprobs, atol=1e-5,
                               rtol=1e-5)
    assert bs.n_calls == sbs.n_calls
