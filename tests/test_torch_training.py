"""The port's training (``repro_torch.training``) against the JAX package's
(``repro.training``): loss and metrics, Adam, Noam and clipping, one
seq2seq train step (loss, grad norm and every gradient leaf), a 5-step
loss trajectory against the JAX ``Trainer``, loss falling on synthetic
reactions, and port-trained params carried back (``seq2seq_params_to_jax``)
giving the same greedy tokens in the JAX ``ReactionEngine`` as in the
port's. Inputs are made from a seed with numpy (or carried across by
``repro_torch.bridge``) and fed to both packages; fp32 on the CPU, where
the port's attention runs the flash plain versions forward and backward.
Tolerances: 1e-6 for the loss and the optimizer arithmetic, 1e-4 through
the model (the packages sum in different orders).

Raw params are not held to each other after a step at a real learning
rate: with eps 1e-9, Adam's first delta is about sign(g), so a gradient of
1e-12 with opposite signs in the two packages moves a param by 2·lr. The
loss trajectory is held instead.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.mt import tiny_config as jax_tiny_config  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro.training import Trainer as JaxTrainer  # noqa: E402
from repro.training import make_seq2seq_train_step as jax_make_step  # noqa: E402
from repro.training.loss import cross_entropy_loss as jax_ce  # noqa: E402
from repro.training.optimizer import (  # noqa: E402
    adam_init as jax_adam_init, adam_update as jax_adam_update,
    clip_by_global_norm as jax_clip, noam_schedule as jax_noam)
from repro_torch.bridge import (seq2seq_params_from_jax,  # noqa: E402
                                seq2seq_params_to_jax)
from repro_torch.configs.mt import tiny_config  # noqa: E402
from repro_torch.data import (SyntheticReactionDataset,  # noqa: E402
                              batched_dataset)
from repro_torch.models import seq2seq as ts2s  # noqa: E402
from repro_torch.training import (Trainer, make_seq2seq_train_step,  # noqa: E402
                                  seq2seq_loss_and_grads)
from repro_torch.training.loss import cross_entropy_loss  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    adam_init, adam_update, clip_by_global_norm, noam_schedule, tree_leaves)

TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 96


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny eager steps are launch-bound on one core; under
    pytest-xdist every worker's own thread pool would contend for the same
    cores. One thread, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, **tol):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), **(tol or TOL))


# ---------------------------------------------------------------------------
# loss and optimizer


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(smoothing, masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 7, 13)).astype(np.float32)
    labels = rng.integers(0, 13, (4, 7)).astype(np.int32)
    logits[0, 0, [2, 9]] = 9.0          # a tie: the first index wins
    labels[0, 0] = 2
    mask = (rng.random((4, 7)) < 0.7).astype(np.float32) if masked else None
    kw = dict(label_smoothing=smoothing)
    lt, mt = cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    lj, mj = jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                    mask=None if mask is None else jnp.asarray(mask), **kw)
    _close(lt, lj, atol=1e-6, rtol=1e-6)
    assert set(mt) == set(mj)
    for key in mj:
        _close(mt[key], mj[key], atol=1e-6, rtol=1e-6)


def test_cross_entropy_all_masked_counts_one_token():
    """denom = max(sum mask, 1): an all-pad batch gives 0, not NaN."""
    loss, m = cross_entropy_loss(torch.zeros((2, 3, 5)),
                                 torch.zeros((2, 3), dtype=torch.int32),
                                 mask=torch.zeros((2, 3)))
    assert float(loss) == 0.0 and float(m["tokens"]) == 1.0


def _tree(rng, scale=1.0):
    shapes = {"w": (3, 4), "layers": [{"b": (5,)}, {"b": (5,)}],
              "head": {"w_vocab": (4, 2)}}

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return (scale * rng.standard_normal(node)).astype(np.float32)

    return build(shapes)


def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tmap(fn, v) for v in tree)
    return fn(tree)


def _match(port_tree, jax_tree, **tol):
    """Leaf by leaf, paired by structure (JAX flattens dicts in sorted key
    order, the port in insertion order)."""
    jax.tree.map(lambda a, b: _close(a, b, **tol), _tmap(np.asarray, jax_tree),
                 _tmap(lambda t: t.detach().numpy()
                       if isinstance(t, torch.Tensor) else t, port_tree))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_update_matches_jax(weight_decay):
    """Three steps on the same params and grads (Noam with a short
    warm-up): params and both moments, in a tree with per-layer lists."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    pt = _tmap(torch.from_numpy, _tmap(np.copy, params))
    pj = _tmap(jnp.asarray, params)
    st, sj = adam_init(pt), jax_adam_init(pj)
    kw = dict(weight_decay=weight_decay)
    for _ in range(3):
        g = _tree(rng, 0.1)
        pt, st = adam_update(_tmap(torch.from_numpy, g), st, pt,
                             lr=noam_schedule(64, warmup=4), **kw)
        pj, sj = jax_adam_update(_tmap(jnp.asarray, g), sj, pj,
                                 lr=jax_noam(64, warmup=4), **kw)
    assert st.step == int(sj.step) == 3
    _match((pt, st.mu, st.nu), (pj, sj.mu, sj.nu), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("kw", [{}, dict(warmup=40, factor=1.0)])
def test_noam_schedule_matches_jax(kw):
    port, ref = noam_schedule(256, **kw), jax_noam(256, **kw)
    for step in (0, 1, 2, 39, 40, 41, 1000, 8000, 20000):
        assert port(step) == pytest.approx(
            float(ref(jnp.asarray(step, jnp.int32))), rel=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(np.random.default_rng(2))
    ct, nt = clip_by_global_norm(_tmap(torch.from_numpy, g), max_norm)
    cj, nj = jax_clip(_tmap(jnp.asarray, g), max_norm)
    _close(nt, nj, atol=1e-6, rtol=1e-6)
    _match(ct, cj, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the train step


@pytest.fixture(scope="module")
def setup():
    """Tiny MT params (JAX init plus seeded noise on every leaf, so norms
    and biases are exercised) in both packages, and a training batch of
    synthetic reactions (ragged sources and targets, trailing padding)."""
    ds = SyntheticReactionDataset(48, seed=3)
    vocab = ds.tokenizer.vocab_size
    cfg_j = jax_tiny_config(vocab, depth=2, d_model=64, max_len=MAX_LEN)
    cfg_t = tiny_config(vocab, depth=2, d_model=64, max_len=MAX_LEN)
    rng = np.random.default_rng(0)
    pj = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        jax.tree.map(np.asarray, js2s.init(jax.random.PRNGKey(1), cfg_j)))
    batches = list(batched_dataset(ds.tokenizer, ds.pairs(), 8, 48, 48))
    return ds, cfg_j, cfg_t, pj, batches


def _jax_loss_and_grads(pj, cfg_j, batch, label_smoothing):
    """The loss of the JAX package's ``make_seq2seq_train_step``."""
    def loss_fn(p):
        logits, _ = js2s.apply(p, cfg_j, batch["src"], batch["tgt_in"])
        mask = (batch["tgt_out"] != 0).astype(jnp.float32)
        return jax_ce(logits, batch["tgt_out"], mask=mask,
                      label_smoothing=label_smoothing)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(pj)


def test_train_step_matches_jax(setup):
    """One step, default label smoothing 0.1 and Noam at its default: the
    loss and every gradient leaf (carried back by
    ``seq2seq_params_to_jax``) at 1e-4; then the whole step, whose
    metrics (loss, accuracy, grad norm) and params must agree too (Noam's
    first step is ~1e-7, so params move by less than the tolerance)."""
    ds, cfg_j, cfg_t, pj, batches = setup
    batch = batches[0]
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    (lj, _), gj = _jax_loss_and_grads(jax.tree.map(jnp.asarray, pj), cfg_j,
                                      bj, 0.1)
    pt = seq2seq_params_from_jax(pj, device="cpu")
    lt, _, gt = seq2seq_loss_and_grads(pt, cfg_t, bt, label_smoothing=0.1)
    _close(lt, lj)
    _match(seq2seq_params_to_jax(gt), gj)

    pj1, _, mj = jax.jit(jax_make_step(cfg_j))(
        jax.tree.map(jnp.asarray, pj), jax_adam_init(pj), bj)
    pt1, st, mt = make_seq2seq_train_step(cfg_t)(pt, adam_init(pt), bt)
    assert st.step == 1
    for key in ("loss", "token_accuracy", "tokens", "grad_norm"):
        _close(mt[key], mj[key])
    _match(seq2seq_params_to_jax(pt1), pj1)


def test_loss_trajectory_matches_jax_trainer(setup):
    """Five steps of the port's ``Trainer`` against the JAX ``Trainer``
    from the same params on the same batches, at a real learning rate
    (Noam with a 40-step warm-up): every step's loss at 1e-4."""
    ds, cfg_j, cfg_t, pj, batches = setup
    steps = batches[:5]
    tj = JaxTrainer(cfg_j, jax.tree.map(jnp.asarray, pj), jax_make_step(
        cfg_j, lr=jax_noam(cfg_j.d_model, warmup=40)))
    hj = tj.fit(iter(steps), log_every=1, verbose=False)
    tt = Trainer(cfg_t, seq2seq_params_from_jax(pj, device="cpu"),
                 make_seq2seq_train_step(
                     cfg_t, lr=noam_schedule(cfg_t.d_model, warmup=40)),
                 device="cpu")
    ht = tt.fit(iter(steps), log_every=1, verbose=False)
    assert [set(h) for h in ht] == [set(h) for h in hj]
    np.testing.assert_allclose([h["loss"] for h in ht],
                               [h["loss"] for h in hj], **TOL)
    assert ht[-1]["loss"] < ht[0]["loss"]
    assert all(not p.requires_grad for p in tree_leaves(tt.params))


@pytest.fixture(scope="module")
def trained():
    """A tiny MT trained by the port on the CPU (the JAX package's
    ``test_loss_decreases_on_synthetic_reactions`` set-up, 2 epochs of its
    6): (dataset, cfg, trainer)."""
    ds = SyntheticReactionDataset(256, seed=0)
    cfg = tiny_config(ds.tokenizer.vocab_size, depth=2, d_model=96,
                      max_len=MAX_LEN)
    params = ts2s.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    trainer = Trainer(cfg, params, make_seq2seq_train_step(
        cfg, lr=noam_schedule(cfg.d_model, warmup=40)), device="cpu")

    def batches(epochs=2):
        for _ in range(epochs):
            yield from batched_dataset(ds.tokenizer, ds.pairs(), 16, MAX_LEN,
                                       MAX_LEN)

    trainer.fit(batches(), log_every=8, verbose=False)
    return ds, cfg, trainer


def test_loss_decreases_on_synthetic_reactions(trained):
    _, _, trainer = trained
    hist = trainer.history
    first, last = hist[0]["loss"], hist[-1]["loss"]
    assert last < first * 0.7, (first, last)
    assert hist[-1]["token_accuracy"] > hist[0]["token_accuracy"]


def test_port_trained_params_give_the_same_greedy_tokens_in_jax(trained):
    """Port-trained params, carried back by ``seq2seq_params_to_jax``,
    decode to the same greedy tokens and call counts in the JAX
    ``ReactionEngine`` as in the port's (after 32 steps the model does not
    emit EOS yet: both run the 40 steps)."""
    from repro.configs.mt import tiny_config as jcfg
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving import ReactionEngine as JaxReactionEngine
    from repro_torch.serving import EngineConfig, ReactionEngine

    ds, cfg, trainer = trained
    queries = [ds.pair(i)[0] for i in range(4)]
    kw = dict(mode="greedy", max_new=40, max_src=MAX_LEN)
    port = ReactionEngine(trainer.params, cfg, ds.tokenizer,
                          EngineConfig(**kw), device="cpu").predict(queries)
    pj = jax.tree.map(jnp.asarray, seq2seq_params_to_jax(trainer.params))
    cfg_j = jcfg(ds.tokenizer.vocab_size, depth=2, d_model=96,
                 max_len=MAX_LEN)
    ref = JaxReactionEngine(pj, cfg_j, ds.tokenizer,
                            JaxEngineConfig(**kw)).predict(queries)
    assert [p.smiles for p in port] == [p.smiles for p in ref]
    assert [p.n_calls for p in port] == [p.n_calls for p in ref]


def test_engines_run_trainer_params_without_autograd(trained, monkeypatch):
    """Params that still require grad (the trainer's own) serve under
    ``torch.no_grad()`` in both engines: the encoder never sees grad mode
    on, so no graph is built through the in-place cache writes."""
    from repro_torch.serving import (EngineConfig, ReactionEngine,
                                     StreamingEngine)

    ds, cfg, trainer = trained
    live = trainer._params
    assert all(p.requires_grad for p in tree_leaves(live))
    seen = []
    encode = ts2s.encode

    def spy(*a, **kw):
        seen.append(torch.is_grad_enabled())
        return encode(*a, **kw)

    monkeypatch.setattr(ts2s, "encode", spy)
    q = ds.pair(0)[0]
    ekw = dict(max_new=8, max_src=MAX_LEN, draft_len=3, n_drafts=2,
               n_beams=2)
    for mode in ("greedy", "beam"):
        eng = ReactionEngine(live, cfg, ds.tokenizer,
                             EngineConfig(mode=mode, **ekw), device="cpu")
        out = eng.predict([q]) if mode == "greedy" else eng.predict_topn(q)
        assert out
    eng = StreamingEngine(live, cfg, ds.tokenizer,
                          EngineConfig(mode="speculative", n_slots=2, **ekw),
                          device="cpu")
    h = eng.submit(q)
    assert len(eng.serve()[int(h)].tokens)
    assert seen and not any(seen)
