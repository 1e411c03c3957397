"""The port's decoder-only training (``make_lm_train_step``, ``lm_batch``,
``Trainer`` over the transformer's parameter tree) against the JAX
package's, on every reduced config of JAX's ``ALL_ARCHS``, with the JAX
params carried across by ``repro_torch.bridge``:

- ``lm_batch`` equal to JAX's bit for bit (default separator, an explicit
  one, truncation);
- one train step: the loss, the metrics (accuracy, token count, the MoE
  auxiliary losses, grad norm) and every gradient leaf within 1e-4 of the
  JAX step's (its ``loss_fn``, ``jax.value_and_grad``, its clipping);
- ``remat=True`` gives the logits and gradients of ``remat=False``;
- five steps of the port's ``Trainer`` against the JAX ``Trainer`` on
  reduced SmolLM: every loss within 1e-4.

The train step of the other half of the archs (``SPLIT_ARCHS``) runs in
``test_torch_lm_train_step.py``, so that each file stays near half a
minute on one worker (the JAX gradients are most of the time).

Raw params are not held to each other after a step (Adam's first delta is
about sign(g): a gradient of 1e-12 with opposite signs in the two packages
moves a param by 2·lr); the loss trajectory is held instead. The port runs
on the CPU with one torch thread; JAX runs the gradients eagerly (no
jit), its ``Trainer`` jitted.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import SyntheticReactionDataset as JaxDataset  # noqa: E402
from repro.data.pipeline import lm_batch as jax_lm_batch  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.training import Trainer as JaxTrainer  # noqa: E402
from repro.training import make_lm_train_step as jax_make_step  # noqa: E402
from repro.training.loss import cross_entropy_loss as jax_ce  # noqa: E402
from repro.training.optimizer import clip_by_global_norm as jax_clip  # noqa: E402
from repro_torch.bridge import (transformer_params_from_jax,  # noqa: E402
                                transformer_params_to_jax)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticReactionDataset, lm_batch  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.training import (Trainer, lm_loss_and_grads,  # noqa: E402
                                  make_lm_train_step)
from repro_torch.training.optimizer import adam_init, tree_leaves  # noqa: E402

ALL_ARCHS = [
    "command-r-35b", "qwen3-8b", "llama-3.2-vision-11b", "jamba-v0.1-52b",
    "llama4-maverick-400b-a17b", "starcoder2-15b", "smollm-135m",
    "rwkv6-1.6b", "phi3.5-moe-42b-a6.6b", "hubert-xlarge",
]
# the archs whose train step runs in test_torch_lm_train_step.py
SPLIT_ARCHS = ["command-r-35b", "qwen3-8b", "jamba-v0.1-52b",
               "llama4-maverick-400b-a17b", "starcoder2-15b"]
TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 24


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _open_gates(jp, jcfg):
    """Each cross-attention gate at 0.7 (init leaves it 0, where tanh(0)
    hides the cross-attention and its weights get no gradient)."""
    blocks = list(jp["blocks"])
    for i, kind in enumerate(jcfg.layer_pattern):
        if kind == "xattn":
            blocks[i] = dict(blocks[i], xattn_gate=jnp.full_like(
                blocks[i]["xattn_gate"], 0.7))
    return dict(jp, blocks=tuple(blocks))


def _models(arch):
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jp = _open_gates(jtr.init(jax.random.PRNGKey(1), jcfg), jcfg)
    pt = transformer_params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return jcfg, jp, cfg, pt


def _batch(cfg, B=3, seed=0):
    """numpy training batch: synthetic reactions in ``lm_batch`` layout
    (ragged, trailing padding), the VLM's memory; frames and codebook
    labels for the audio encoder."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"embeddings": (0.1 * rng.standard_normal(
                    (B, MAX_LEN, cfg.d_model))).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (B, MAX_LEN)).astype(np.int32)}
    ds = SyntheticReactionDataset(B, seed=seed)
    batch = lm_batch(ds.tokenizer, list(ds.pairs()), MAX_LEN)
    if cfg.family == "vlm":
        batch["memory"] = (0.1 * rng.standard_normal(
            (B, cfg.memory_tokens, cfg.memory_dim))).astype(np.float32)
    return batch


def _jax_loss_and_grads(jp, jcfg, batch):
    """The loss of the JAX package's ``make_lm_train_step`` (defaults:
    label smoothing 0), its metrics and gradient, eagerly."""
    def loss_fn(p):
        if jcfg.family == "audio":
            logits, aux = jtr.apply(p, jcfg, embeddings=batch["embeddings"])
            labels, mask = batch["labels"], None
        else:
            tokens = batch["tokens"]
            logits, aux = jtr.apply(p, jcfg, tokens[:, :-1],
                                    memory=batch.get("memory"))
            labels, mask = tokens[:, 1:], batch["loss_mask"][:, 1:]
        loss, metrics = jax_ce(logits, labels, mask=mask)
        for k, v in aux.items():
            loss = loss + v
            metrics[k] = v
        return loss, metrics

    (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    _, metrics["grad_norm"] = jax_clip(grads, 1.0)
    return metrics, grads


def test_lm_batch_matches_jax():
    """Bit for bit, with the default separator (eos), an explicit one and
    a max_len that cuts the longer targets."""
    ds, jds = SyntheticReactionDataset(12, seed=5), JaxDataset(12, seed=5)
    assert list(ds.pairs()) == list(jds.pairs())
    for kw in ({"max_len": 96}, {"max_len": 96, "sep_id": 3},
               {"max_len": 30}):
        a = lm_batch(ds.tokenizer, list(ds.pairs()), **kw)
        b = jax_lm_batch(jds.tokenizer, list(jds.pairs()), **kw)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def check_train_step(arch):
    """One ``make_lm_train_step`` step: the loss, every metric and every
    gradient leaf (carried back by ``transformer_params_to_jax``)."""
    jcfg, jp, cfg, pt = _models(arch)
    batch = _batch(cfg)
    mj, gj = _jax_loss_and_grads(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, _, gt = lm_loss_and_grads(pt, cfg, bt)
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, gj))
    flat_t = jax.tree_util.tree_leaves_with_path(
        transformer_params_to_jax(gt))
    assert [k for k, _ in flat_t] == [k for k, _ in flat_j]
    for (path, a), (_, b) in zip(flat_t, flat_j):
        np.testing.assert_allclose(a, b, err_msg=str(path), **TOL)

    params, state, mt = make_lm_train_step(cfg)(pt, adam_init(pt), bt)
    assert state.step == 1 and mt.keys() == mj.keys()
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), err_msg=k,
                                   **TOL)
    assert all(torch.isfinite(p).all() for p in tree_leaves(params))


@pytest.mark.parametrize("arch", [a for a in ALL_ARCHS
                                  if a not in SPLIT_ARCHS])
def test_lm_train_step_matches_jax(arch):
    """One ``make_lm_train_step`` step: the loss, every metric and every
    gradient leaf (carried back by ``transformer_params_to_jax``)."""
    check_train_step(arch)


@pytest.mark.parametrize("arch", ["smollm-135m", "phi3.5-moe-42b-a6.6b",
                                  "jamba-v0.1-52b", "hubert-xlarge"])
def test_remat_matches_no_remat(arch):
    """``remat=True`` recomputes each repeat in the backward: logits, aux
    and every gradient equal to ``remat=False``'s."""
    cfg = get_config(arch, reduced=True)
    params = tr.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    bt = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=1).items()}
    runs = [lm_loss_and_grads(params, cfg, bt, remat=remat)
            for remat in (False, True)]
    (la, ma, ga), (lb, mb, gb) = runs
    assert torch.equal(la, lb) and ma.keys() == mb.keys()
    for a, b in zip(tree_leaves(ga), tree_leaves(gb)):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_loss_trajectory_matches_jax_trainer():
    """Five steps of the port's ``Trainer`` against the JAX ``Trainer``
    on reduced SmolLM from the same params on the same ``lm_batch``
    batches, ``make_lm_train_step``'s defaults (lr 3e-4): every step's
    loss within 1e-4, and the loss falls."""
    jcfg, jp, cfg, pt = _models("smollm-135m")
    ds = SyntheticReactionDataset(40, seed=2)
    pairs = list(ds.pairs())
    steps = [lm_batch(ds.tokenizer, pairs[i:i + 8], 48)
             for i in range(0, 40, 8)]
    hj = JaxTrainer(jcfg, jp, jax_make_step(jcfg)).fit(
        iter(steps), log_every=1, verbose=False)
    trainer = Trainer(cfg, pt, make_lm_train_step(cfg), device="cpu")
    ht = trainer.fit(iter(steps), log_every=1, verbose=False)
    assert [set(h) for h in ht] == [set(h) for h in hj]
    np.testing.assert_allclose([h["loss"] for h in ht],
                               [h["loss"] for h in hj], **TOL)
    assert ht[-1]["loss"] < ht[0]["loss"]
