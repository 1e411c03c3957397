"""Train steps and a host-side Trainer loop: the port of
``repro.training.trainer``.

``make_seq2seq_train_step`` (the Molecular Transformer) and
``make_lm_train_step`` (the decoder-only and audio architectures) return
``(params, opt_state, batch) -> (params, opt_state, metrics)`` like the JAX
package's, eager: autograd through ``seq2seq.apply`` / ``transformer.apply``
(their full-sequence self-attention runs the ``flash_attention`` kernels
forward and backward on the card), clipping and Adam with
``torch._foreach_*`` ops. Where JAX donates the buffers, the port updates
params and moments in place; the metrics stay on the device until the
``Trainer`` reads them on a logging step.

On a world rank (a built step on a ``DeviceMesh``, ``launch.steps``) the
params are the rank's shards: the step runs the layers on them with the
FSDP leaves gathered over the data axis (``ctx.layers_params``), takes
its gradients there (the layers' tensor-parallel backward sums over the
model axis), reduces them over the data axis in tree order, sums its
metrics there, clips by the global norm of the whole params and runs
Adam on its shards: its part of what the one-rank step computes.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Iterable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import seq2seq as s2s
from repro_torch.models import transformer as tr
from repro_torch.sharding import ctx
from repro_torch.training.loss import cross_entropy_loss
from repro_torch.training.optimizer import (AdamState, adam_init,
                                            adam_update, clip_by_global_norm,
                                            noam_schedule, tree_leaves,
                                            tree_unflatten)


def seq2seq_loss_and_grads(params, cfg: ModelConfig, batch: dict, *,
                           label_smoothing: float = 0.1):
    """The seq2seq loss on ``batch`` (``src``, ``tgt_in``, ``tgt_out``;
    pad 0 is not counted) and its gradient. Returns (loss, metrics, grads
    shaped like ``params``); the param leaves are set to require grad."""
    with torch.enable_grad():
        for p in tree_leaves(params):
            p.requires_grad_(True)
        run = ctx.layers_params(params)
        logits, _ = s2s.apply(run, cfg, batch["src"], batch["tgt_in"])
        mask = (batch["tgt_out"] != 0).float()
        loss, metrics = cross_entropy_loss(logits, batch["tgt_out"], mask=mask,
                                           label_smoothing=label_smoothing)
        grads = torch.autograd.grad(loss, tree_leaves(run))
    return loss.detach(), metrics, tree_unflatten(params, list(grads))


def _grads_seen():
    return getattr(_capture, "grads", None)


_capture = threading.local()


@contextlib.contextmanager
def capture_grads():
    """While open, each train step on this thread appends its gradients
    after the data-axis reduction and before the clip (detached copies, in
    tree order) to the yielded list: a world rank's against the one-rank
    step's."""
    prev = _grads_seen()
    _capture.grads = out = []
    try:
        yield out
    finally:
        _capture.grads = prev


def _reduced(grads, metrics):
    """A world rank's gradients (of the params its layers ran) reduced over
    the data axis in tree order (``ctx.reduce_gradients``), and its
    metrics summed there (one collective: this shard's parts of the global
    means; ``tokens`` is global already). As they are on one rank."""
    grads = ctx.reduce_gradients(grads)
    keys = [k for k in metrics if k != "tokens"]
    total = ctx.data_total(torch.stack([metrics[k].float() for k in keys]))
    metrics = dict(metrics, **{k: total[i] for i, k in enumerate(keys)})
    seen = _grads_seen()
    if seen is not None:
        seen.append([g.detach().clone() for g in tree_leaves(grads)])
    return grads, metrics


def make_seq2seq_train_step(cfg: ModelConfig, *,
                            label_smoothing: float = 0.1, lr=None,
                            max_grad_norm: float = 1.0) -> Callable:
    """Noam (``noam_schedule(cfg.d_model)``) unless ``lr`` is given."""
    lr = lr if lr is not None else noam_schedule(cfg.d_model)

    def train_step(params, opt_state: AdamState, batch):
        _, metrics, grads = seq2seq_loss_and_grads(
            params, cfg, batch, label_smoothing=label_smoothing)
        grads, metrics = _reduced(grads, metrics)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        params, opt_state = adam_update(grads, opt_state, params, lr=lr)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step


def lm_loss_and_grads(params, cfg: ModelConfig, batch: dict, *,
                      label_smoothing: float = 0.0, remat: bool = False):
    """The decoder-only loss on ``batch`` and its gradient. Tokens (batch
    ``tokens``, ``loss_mask``; the VLM also ``memory``): ``tokens[:, :-1]``
    in, ``tokens[:, 1:]`` the labels under ``loss_mask[:, 1:]``. Audio
    (``embeddings``, ``labels``): frames in, every label counted. The
    model's auxiliary losses (MoE) are added to the loss and reported in
    the metrics. Returns (loss, metrics, grads shaped like ``params``); the
    param leaves are set to require grad."""
    with torch.enable_grad():
        for p in tree_leaves(params):
            p.requires_grad_(True)
        run = ctx.layers_params(params)
        if cfg.family == "audio":
            logits, aux = tr.apply(run, cfg,
                                   embeddings=batch["embeddings"],
                                   remat=remat)
            labels, mask = batch["labels"], None
        else:
            tokens = batch["tokens"]
            logits, aux = tr.apply(run, cfg, tokens[:, :-1],
                                   memory=batch.get("memory"), remat=remat)
            labels = tokens[:, 1:]
            mask = batch["loss_mask"][:, 1:]
        loss, metrics = cross_entropy_loss(logits, labels, mask=mask,
                                           label_smoothing=label_smoothing)
        for k, v in aux.items():
            loss = loss + v
            metrics[k] = v.detach()
        grads = torch.autograd.grad(loss, tree_leaves(run))
    return loss.detach(), metrics, tree_unflatten(params, list(grads))


def make_lm_train_step(cfg: ModelConfig, *, label_smoothing: float = 0.0,
                       lr=3e-4, max_grad_norm: float = 1.0,
                       remat: bool = False) -> Callable:
    """Decoder-only LM step (every decoder-only arch and the audio
    encoder). Batch keys: tokens (B, T) and loss_mask (B, T), the VLM's
    memory (B, M, memory_dim); audio: embeddings and labels."""

    def train_step(params, opt_state: AdamState, batch):
        _, metrics, grads = lm_loss_and_grads(
            params, cfg, batch, label_smoothing=label_smoothing, remat=remat)
        grads, metrics = _reduced(grads, metrics)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        params, opt_state = adam_update(grads, opt_state, params, lr=lr)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step


def _detached(tree):
    return tree_unflatten(tree, [p.detach() for p in tree_leaves(tree)])


class Trainer:
    """Host loop: iterate batches, step, collect metrics.

    ``device``: where training runs; ``None`` means the card, and a missing
    card is an error. The trainer trains its own copy of ``params`` on that
    device (the caller's tensors are not changed)."""

    def __init__(self, cfg: ModelConfig, params, train_step: Callable, *,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._params = tree_unflatten(params, [
            p.detach().to(self.device, copy=True).requires_grad_(True)
            for p in tree_leaves(params)])
        self.opt_state = adam_init(self._params)
        self._step = train_step
        self.history: list[dict] = []

    @property
    def params(self):
        """The current params as detached tensors (views of the trainer's,
        which later steps update in place)."""
        return _detached(self._params)

    def fit(self, batches: Iterable[dict], *, log_every: int = 50,
            verbose: bool = True) -> list[dict]:
        """Metrics are read to the host only on every ``log_every``-th step
        (the history has the JAX Trainer's keys: the step's metrics, then
        ``step`` and ``wall_s``)."""
        t0 = time.time()
        for i, batch in enumerate(batches):
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in batch.items()}
            self._params, self.opt_state, metrics = self._step(
                self._params, self.opt_state, batch)
            if i % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = i
                m["wall_s"] = time.time() - t0
                self.history.append(m)
                if verbose:
                    print(f"step {i:5d} loss {m['loss']:.4f} "
                          f"acc {m['token_accuracy']:.3f} ({m['wall_s']:.1f}s)")
        return self.history
