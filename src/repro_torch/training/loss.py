"""Cross-entropy with label smoothing (the Molecular Transformer's training
set-up): the port of ``repro.training.loss``."""

from __future__ import annotations

import torch

from repro_torch.sharding import ctx


def cross_entropy_loss(logits, labels, *, mask=None,
                       label_smoothing: float = 0.0):
    """logits: (..., V); labels: (...) int; mask: (...) 1.0 = count.

    Returns (mean loss over masked tokens, metrics dict). The metrics are
    detached device tensors (no host read): ``loss``, ``token_accuracy``
    (argmax, the first index wins ties) and ``tokens`` (the denominator,
    ``max(sum mask, 1)``).

    On a world rank whose rows are one data shard of a global batch
    (``sharding.ctx``) the denominator is the global masked-token count,
    one data-axis sum, so the loss and the accuracy are this shard's parts
    of the global means: they sum to them over the data shards (the train
    step sums the metrics)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lp, -1, labels.long()[..., None])[..., 0]
    if label_smoothing > 0.0:
        smooth = -lp.mean(-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = ctx.data_total(mask.sum()).clamp(min=1.0)
    loss = (nll * mask).sum() / denom
    hit = (torch.argmax(lp, -1) == labels.long()).float()
    acc = (hit * mask).sum() / denom
    return loss, {"loss": loss.detach(), "token_accuracy": acc.detach(),
                  "tokens": denom.detach()}
