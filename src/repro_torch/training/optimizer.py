"""Adam (+ the Noam warm-up schedule) as plain functions over the port's
param tree (dicts with per-layer lists): the port of
``repro.training.optimizer``, with the JAX package's formula — b1 0.9,
b2 0.998, eps 1e-9, bias-corrected ``mhat`` / ``vhat``, weight decay added
to the delta, fp32 moments. ``torch.optim.Adam`` differs in its arithmetic
and its weight decay, so it is not used.

Unlike the JAX package, ``adam_update`` updates the params and the moments
IN PLACE (and returns them), with ``torch._foreach_*`` ops: a handful of
launches per step for the ~170 leaves of mt-product, where a loop over the
leaves would cost over a thousand. The step count and the learning rate
stay Python numbers, so an update reads nothing from the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.sharding import ctx


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, depth first, in insertion
    order (trees built alike flatten alike)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """Leaves (in ``tree_leaves`` order) back into the structure of
    ``like``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


class AdamState(NamedTuple):
    step: int
    mu: dict
    nu: dict


def adam_init(params) -> AdamState:
    z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_leaves(params)
    return AdamState(step=0, mu=tree_unflatten(params, [z(p) for p in leaves]),
                     nu=tree_unflatten(params, [z(p) for p in leaves]))


@torch.no_grad()
def adam_update(grads, state: AdamState, params, *, lr, b1=0.9, b2=0.998,
                eps=1e-9, weight_decay: float = 0.0):
    """``lr`` may be a number or a callable(step) (e.g. ``noam_schedule``).
    ``grads``: a tree shaped like ``params``, or its leaves as a list.
    Updates ``params`` and the state's moments in place; returns
    (params, AdamState with the new step)."""
    step = state.step + 1
    lr_t = float(lr(step) if callable(lr) else lr)
    b1t = 1.0 - b1 ** step
    b2t = 1.0 - b2 ** step
    p_ = tree_leaves(params)
    g_ = [g.float() for g in tree_leaves(grads)]
    m_, v_ = tree_leaves(state.mu), tree_leaves(state.nu)
    if not len(p_) == len(g_) == len(m_) == len(v_):
        raise ValueError(f"adam_update: {len(p_)} params, {len(g_)} grads, "
                         f"{len(m_)}/{len(v_)} moments")
    torch._foreach_mul_(m_, b1)                      # m = b1 m + (1-b1) g
    torch._foreach_add_(m_, g_, alpha=1 - b1)
    torch._foreach_mul_(v_, b2)                      # v = b2 v + (1-b2) g^2
    torch._foreach_addcmul_(v_, g_, g_, value=1 - b2)
    delta = torch._foreach_div(m_, b1t)              # mhat
    denom = torch._foreach_div(v_, b2t)              # vhat
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(delta, denom)
    if weight_decay:
        torch._foreach_add_(delta, [p.float() for p in p_],
                            alpha=weight_decay)
    torch._foreach_add_(p_, [d.to(p.dtype) for d, p in zip(delta, p_)],
                        alpha=-lr_t)
    return params, AdamState(step=step, mu=state.mu, nu=state.nu)


def noam_schedule(d_model: int, warmup: int = 8000, factor: float = 2.0):
    """The Molecular Transformer's LR schedule (Vaswani 2017 / Schwaller
    2019): a function of the step (a Python int) returning a float."""

    def lr(step):
        s = max(float(step), 1.0)
        return factor * d_model ** -0.5 * min(s ** -0.5, s * warmup ** -1.5)

    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (fp32), a device scalar.

    On a world rank (``sharding.ctx``: its leaves are its shards) the sum
    runs over the whole params: each leaf's squared norm is summed over
    the axes the leaf is split over, and counted once over an axis it is
    whole on (the rank at index 0 of that axis counts it), by one
    model-axis and one data-axis sum of a scalar. A plan's recorder,
    which has no param layout, records the same two sums."""
    leaves = tree_leaves(tree)
    norms = torch._foreach_norm([x.float() for x in leaves])
    tp = ctx.current()
    if tp is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    mine = [n for n, (data, model) in zip(norms, ctx.leaf_axes(tree))
            if (data or tp.data_rank == 0) and (model or tp.rank == 0)]
    sq = (torch.stack(mine).square().sum() if mine
          else norms[0].new_zeros(()))
    return ctx.data_total(ctx.model_total(sq)).sqrt()


def clip_by_global_norm(grads, max_norm: float):
    """Returns (grads scaled by min(1, max_norm / (norm + 1e-9)), norm),
    the grads in the same structure, the scale applied on the card."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    leaves = torch._foreach_mul(tree_leaves(grads), scale)
    return tree_unflatten(grads, leaves), norm
