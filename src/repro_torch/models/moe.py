"""Mixture-of-Experts FFN with capacity-based dispatch, the port of
``repro.models.moe`` (Phi-3.5-MoE: 16 experts, top-2; Llama-4 Maverick:
128 experts, top-1, shared expert; Jamba: 16 experts, top-2 on every
other layer).

The semantics are the JAX package's, drops included. Each expert's
buffer holds ``capacity = max(1, int(top_k * N / E * capacity_factor))``
tokens, with N the call's whole token count (every row, pad and idle rows
too), so a row's output depends on the other rows of the call. A (token,
choice) takes the next free place of its expert's buffer in token-major
order; past capacity it is dropped and carried by the residual stream
(and the shared expert, when there is one). Routing runs in fp32; top-k
is a stable descending sort, so ties go to the lower expert index as
``jax.lax.top_k`` breaks them.

The experts are stacked ``(E, ...)`` weights and run as one ``torch.bmm``
a projection over the whole ``(E, C, d)`` buffer, empty places included,
as the JAX package's ``vmap`` computes them.

On a serving mesh (``repro_torch.sharding.ctx``) a rank holds its data
shard's rows and its model shard's experts, and keeps and drops exactly
the choices the global call keeps and drops. The global call's rows are
shard 0's local rows, then shard 1's, and so on (each group's local slots
are ``[d * per, (d + 1) * per)``, and its chunk lanes follow its slots),
so a choice's global place is its local running count plus the lower
shards' counts for its expert, and the capacity is computed from the
global token count: both from one ``all_reduce`` over the data axis
(``ctx.data_prefix_counts``). A rank fills its own tokens into buffers of
the global capacity for its own experts only, and the outputs (with the
shared expert's partial products) are summed over the model axis.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _normal, dense, dense_init, ffn_init
from repro_torch.sharding import ctx


class DropCount:
    """The kept and all (token, choice) pairs of the ``moe_ffn`` calls made
    while ``count_drops`` is open (the global call's, on a mesh), summed
    on the device and read once by ``fraction``."""

    def __init__(self):
        self._kept = []
        self._choices = 0

    def add(self, kept: torch.Tensor, choices: int) -> None:
        self._kept.append(kept)
        self._choices += choices

    def fraction(self) -> float | None:
        """The dropped fraction of every counted choice (None: no call)."""
        if not self._choices:
            return None
        return 1.0 - float(torch.stack(self._kept).sum()) / self._choices


_state = threading.local()


@contextlib.contextmanager
def count_drops():
    """Count the dropped choices of every ``moe_ffn`` call on this thread
    while open; yields the ``DropCount``."""
    prev = getattr(_state, "count", None)
    _state.count = DropCount()
    try:
        yield _state.count
    finally:
        _state.count = prev


def moe_init(gen, cfg: ModelConfig, *, device) -> dict:
    m = cfg.moe
    d, dff, E = cfg.d_model, m.d_ff, m.n_experts
    p = {"router": dense_init(gen, d, E, use_bias=False, device=device),
         # stacked (E, d_in, d_out) leaves: the JAX package's vmap'd init
         "experts": {name: {"w": _normal(gen, (E, d_in, d_out),
                                         d_in ** -0.5, device)}
                     for name, d_in, d_out in (("w_in", d, dff),
                                               ("w_out", dff, d),
                                               ("w_gate", d, dff))}}
    if m.shared_expert:
        p["shared"] = ffn_init(gen, d, dff, use_bias=False, gated=True,
                               device=device)
    return p


def moe_route(p: dict, cfg: ModelConfig, tokens: torch.Tensor) -> dict:
    """The router of ``moe_ffn`` for tokens (N, d): fp32 logits and
    probabilities, the renormalised top-k gates and their experts (N, k),
    each choice's place in its expert's buffer (N, k), ``keep`` (N, k)
    (the place is below ``capacity``) and ``capacity``; ``counts`` (E,)
    the global call's choices an expert, ``top1`` (E,) its top choices an
    expert and ``n_global`` its token count. On a data-split mesh the
    places, ``capacity`` and these counts are the global call's."""
    m = cfg.moe
    n_tok = tokens.shape[0]
    E, k = m.n_experts, m.top_k
    logits = (tokens @ p["router"]["w"]).float()                  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :k], idx[:, :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    # place of each (token, choice) in its expert's buffer: a token-major
    # running count over the flattened (N*k, E) one-hot, after the lower
    # data shards' choices of the same expert
    flat = F.one_hot(gate_idx.reshape(-1), E).to(torch.int32)
    mine = torch.cat([flat.sum(0), F.one_hot(gate_idx[:, 0], E).sum(0)])
    before, total, n_global = ctx.data_prefix_counts(mine.long(), n_tok)
    capacity = max(1, int(k * n_global / E * m.capacity_factor))
    place = ((torch.cumsum(flat, dim=0, dtype=torch.int32)
              + before[:E].to(torch.int32)) * flat - 1)
    pos = place.reshape(n_tok, k, E).amax(-1)                    # (N, k)
    return dict(logits=logits, probs=probs, gate_vals=gate_vals,
                gate_idx=gate_idx, pos=pos, keep=pos < capacity,
                capacity=capacity, counts=total[:E], top1=total[E:2 * E],
                n_global=n_global)


def _expert_ffn(w: dict, x: torch.Tensor) -> torch.Tensor:
    """Every expert's gated FFN over its buffer: x (E, C, d) -> (E, C, d)."""
    h = torch.bmm(x, w["w_in"]["w"])
    h = F.silu(torch.bmm(x, w["w_gate"]["w"])) * h
    return torch.bmm(h, w["w_out"]["w"])


def _shared_partial(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The shared expert's gated FFN before its ``w_out`` sum over the
    model axis (its hidden dim split there, or whole); no bias."""
    w = p["w_out"]["w"]
    h = F.silu(dense(p["w_gate"], x)) * dense(p["w_in"], x)
    return ctx.row_input(w, h) @ w


def moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor
            ) -> tuple[torch.Tensor, dict]:
    """x: (B, T, d) -> (out (B, T, d), aux): the load-balance loss, the
    router z-loss, the dropped fraction of choices and the top-1 fraction,
    as the JAX package returns them. On a data-split mesh the two
    fractions are the global call's; the two losses (training's, which
    does not run on a mesh) are this shard's rows'."""
    m = cfg.moe
    B, T, d = x.shape
    E = m.n_experts
    tokens = x.reshape(B * T, d)
    n_tok = B * T
    r = moe_route(p, cfg, tokens)
    C, keep, gate_idx = r["capacity"], r["keep"], r["gate_idx"]
    # this rank's experts [e0, e0 + E_local): all of them unless the
    # experts are split over the model axis
    w_in = p["experts"]["w_in"]["w"]
    e0, E_local = ctx.expert_offset(w_in), w_in.shape[0]
    local = gate_idx - e0
    here = keep & (local >= 0) & (local < E_local)
    kept = here.to(tokens.dtype)[..., None]                      # (N, k, 1)
    slot = torch.where(here, r["pos"], C)                        # C = drop
    local = torch.where(here, local, 0)
    # dispatch: kept places are unique, so the accumulate is a plain write
    # (dropped choices pile up in place C, which is sliced off)
    buf = tokens.new_zeros((E_local, C + 1, d))
    buf.index_put_((local, slot), tokens[:, None, :] * kept,
                   accumulate=True)
    out_e = _expert_ffn(p["experts"], buf[:, :C])          # (E_local, C, d)
    gathered = out_e[local, slot.clamp(max=C - 1)]               # (N, k, d)
    out = (gathered * kept
           * r["gate_vals"][..., None].to(tokens.dtype)).sum(1)  # (N, d)
    split = ctx.expert_split(w_in)
    if "shared" in p:
        w = p["shared"]["w_out"]["w"]
        sh = _shared_partial(p["shared"], tokens)
        if split and ctx.row_split(w):
            out = ctx.model_sum(out + sh)        # one sum for both
        else:
            out = (ctx.model_sum(out) if split else out) + ctx.row_reduce(
                w, sh)
    elif split:
        out = ctx.model_sum(out)

    n_glob = max(r["n_global"], 1)
    frac_tokens = r["top1"].float().mean() / n_glob
    aux_loss = E * (F.one_hot(gate_idx[:, 0], E).float().mean(0)
                    * r["probs"].mean(0)).sum() * m.aux_loss_weight
    z_loss = (torch.logsumexp(r["logits"], dim=-1) ** 2).mean() \
        * m.router_z_loss
    kept_all = r["counts"].clamp(max=C).sum()
    count = getattr(_state, "count", None)
    if count is not None:
        count.add(kept_all, n_glob * m.top_k)
    aux = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
           "moe_dropped_frac": 1.0 - kept_all.float() / (n_glob * m.top_k),
           "moe_top1_frac": frac_tokens}
    return out.reshape(B, T, d), aux
