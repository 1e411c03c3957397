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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _normal, dense_init, ffn, ffn_init


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
    (the place is below ``capacity``) and ``capacity``."""
    m = cfg.moe
    n_tok = tokens.shape[0]
    E, k = m.n_experts, m.top_k
    logits = (tokens @ p["router"]["w"]).float()                  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :k], idx[:, :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    capacity = max(1, int(k * n_tok / E * m.capacity_factor))
    # place of each (token, choice) in its expert's buffer: a token-major
    # running count over the flattened (N*k, E) one-hot
    flat = F.one_hot(gate_idx.reshape(-1), E).to(torch.int32)
    place = torch.cumsum(flat, dim=0, dtype=torch.int32) * flat - 1
    pos = place.reshape(n_tok, k, E).amax(-1)                    # (N, k)
    return dict(logits=logits, probs=probs, gate_vals=gate_vals,
                gate_idx=gate_idx, pos=pos, keep=pos < capacity,
                capacity=capacity)


def _expert_ffn(w: dict, x: torch.Tensor) -> torch.Tensor:
    """Every expert's gated FFN over its buffer: x (E, C, d) -> (E, C, d)."""
    h = torch.bmm(x, w["w_in"]["w"])
    h = F.silu(torch.bmm(x, w["w_gate"]["w"])) * h
    return torch.bmm(h, w["w_out"]["w"])


def moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor
            ) -> tuple[torch.Tensor, dict]:
    """x: (B, T, d) -> (out (B, T, d), aux): the load-balance loss, the
    router z-loss, the dropped fraction of choices and the top-1 fraction,
    as the JAX package returns them."""
    m = cfg.moe
    B, T, d = x.shape
    E = m.n_experts
    tokens = x.reshape(B * T, d)
    n_tok = B * T
    r = moe_route(p, cfg, tokens)
    C, keep, gate_idx = r["capacity"], r["keep"], r["gate_idx"]
    kept = keep.to(tokens.dtype)[..., None]                      # (N, k, 1)
    slot = torch.where(keep, r["pos"], C)                        # C = drop
    # dispatch: kept places are unique, so the accumulate is a plain write
    # (dropped choices pile up in place C, which is sliced off)
    buf = tokens.new_zeros((E, C + 1, d))
    buf.index_put_((gate_idx, slot), tokens[:, None, :] * kept,
                   accumulate=True)
    out_e = _expert_ffn(p["experts"], buf[:, :C])                # (E, C, d)
    gathered = out_e[gate_idx, slot.clamp(max=C - 1)]            # (N, k, d)
    out = (gathered * kept
           * r["gate_vals"][..., None].to(tokens.dtype)).sum(1)  # (N, d)
    if "shared" in p:
        out = out + ffn(p["shared"], tokens)

    top1 = F.one_hot(gate_idx[:, 0], E).float()
    frac_tokens = top1.sum(0).mean() / max(n_tok, 1)
    aux_loss = E * (top1.mean(0) * r["probs"].mean(0)).sum() \
        * m.aux_loss_weight
    z_loss = (torch.logsumexp(r["logits"], dim=-1) ** 2).mean() \
        * m.router_z_loss
    aux = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
           "moe_dropped_frac": 1.0 - keep.float().mean(),
           "moe_top1_frac": frac_tokens}
    return out.reshape(B, T, d), aux
