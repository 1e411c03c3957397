"""RWKV6 "Finch" time-mix with data-dependent decay, and the RWKV
channel-mix: the port of ``repro.models.rwkv``.

Per head (size ``hd``), with receptance r, key k, value v, decay w and
bonus u:

    S_t = diag(exp(-exp(w_t))) S_{t-1} + k_t^T v_t          (hd x hd state)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

The decay is data-dependent (a low-rank LoRA on the token-shifted input).
Token shift mixes x_{t-1} into the r/k/v/w/g projections with learned
per-channel weights. The state update is a loop over time, as the JAX
package's ``lax.scan`` is. Channel-mix is the squared-relu FFN with its
own token shift.

On a serving mesh a rank holds its model shard's heads: ``wr / wk / wv /
wg``'s columns and ``u``'s rows of them. Where the heads do not divide
the model axis, ``wk`` / ``wv`` and ``u`` stay whole and the split ``r``
and ``g`` are gathered whole (``ctx.model_gather``, exact): every rank
then runs every head. The decay is computed whole from the replicated
``w_base`` and LoRA, then cut to the rank's heads. ``ln_x`` is a
LayerNorm over the whole width, not a norm per head, so the rank's ``o``
is gathered whole, normalised exactly as unsharded, and cut back to the
rank's channels for ``o * g``; ``wo`` and the channel mix's ``w_out``
are reduced. Under autograd each split projection's input, the decay and
the normalised ``o`` enter the rank's heads through ``ctx.enter`` (the
decay and ``o`` inside ``ctx.model_slice``), so the replicated mixes,
LoRA and ``ln_x`` get their whole gradients. On a residual stream split
along T both mixes run on the gathered sequence (the token shift and the
WKV need every position); ``wo``'s and ``w_out``'s sums are then
reduce-scatters along T (``layers.dense_row``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (_normal, _uniform, apply_norm, dense,
                                       dense_init, dense_row, norm_init)
from repro_torch.sharding import ctx


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    hd = cfg.rwkv.head_dim
    assert cfg.d_model % hd == 0
    return cfg.d_model // hd, hd


def rwkv_init(gen, cfg: ModelConfig, *, device) -> dict:
    d = cfg.d_model
    H, hd = _heads(cfg)
    lora = max(32, d // 16)
    kw = dict(use_bias=False, device=device)
    return {
        # token-shift interpolation weights (one row per projection)
        "mix": _uniform(gen, (5, d), 0.25, 0.75, device),
        "wr": dense_init(gen, d, d, **kw),
        "wk": dense_init(gen, d, d, **kw),
        "wv": dense_init(gen, d, d, **kw),
        "wg": dense_init(gen, d, d, **kw),
        # data-dependent decay: w_t = w_base + lora
        "w_base": torch.full((d,), -5.0, device=device),
        "w_lora_a": dense_init(gen, d, lora, **kw),
        "w_lora_b": dense_init(gen, lora, d, scale=1.0 / math.sqrt(lora),
                               **kw),
        "u": _normal(gen, (H, hd), 0.1, device),
        "wo": dense_init(gen, d, d, **kw),
        "ln_x": norm_init(d, "layernorm", device),
    }


def _shift(x, x_last):
    """x shifted one step right along time, ``x_last`` (B, d) in front."""
    return torch.cat([x_last[:, None, :], x[:, :-1, :]], dim=1)


def _into(w: dict, x):
    """``x``, the input of the square projection ``w``: through
    ``ctx.enter`` where ``w``'s columns are the rank's own (a split)."""
    return ctx.enter(x) if w["w"].shape[1] < w["w"].shape[0] else x


def _projections(p, x, x_prev):
    """Token-shifted projections. x, x_prev: (B, T, d)."""
    mix = p["mix"]
    xr, xk, xv, xw, xg = (x * mix[i] + x_prev * (1 - mix[i]) for i in range(5))
    k = dense(p["wk"], _into(p["wk"], xk))
    v = dense(p["wv"], _into(p["wv"], xv))
    # r and g at k's heads: gathered whole where wk stays whole
    r = ctx.model_gather(dense(p["wr"], _into(p["wr"], xr)), k.shape[-1])
    g = F.silu(ctx.model_gather(dense(p["wg"], _into(p["wg"], xg)),
                                k.shape[-1]))
    w = p["w_base"] + dense(p["w_lora_b"], torch.tanh(dense(p["w_lora_a"],
                                                            xw)))
    decay = torch.exp(-torch.exp(w.float()))               # (B, T, d) in (0, 1)
    return r, k, v, g, ctx.model_slice(decay, k.shape[-1])


def _wkv_recurrence(r, k, v, decay, u, S, states_out=None):
    """The WKV loop over time: r, k, v, decay (B, T, H, hd), the bonus u,
    the state S (B, H, hd, hd). Returns (out (B, T, H, hd) fp32, the final
    state); ``states_out`` (B, T, H, hd, hd) receives the state after each
    token."""
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # (B, H, hd, hd)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S + u * kv))
        S = decay[:, t, :, :, None] * S + kv
        if states_out is not None:
            states_out[:, t] = S
    return torch.stack(outs, dim=1), S


def rwkv_mixer(p: dict, cfg: ModelConfig, x, *, state=None, x_last=None,
               lengths=None, states_out=None):
    """Time-mix over a sequence (prefill) or its continuation (decode).

    x: (B, T, d). ``state``: (B, H, hd, hd) carried WKV state (a mesh
    rank's own heads); ``x_last``: (B, d) the previous token's input (the
    token-shift seam). ``lengths`` makes right-pad steps identity updates
    (decay 1, kv 0), so the final state is each row's state at its true
    end. Returns (out, (state, x[:, -1])); ``states_out`` (B, T, H, hd, hd)
    also receives the state after each token.
    """
    B, T, d = x.shape
    hd = cfg.rwkv.head_dim
    if x_last is None:
        x_last = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    r, k, v, g, decay = _projections(p, x, _shift(x, x_last))
    H = r.shape[-1] // hd                  # the heads this rank holds
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                            device=x.device)
    if lengths is not None:
        valid = (torch.arange(T, device=x.device)[None, :]
                 < lengths[:, None])[..., None]
        decay = torch.where(valid, decay, 1.0)     # pad steps: S_t = S_{t-1}
        k = k * valid.to(k.dtype)                  # pad steps: kv = 0
    r, k, v = (t.reshape(B, T, H, hd).float() for t in (r, k, v))
    decay = decay.reshape(B, T, H, hd)
    u = p["u"].float()[None, :, :, None]
    o, S = _wkv_recurrence(r, k, v, decay, u, state, states_out)
    o = o.reshape(B, T, H * hd).to(x.dtype)
    o = apply_norm(p["ln_x"], ctx.model_gather(o, d), "layernorm")
    out = dense_row(p["wo"], ctx.model_slice(o, g.shape[-1]) * g)
    return out, (S, x[:, -1, :])


# channel-mix (the RWKV FFN): squared relu with token shift -----------------


def rwkv_channel_init(gen, cfg: ModelConfig, *, device) -> dict:
    kw = dict(use_bias=False, device=device)
    return {"mix_c": _uniform(gen, (1, cfg.d_model), 0.25, 0.75, device),
            "w_in": dense_init(gen, cfg.d_model, cfg.d_ff, **kw),
            "w_out": dense_init(gen, cfg.d_ff, cfg.d_model, **kw)}


def rwkv_channel_mix(p: dict, x, *, x_last=None):
    """x: (B, T, d) -> (out, x[:, -1])."""
    B, T, d = x.shape
    if x_last is None:
        x_last = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    mix = p["mix_c"][0]
    xk = x * mix + _shift(x, x_last) * (1 - mix)
    if ctx.row_split(p["w_out"]["w"]):   # the hidden dim split
        xk = ctx.enter(xk)
    h = torch.square(torch.relu(dense(p["w_in"], xk)))
    return dense_row(p["w_out"], h), x[:, -1, :]
