"""Mamba (selective SSM) mixer, the recurrent half of Jamba's 1:7
interleave: the port of ``repro.models.mamba`` (Mamba-1 as Jamba uses it).

    x -> in-proj to (x, z) of width d_inner = expand * d_model
      -> depthwise causal conv (d_conv) -> silu
      -> selective SSM: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t;
         y_t = C_t h_t + D x_t
      -> y * silu(z) -> out-proj

The JAX package evaluates the full-sequence recurrence with
``lax.associative_scan``; here ``_scan_ssm`` is a plain loop over time
that computes the same recurrence (its sums round in another order, so
the two agree to fp32 rounding, not bitwise). Decoding (``mamba_step``)
is the same sequential update as the JAX package's, with the conv and the
selective projections of its T tokens computed at once (they read the
inputs and the conv window, never the SSM state); only the state update
loops over time.

On a serving mesh a rank holds its model shard's ``d_inner`` channels:
its x- and z-columns of ``w_in`` (``launch.shardings``), the conv, ``A``,
``D`` and ``w_dt``'s columns of them; ``w_xdbc`` is row-parallel, so its
``dt / B / C`` projection is summed over the model axis before the split
(``dt_rank`` and ``d_state`` stay whole), and ``w_out`` is reduced. The
conv and the scan are per channel and need no collective. Under autograd
the block's input and the summed ``dt / B / C`` enter the rank's channels
through ``ctx.enter``. On a residual stream split along T the mixer runs on
the gathered sequence (the conv and the scan need every position);
``w_out``'s sum is then a reduce-scatter along T (``layers.dense_row``),
``w_xdbc``'s stays a sum.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _normal, dense, dense_init, dense_row
from repro_torch.sharding import ctx


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return d_inner, m.d_state, m.d_conv, dt_rank


def mamba_init(gen, cfg: ModelConfig, *, device) -> dict:
    d_inner, d_state, d_conv, dt_rank = _dims(cfg)
    A = torch.arange(1, d_state + 1, dtype=torch.float32).repeat(d_inner, 1)
    return {
        "w_in": dense_init(gen, cfg.d_model, 2 * d_inner, use_bias=False,
                           device=device),
        "conv_w": _normal(gen, (d_conv, d_inner), 1.0 / math.sqrt(d_conv),
                          device),
        "conv_b": torch.zeros((d_inner,), device=device),
        # selective projections: x -> (dt rank, B, C)
        "w_xdbc": dense_init(gen, d_inner, dt_rank + 2 * d_state,
                             use_bias=False, device=device),
        "w_dt": dense_init(gen, dt_rank, d_inner, use_bias=True,
                           device=device),
        # A log-parameterised negative real; D the skip
        "A_log": torch.log(A).to(device),
        "D": torch.ones((d_inner,), device=device),
        "w_out": dense_init(gen, d_inner, cfg.d_model, use_bias=False,
                            device=device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _conv_full(p, x):
    """Causal depthwise conv over x (B, T, d_inner)."""
    d_conv, T = p["conv_w"].shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, d_conv - 1, 0))
    out = sum(pad[:, i:i + T, :] * p["conv_w"][i] for i in range(d_conv))
    return out + p["conv_b"]


def _ssm_inputs(p, xc):
    """xc (B, T, d_inner) post-conv activations -> dt (B, T, d_inner) and
    the selective B, C (B, T, d_state) (a row-split ``w_xdbc``'s partial
    products summed over the model axis first)."""
    d_state = p["A_log"].shape[1]
    w = p["w_xdbc"]["w"]
    dt_rank = w.shape[1] - 2 * d_state
    xdbc = ctx.row_reduce(w, ctx.row_input(w, xc) @ w)   # no bias
    if ctx.row_split(w):   # whole, into the rank's channels
        xdbc = ctx.enter(xdbc)
    dt, Bsel, Csel = torch.split(xdbc, [dt_rank, d_state, d_state], dim=-1)
    return _softplus(dense(p["w_dt"], dt)), Bsel, Csel


def _recurrence(a, b, C):
    """The scan's loop over time: h_t = a_t * h_{t-1} + b_t from h = 0
    (a, b (B, T, d_inner, d_state)), y_t = h_t C_t (C (B, T, d_state)).
    Returns (y (B, T, d_inner), h_final)."""
    h = torch.zeros_like(a[:, 0])
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(torch.einsum("bds,bs->bd", h, C[:, t]))
    return torch.stack(ys, dim=1), h


def _scan_ssm(p, xc, valid=None):
    """h_t = a_t * h_{t-1} + b_t (per d_inner x d_state) from h = 0, a
    loop over time. ``valid`` (B, T) makes pad steps identity updates
    (a = 1, b = 0), so the final state is each row's state at its true
    end. Returns (y, h_final)."""
    dt, Bsel, Csel = _ssm_inputs(p, xc)
    if valid is not None:
        dt = dt * valid[..., None].to(dt.dtype)
    A = -torch.exp(p["A_log"].float())                   # (d_inner, d_state)
    a = torch.exp(dt.float()[..., None] * A)             # (B, T, d_in, d_st)
    b = (dt * xc).float()[..., None] * Bsel.float()[..., None, :]
    y, h = _recurrence(a, b, Csel.float())
    y = y + xc.float() * p["D"].float()
    return y.to(xc.dtype), h


def mamba_mixer(p: dict, cfg: ModelConfig, x, *, lengths=None,
                return_state: bool = False):
    """Full-sequence (prefill) Mamba mixer. x: (B, T, d_model).

    With ``return_state`` also returns the decode cache at each row's end:
    the conv window of the last d_conv-1 real inputs and the SSM state."""
    d_inner = p["conv_b"].shape[0]
    d_conv = p["conv_w"].shape[0]
    B, T = x.shape[:2]
    if ctx.row_split(p["w_xdbc"]["w"]):   # the rank's d_inner channels
        x = ctx.enter(x)
    xi, z = torch.split(dense(p["w_in"], x), [d_inner, d_inner], dim=-1)
    valid = None
    if lengths is not None:
        valid = (torch.arange(T, device=x.device)[None, :]
                 < lengths[:, None])
    xc = F.silu(_conv_full(p, xi))
    y, h_final = _scan_ssm(p, xc, valid)
    out = dense_row(p["w_out"], y * F.silu(z))
    if not return_state:
        return out
    # conv state: the last d_conv-1 real inputs of each (right-padded) row
    L = (lengths if lengths is not None
         else torch.full((B,), T, dtype=torch.int32, device=x.device))
    idx = (L.long()[:, None] + torch.arange(d_conv - 1, device=x.device)
           ).clamp(min=0)                                  # into the padded
    padded = F.pad(xi, (0, 0, d_conv - 1, 0))
    take = padded.gather(1, idx[:, :, None].expand(B, d_conv - 1, d_inner))
    return out, {"conv": take, "ssm": h_final}


# ---------------------------------------------------------------------------
# decode (stateful)


def init_mamba_cache(cfg: ModelConfig, batch: int, *, device,
                     dtype=torch.float32, d_inner: int | None = None
                     ) -> dict:
    """``d_inner``: the channels the cache holds (a mesh rank's own),
    default the model's."""
    d_whole, d_state, d_conv, _ = _dims(cfg)
    d_inner = d_inner or d_whole
    return {"conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, d_inner, d_state),
                               dtype=torch.float32, device=device)}


def mamba_step(p: dict, cfg: ModelConfig, cache: dict, x, *,
               states_out: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Decode T new tokens in order. x: (B, T, d_model). Returns (out, the
    cache after the T tokens); ``states_out`` (leaves (B, T, ...)) also
    receives the cache after each token."""
    d_inner = p["conv_b"].shape[0]
    d_conv = p["conv_w"].shape[0]
    T = x.shape[1]
    xi, z = torch.split(dense(p["w_in"], x), [d_inner, d_inner], dim=-1)
    A = -torch.exp(p["A_log"].float())
    # every token's conv window: the carried d_conv-1 inputs, then the new
    window = torch.cat([cache["conv"], xi], dim=1)      # (B, d_conv-1+T, d)
    wins = window.unfold(1, d_conv, 1)                  # (B, T, d, d_conv)
    xc = F.silu(torch.einsum("btdc,cd->btd", wins, p["conv_w"])
                + p["conv_b"])
    dt, Bsel, Csel = _ssm_inputs(p, xc)
    a = torch.exp(dt.float()[..., None] * A)                  # (B, T, d, s)
    b = (dt * xc).float()[..., None] * Bsel.float()[:, :, None, :]
    Cf = Csel.float()
    h, ys = cache["ssm"], []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        ys.append(torch.einsum("bds,bs->bd", h, Cf[:, t]))
        if states_out is not None:
            states_out["conv"][:, t] = window[:, t + 1:t + d_conv]
            states_out["ssm"][:, t] = h
    y = (torch.stack(ys, dim=1) + xc.float() * p["D"].float()).to(x.dtype)
    out = dense_row(p["w_out"], y * F.silu(z))
    return out, {"conv": window[:, T:], "ssm": h}
