"""Parameter init and primitive layers of the Molecular Transformer and
the decoder-only transformer.

Params are nested dicts of tensors, with the JAX package's names and
layouts: a dense ``w`` is ``(d_in, d_out)`` and is applied as ``x @ w``, so
``repro_torch.bridge`` carries JAX params across without transposes.

Under a serving mesh's tensor-parallel context (``repro_torch.sharding.
ctx``) the row-parallel projections (``dense_row``), the embedding and the
output heads reduce or gather over the model axis, and under autograd the
inputs of the split projections sum their gradients there
(``ctx.enter``); outside it they are the plain ops.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding import ctx

# ---------------------------------------------------------------------------
# init helpers (explicit generator: same distributions as the JAX init,
# different numbers from the same seed). Draws happen on the generator's
# own device, so a CUDA generator fills the card's weights with no host
# copy; a CPU generator gives the same numbers whatever ``device`` is. On
# the meta device nothing is drawn (``gen`` may be None): the leaves carry
# shapes and dtypes only, the counterpart of ``jax.eval_shape(init)``.


def _normal(gen: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device).mul_(scale).to(device)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float,
             device) -> torch.Tensor:
    """U[lo, hi), drawn as ``_normal`` draws."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=gen.device).mul_(hi - lo).add_(lo).to(device)


def dense_init(gen, d_in: int, d_out: int, *, use_bias: bool, device,
               scale: float | None = None) -> dict:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal(gen, (d_in, d_out), scale, device)}
    if use_bias:
        p["b"] = torch.zeros((d_out,), device=device)
    return p


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def dense_row(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``dense`` for a layer's output projection, whose input dim may be
    split over the model axis (``wo``, ``w_out``): the partial products
    are summed over the axis before the (whole) bias; in a block of a
    stream split along T, the rank's positions of the output
    (``ctx.out_reduce``), the bias applied there."""
    w = p["w"]
    y = ctx.out_reduce(w, ctx.row_input(w, x) @ w)
    if "b" in p:
        y = y + ctx.on_positions(p["b"])
    return y


def norm_init(d: int, kind: str, device) -> dict:
    p = {"scale": torch.ones((d,), device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), device=device)
    return p


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32 (no dispatch when it already is: eager decoding pays
    for every call)."""
    return t if t.dtype == torch.float32 else t.float()


def apply_norm(p: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm / LayerNorm computed in fp32 (the JAX package's numerics)."""
    xf = _f32(x)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    elif kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).pow(2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * _f32(p["scale"])
    if "bias" in p:
        y = y + _f32(p["bias"])
    return y if y.dtype == x.dtype else y.to(x.dtype)


# ---------------------------------------------------------------------------
# positions


def rope_frequencies(head_dim: int, theta: float, *, device=None
                     ) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos | cos, -sin | sin), each (..., T, 1, head_dim) in fp32, for
    ``apply_rope``: every layer of a forward rotates at the same
    positions, so a stack computes them once."""
    freqs = rope_frequencies(head_dim, theta, device=positions.device)
    angles = positions[..., :, None].float() * freqs       # (..., T, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return (torch.cat([cos, cos], -1)[..., None, :],
            torch.cat([-sin, sin], -1)[..., None, :])


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, *,
               tables=None) -> torch.Tensor:
    """Rotary embedding in fp32 with the half-split rotation (the first and
    second halves of the head dim are the pair), as the JAX package does.
    x: (..., T, H, head_dim); positions: broadcastable to (..., T);
    ``tables``: ``rope_tables`` of these positions, if already made.

    Written as ``x * (cos | cos) + (x2 | x1) * (-sin | sin)``: halves
    ``x1 cos - x2 sin`` and ``x2 cos + x1 sin``, bitwise the JAX package's
    ``x1 cos - x2 sin`` and ``x1 sin + x2 cos`` (negation is exact and
    addition commutes), in four kernels instead of seven."""
    cos2, sin2 = (rope_tables(positions, x.shape[-1], theta) if tables is None
                  else tables)
    xf = _f32(x)
    x1, x2 = xf.chunk(2, dim=-1)
    out = xf * cos2 + torch.cat([x2, x1], dim=-1) * sin2
    return out if out.dtype == x.dtype else out.to(x.dtype)


def sinusoidal_positions(max_len: int, d_model: int, *, device=None,
                         dtype=torch.float32) -> torch.Tensor:
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=device)
                    * (-math.log(10_000.0) / d_model))
    pe = torch.zeros((max_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


# ---------------------------------------------------------------------------
# FFN


def ffn_init(gen, d_model: int, d_ff: int, *, use_bias: bool, gated: bool,
             device) -> dict:
    p = {
        "w_in": dense_init(gen, d_model, d_ff, use_bias=use_bias, device=device),
        "w_out": dense_init(gen, d_ff, d_model, use_bias=use_bias,
                            device=device),
    }
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, use_bias=use_bias,
                                 device=device)
    return p


def ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    if ctx.row_split(p["w_out"]["w"]):   # the hidden dim split: the rank's
        x = ctx.enter(x)
    h = dense(p["w_in"], x)
    if "w_gate" in p:
        h = F.silu(dense(p["w_gate"], x)) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return dense_row(p["w_out"], h)


# ---------------------------------------------------------------------------
# embedding


def embed_init(gen, vocab: int, d_model: int, device) -> dict:
    return {"embed": _normal(gen, (vocab, d_model), 0.02, device)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return ctx.embed_lookup(p["embed"], tokens)


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied output projection: ``x @ embed.T``."""
    e = p["embed"]
    return ctx.gather_last(e, ctx.vocab_input(e, x) @ e.T)


def vocab_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The output head ``x @ w_vocab``, whole over the vocabulary."""
    w = p["w_vocab"]
    return ctx.gather_last(w, ctx.vocab_input(w, x) @ w)


def logits_init(gen, d_model: int, vocab: int, device) -> dict:
    return {"w_vocab": _normal(gen, (d_model, vocab), 1.0 / math.sqrt(d_model),
                               device)}
