"""A plain decoder-only transformer: full forward passes in float32, no
cache, no kernels, no batching tricks. It judges what the program serves
for a configuration of the ``decoder_only`` family whose ``reference`` is
``decoder``.

What it covers (``check`` refuses anything else, by name): a token
embedding; ``n_layers`` pre-norm residual blocks, each causal
grouped-query self-attention (``n_heads`` query heads of ``head_dim``,
``n_kv_heads`` key/value heads, query head h reading key/value head
h // (n_heads / n_kv_heads), scores scaled by 1/sqrt(head_dim)) with
rotary positions (``pos`` "rope": the half-split rotation, the first and
second halves of a head are the pairs, frequencies
``rope_theta ** (-i / (head_dim / 2))``) or none (``pos`` "none"), then a
gated SiLU feed-forward ``(silu(x @ w_gate) * (x @ w_in)) @ w_out``;
RMSNorm (eps 1e-6, a gain, no bias) before each and before the head; an
output head of its own or the embedding's transpose (``tie_embeddings``).
No biases, no qk-norm, no window.

Weights are a flat ``{name: tensor}`` dict (``weight_shapes`` names
them), each dense weight ``(d_in, d_out)`` applied as ``x @ w``, drawn by
``init`` from a seed. On the card every matmul runs in plain float32
unless ``precision(True)`` (the control, TF32, one step below what the
configuration states).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.model import NEG, pad_rows, precision

EPS = 1e-6
# what a configuration has to state as the reference covers it
COVERED = {"layer_pattern": ["attn"], "ffn_pattern": ["dense"],
           "norm": "rmsnorm", "gated_ffn": True, "use_bias": False,
           "qk_norm": False, "sliding_window": 0, "causal": True}


def check(cfg: dict) -> None:
    """Refuse a configuration this reference does not cover."""
    for key, want in COVERED.items():
        have = cfg[key]
        if (list(have) if isinstance(have, (list, tuple)) else have) != want:
            raise ValueError(f"{cfg['name']}: the decoder reference covers "
                             f"{key}={want!r}, not {have!r}")
    if cfg["pos"] not in ("rope", "none"):
        raise ValueError(f"{cfg['name']}: pos {cfg['pos']!r}: the decoder "
                         f"reference covers 'rope' and 'none'")
    if cfg["n_heads"] % cfg["n_kv_heads"]:
        raise ValueError(f"{cfg['name']}: {cfg['n_heads']} query heads over "
                         f"{cfg['n_kv_heads']} key/value heads")


def head_dim(cfg: dict) -> int:
    return cfg["head_dim"] or cfg["d_model"] // cfg["n_heads"]


def weight_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every weight's name and shape, in a fixed order."""
    check(cfg)
    d, f, V = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    hq = cfg["n_heads"] * head_dim(cfg)
    hkv = cfg["n_kv_heads"] * head_dim(cfg)
    shapes: dict[str, tuple[int, ...]] = {"tok": (V, d)}
    for i in range(cfg["n_layers"]):
        p = f"blk.{i}"
        shapes.update({
            f"{p}.ln1.g": (d,), f"{p}.attn.wq": (d, hq),
            f"{p}.attn.wk": (d, hkv), f"{p}.attn.wv": (d, hkv),
            f"{p}.attn.wo": (hq, d), f"{p}.ln2.g": (d,),
            f"{p}.ffn.w_gate": (d, f), f"{p}.ffn.w_in": (d, f),
            f"{p}.ffn.w_out": (f, d)})
    shapes["ln_f.g"] = (d,)
    if not cfg["tie_embeddings"]:
        shapes["out"] = (d, V)
    return shapes


def init(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Weights drawn from ``seed`` on ``device`` in one call, each a view
    of that draw: dense weights N(0, 1/d_in), the embedding N(0, 1/d_model)
    (so a tied head's logits, like an untied one's, come out near unit
    scale), norm gains 1 + N(0, 0.1^2) (not all ones, so a gain left out
    shows)."""
    shapes = weight_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    w, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        if name == "tok":
            x.mul_(1.0 / math.sqrt(cfg["d_model"]))
        elif name.endswith(".g"):
            x.mul_(0.1).add_(1.0)
        else:
            x.mul_(1.0 / math.sqrt(shape[0]))
        w[name] = x
    return w


def _norm(x, g):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS) * g


def _rope(x, theta: float):
    """x (B, T, heads, hd) rotated at positions 0..T-1."""
    T, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    pos = torch.arange(T, dtype=torch.float32, device=x.device)
    ang = pos[:, None] * freqs
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attn(w, cfg, p, x):
    B, T, _ = x.shape
    H, Kv, hd = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    q = (x @ w[f"{p}.wq"]).view(B, T, H, hd)
    k = (x @ w[f"{p}.wk"]).view(B, T, Kv, hd)
    v = (x @ w[f"{p}.wv"]).view(B, T, Kv, hd)
    if cfg["pos"] == "rope":
        q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
    k = k.repeat_interleave(H // Kv, dim=2)
    v = v.repeat_interleave(H // Kv, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, NEG)
    o = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v)
    return o.reshape(B, T, H * hd) @ w[f"{p}.wo"]


def _ffn(w, p, x):
    return (F.silu(x @ w[f"{p}.w_gate"]) * (x @ w[f"{p}.w_in"])) @ w[
        f"{p}.w_out"]


def hidden(w, cfg, tokens):
    """tokens (B, T) -> the final-normed hidden states (B, T, d_model)."""
    x = w["tok"][tokens]
    for i in range(cfg["n_layers"]):
        p = f"blk.{i}"
        x = x + _attn(w, cfg, f"{p}.attn", _norm(x, w[f"{p}.ln1.g"]))
        x = x + _ffn(w, f"{p}.ffn", _norm(x, w[f"{p}.ln2.g"]))
    return _norm(x, w["ln_f.g"])


def head(w, cfg, h):
    return h @ (w["tok"].T if cfg["tie_embeddings"] else w["out"])


@torch.no_grad()
def each_logits(w, cfg, rows, spans, fn, *, tf32=(False,),
                block_tokens: int = 16384) -> None:
    """For each token row (a list of ids), its logits at the positions
    ``spans[i]`` = (lo, hi), (hi - lo, V), handed to ``fn(i, *logits)``,
    one tensor a precision of ``tf32`` (False: float32). Full forwards over
    blocks of rows of like length, at most ``block_tokens`` tokens a block
    as padded; the attention is causal, so the pads at a row's end change
    nothing before them."""
    dev = w["tok"].device
    order = sorted(range(len(rows)), key=lambda i: len(rows[i]))
    i = 0
    while i < len(order):
        j = i + 1
        while (j < len(order)
               and (j - i + 1) * len(rows[order[j]]) <= block_tokens):
            j += 1
        idx = order[i:j]
        tokens = pad_rows([rows[k] for k in idx], dev)
        sizes = [spans[k][1] - spans[k][0] for k in idx]
        outs = []
        for low in tf32:
            with precision(low):
                h = hidden(w, cfg, tokens)
                sel = torch.cat([h[n, spans[k][0]:spans[k][1]]
                                 for n, k in enumerate(idx)])
                outs.append(head(w, cfg, sel).split(sizes))
        for n, k in enumerate(idx):
            fn(k, *(o[n] for o in outs))
        i = j


def query_flops(cfg: dict, prompt_len: int, out_len: int) -> int:
    """Useful flops of one served greedy query: every layer over the
    prompt and the served tokens but the last (positions 0 .. P + L - 2;
    the prompt's last token and each served one are fed once), position t
    attending over t + 1 keys, and the head at the L positions whose
    logits choose a served token. Multiply-adds count 2; norms, rotations,
    softmax and the embedding are left out; rejected draft positions do no
    useful work and are not counted."""
    d, f, V = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    hq = cfg["n_heads"] * head_dim(cfg)
    hkv = cfg["n_kv_heads"] * head_dim(cfg)
    L = int(out_len)
    n = max(int(prompt_len) + L - 1, 0)
    per_token = 2 * d * hq + 4 * d * hkv + 2 * hq * d + 6 * d * f
    attend = 4 * hq * (n * (n + 1) // 2)
    return cfg["n_layers"] * (n * per_token + attend) + L * 2 * d * V
