"""The plain Molecular Transformer (Schwaller et al. 2019; the paper's
Appendix A): full forward passes in float32, no cache, no kernels, no
batching tricks. It judges what the program serves.

Pre-LayerNorm residual blocks (eps 1e-6), GELU (tanh form), token
embedding scaled by sqrt(d_model) plus sinusoidal positions, one embedding
shared by encoder and decoder, an unbiased output head. Every dense weight
is stored ``(d_in, d_out)`` and applied as ``x @ w``.

Weights are a flat ``{name: tensor}`` dict (``weight_shapes`` names them).
On the card every matmul runs in plain float32 unless ``tf32=True`` (the
control, one precision step below what the configuration states).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

NEG = -1e30


def weight_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every weight's name and shape, in a fixed order."""
    d, f, V = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    shapes: dict[str, tuple[int, ...]] = {"tok": (V, d)}

    def attn(p):
        for n in ("q", "k", "v", "o"):
            shapes[f"{p}.w{n}"] = (d, d)
            shapes[f"{p}.b{n}"] = (d,)

    def norm(p):
        shapes[f"{p}.g"] = (d,)
        shapes[f"{p}.b"] = (d,)

    def ffn(p):
        shapes.update({f"{p}.w1": (d, f), f"{p}.b1": (f,),
                       f"{p}.w2": (f, d), f"{p}.b2": (d,)})

    for i in range(cfg["n_encoder_layers"]):
        norm(f"enc.{i}.ln1"), attn(f"enc.{i}.attn")
        norm(f"enc.{i}.ln2"), ffn(f"enc.{i}.ffn")
    norm("enc_ln")
    for i in range(cfg["n_layers"]):
        norm(f"dec.{i}.ln1"), attn(f"dec.{i}.self")
        norm(f"dec.{i}.lnx"), attn(f"dec.{i}.cross")
        norm(f"dec.{i}.ln2"), ffn(f"dec.{i}.ffn")
    norm("dec_ln")
    shapes["out"] = (d, V)
    return shapes


def init(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Weights drawn from ``seed`` on ``device`` in one call: dense weights
    N(0, 1/d_in), the embedding N(0, 0.02^2), biases 0, norm gains 1."""
    shapes = weight_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    w, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if name == "tok":
            x = x * 0.02
        elif leaf == "g":
            x = torch.ones_like(x)
        elif len(shape) == 1:
            x = torch.zeros_like(x)
        else:
            x = x / math.sqrt(shape[0])
        w[name] = x.clone()
    return w


@contextlib.contextmanager
def precision(tf32: bool):
    """Matmuls in plain float32 (the configuration's precision), or in TF32
    for the control; restores the previous setting."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def positions_table(n: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10_000.0) / d))
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _norm(w, p, x):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * w[f"{p}.g"] + w[f"{p}.b"]


def _attn(w, p, x, mem, mask, n_heads):
    """x (B, T, d) queries over mem (B, S, d); mask broadcastable to
    (B, 1, T, S), True = visible."""
    B, T, d = x.shape
    S, hd = mem.shape[1], d // n_heads
    q = (x @ w[f"{p}.wq"] + w[f"{p}.bq"]).view(B, T, n_heads, hd)
    k = (mem @ w[f"{p}.wk"] + w[f"{p}.bk"]).view(B, S, n_heads, hd)
    v = (mem @ w[f"{p}.wv"] + w[f"{p}.bv"]).view(B, S, n_heads, hd)
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    s = s.masked_fill(~mask, NEG)
    o = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v)
    return o.reshape(B, T, d) @ w[f"{p}.wo"] + w[f"{p}.bo"]


def _ffn(w, p, x):
    h = F.gelu(x @ w[f"{p}.w1"] + w[f"{p}.b1"], approximate="tanh")
    return h @ w[f"{p}.w2"] + w[f"{p}.b2"]


def _embed(w, cfg, tokens):
    T = tokens.shape[1]
    pe = positions_table(T, cfg["d_model"], tokens.device)
    return w["tok"][tokens] * math.sqrt(cfg["d_model"]) + pe


def encode(w, cfg, src):
    """src (B, S) token ids, pad 0 -> (memory (B, S, d), key mask (B, S))."""
    mask = src != 0
    x = _embed(w, cfg, src)
    m4 = mask[:, None, None, :]
    for i in range(cfg["n_encoder_layers"]):
        h = _norm(w, f"enc.{i}.ln1", x)
        x = x + _attn(w, f"enc.{i}.attn", h, h, m4, cfg["n_heads"])
        x = x + _ffn(w, f"enc.{i}.ffn", _norm(w, f"enc.{i}.ln2", x))
    return _norm(w, "enc_ln", x), mask


def decode(w, cfg, tgt_in, memory, mask):
    """Teacher-forced decoder over tgt_in (B, T) -> logits (B, T, V)."""
    T = tgt_in.shape[1]
    x = _embed(w, cfg, tgt_in)
    causal = torch.ones((T, T), dtype=torch.bool,
                        device=tgt_in.device).tril()[None, None]
    m4 = mask[:, None, None, :]
    for i in range(cfg["n_layers"]):
        h = _norm(w, f"dec.{i}.ln1", x)
        x = x + _attn(w, f"dec.{i}.self", h, h, causal, cfg["n_heads"])
        x = x + _attn(w, f"dec.{i}.cross", _norm(w, f"dec.{i}.lnx", x),
                      memory, m4, cfg["n_heads"])
        x = x + _ffn(w, f"dec.{i}.ffn", _norm(w, f"dec.{i}.ln2", x))
    return _norm(w, "dec_ln", x) @ w["out"]


def forward(w, cfg, src, tgt_in):
    memory, mask = encode(w, cfg, src)
    return decode(w, cfg, tgt_in, memory, mask)


def pad_rows(rows, device, width: int | None = None) -> torch.Tensor:
    """Token lists -> (len(rows), width) int64, pad 0."""
    width = width or max(1, max(len(r) for r in rows))
    out = torch.zeros((len(rows), width), dtype=torch.long)
    for i, r in enumerate(rows):
        out[i, :len(r)] = torch.as_tensor(r, dtype=torch.long)
    return out.to(device)


def greedy(w, cfg, srcs, *, max_new: int, bos: int, eos: int):
    """Token-by-token greedy decoding, a full forward a step."""
    dev = w["tok"].device
    src = pad_rows(srcs, dev)
    memory, mask = encode(w, cfg, src)
    B = len(srcs)
    seq = torch.full((B, 1), bos, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(max_new):
        nxt = decode(w, cfg, seq, memory, mask)[:, -1].argmax(-1)
        nxt = torch.where(done, torch.zeros_like(nxt), nxt)
        seq = torch.cat([seq, nxt[:, None]], 1)
        done |= nxt == eos
        if bool(done.all()):
            break
    out = []
    for row in seq[:, 1:].tolist():
        out.append(row[:row.index(eos) + 1] if eos in row else
                   [t for t in row if t != 0])
    return out


def source_drafts(src_ids, draft_len: int, n_drafts: int, pad: int = 0):
    """The paper's source-copy drafts (section 2.1): every window of
    ``draft_len`` source tokens (EOS included, pads dropped), stride 1, the
    first ``n_drafts`` of them; a source shorter than a window gives one
    window padded with ``pad``. Returns (drafts (n_drafts, draft_len) int64,
    mask (n_drafts,) bool)."""
    toks = [t for t in src_ids if t != pad]
    wins = [toks[s:s + draft_len] for s in range(len(toks) - draft_len + 1)]
    if not wins and toks:
        wins = [toks[:draft_len] + [pad] * (draft_len - len(toks))]
    drafts = torch.full((n_drafts, draft_len), pad, dtype=torch.long)
    mask = torch.zeros(n_drafts, dtype=torch.bool)
    for i, win in enumerate(wins[:n_drafts]):
        drafts[i] = torch.as_tensor(win)
        mask[i] = True
    return drafts, mask


def _stable_top(x, k: int):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def speculative_beam_search(w, cfg, srcs, *, n_beams: int, max_new: int,
                            draft_len: int, n_drafts: int, bos: int,
                            eos: int, pad: int = 0, block: int = 1024):
    """The paper's speculative beam search (Algorithm 1), a full forward a
    step for every (live beam, draft) row. Each step, each live beam feeds
    its tokens and each source-copy draft; the draft whose prefix the
    model's argmax (pad excluded) accepts longest wins (the first on ties);
    the beam offers, for every a up to that accepted length, its tokens +
    draft[:a] + each of its ``n_beams`` best next tokens (none past a draft
    EOS, none beyond the budget, none that repeats a longer offer), scored
    by the summed log-probs; a finished beam offers itself once; the
    ``n_beams`` best offers go on (ties to the lower parent, then the
    shorter prefix, then the better token). Rows are fed ``block`` at a
    time. Returns per source ``n_beams`` (tokens, score) pairs, best
    first."""
    dev = w["tok"].device
    K, R, DL, A = n_beams, len(srcs), draft_len, draft_len + 1
    memory, mask = encode(w, cfg, pad_rows(srcs, dev))
    dr, dm = zip(*(source_drafts(s, DL, n_drafts, pad) for s in srcs))
    dr, dm = torch.stack(dr).to(dev), torch.stack(dm).to(dev)  # (R, N, DL)
    N = dr.shape[1]
    beams = [[[] for _ in range(K)] for _ in range(R)]
    score = torch.full((R, K), NEG, dtype=torch.float32, device=dev)
    score[:, 0] = 0.0
    fin = torch.zeros((R, K), dtype=torch.bool, device=dev)
    rel = torch.arange(A, device=dev)
    for _ in range(max_new):
        live = [(r, k) for r in range(R) for k in range(K)
                if not bool(fin[r, k]) and float(score[r, k]) > NEG / 2]
        if not live:
            break
        # every (live beam, draft) row: [bos] + beam + draft
        rows = [[bos] + beams[r][k] + dr[r, n].tolist()
                for r, k in live for n in range(N)]
        owner = torch.as_tensor([r for r, _ in live for _ in range(N)],
                                device=dev)
        at = torch.as_tensor([len(beams[r][k]) for r, k in live
                              for _ in range(N)], device=dev)
        parts = []
        for lo in range(0, len(rows), block):   # bounded activations
            hi = min(lo + block, len(rows))
            lg = decode(w, cfg, pad_rows(rows[lo:hi], dev),
                        memory[owner[lo:hi]], mask[owner[lo:hi]])
            idx = (at[lo:hi, None] + rel[None, :])[..., None]
            parts.append(lg.gather(1, idx.expand(-1, -1, lg.shape[-1])))
        lp = torch.log_softmax(torch.cat(parts), -1)        # (rows, A, V)
        lp[..., pad] = NEG
        lp = lp.view(len(live), N, A, -1)
        greedy_tok = lp.argmax(-1)
        cand = torch.full((R, K, A, K), NEG, dtype=torch.float32, device=dev)
        cand_tok = torch.zeros((R, K, A, K), dtype=torch.long, device=dev)
        best_of = {}
        for j, (r, k) in enumerate(live):
            d = dr[r]                                          # (N, DL)
            match = (d == greedy_tok[j, :, :DL]).long()
            n_acc = torch.cumprod(match, -1).sum(-1) * dm[r]
            b = int(n_acc.argmax())
            na = int(n_acc[b])
            lpb = lp[j, b]                                     # (A, V)
            d_lp = lpb[:DL].gather(1, d[b][:, None])[:, 0]
            cum = torch.cat([torch.zeros(1, device=dev), d_lp.cumsum(0)])
            topv, topi = _stable_top(lpb, K)                   # (A, K)
            c = score[r, k] + cum[:, None] + topv
            n_out = len(beams[r][k])
            ok = (rel <= na) & (n_out + rel + 1 <= max_new)
            stop = torch.cumsum((d[b] == eos).long(), 0)
            ok &= torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                             stop == 0])
            c = torch.where(ok[:, None], c, torch.full_like(c, NEG))
            d_pad = torch.cat([d[b], torch.full((1,), -1, device=dev)])
            dup = (topi == d_pad[:, None]) & (rel[:, None] < na)
            cand[r, k] = torch.where(dup, torch.full_like(c, NEG), c)
            cand_tok[r, k] = topi
            best_of[(r, k)] = b
        for r in range(R):
            for k in range(K):
                if bool(fin[r, k]):
                    cand[r, k, 0, 0] = score[r, k]
        new_score, flat = _stable_top(cand.view(R, -1), K)
        new_beams = [[None] * K for _ in range(R)]
        new_fin = torch.zeros_like(fin)
        for r in range(R):
            for k in range(K):
                f = int(flat[r, k])
                p, a, kk = f // (A * K), (f // K) % A, f % K
                if bool(fin[r, p]):
                    new_beams[r][k] = list(beams[r][p])
                    new_fin[r, k] = True
                    continue
                b = best_of.get((r, p), 0)
                tok = int(cand_tok[r, p, a, kk])
                seq = beams[r][p] + dr[r, b, :a].tolist() + [tok]
                new_beams[r][k] = seq
                new_fin[r, k] = tok == eos or len(seq) >= max_new
        beams, score, fin = new_beams, new_score, new_fin
    return [[(beams[r][k], float(score[r, k])) for k in range(K)]
            for r in range(R)]


@torch.no_grad()
def teacher_forced(w, cfg, srcs, tgts, *, bos: int, block: int = 256):
    """Per request: logits (len(tgt), V) of each target position, fed
    [bos] + tgt, in blocks of ``block`` requests sorted by length."""
    dev = w["tok"].device
    order = sorted(range(len(srcs)), key=lambda i: (len(srcs[i]),
                                                    len(tgts[i])))
    out: list = [None] * len(srcs)
    for lo in range(0, len(order), block):
        idx = order[lo:lo + block]
        src = pad_rows([srcs[i] for i in idx], dev)
        tgt = pad_rows([[bos] + list(tgts[i][:-1]) if tgts[i] else [bos]
                        for i in idx], dev)
        logits = forward(w, cfg, src, tgt)
        for j, i in enumerate(idx):
            out[i] = logits[j, :max(len(tgts[i]), 1)]
    return out
