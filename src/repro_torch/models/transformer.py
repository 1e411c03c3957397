"""Decoder-only transformer, the port of ``repro.models.transformer``:
a repeating layer-block pattern of self-attention (GQA with RoPE,
optional qk-norm and sliding window), Mamba and RWKV6 blocks, each
attention or Mamba block followed by a dense (SwiGLU or GELU) or MoE FFN;
RMSNorm or LayerNorm; tied or separate output head. It serves the dense
archs (SmolLM, Qwen3, StarCoder2, Command-R), MoE (Phi-3.5-MoE, Llama-4
with dense and MoE FFNs interleaved), the Mamba hybrid (Jamba) and RWKV6.

Params follow the JAX package's tree with its stacked repeat axis split
into Python lists: ``params["blocks"]`` is a tuple with one entry per
pattern position, each a list of per-layer dicts, so the JAX
``lax.scan`` over repeats becomes a loop (``repro_torch.bridge`` carries a
JAX tree across). The cache is a tuple with one entry per pattern
position, stacked on a leading repeat axis with batch on axis 1, as the
seq2seq cache's are, so ``repro_torch.core.tree_batch``, the page plan
and ``unmap_cache_rows`` serve both: a ``KVCache`` or ``PagedKVCache``
for attention, a dict of state tensors for Mamba (``conv``, ``ssm``) and
RWKV (``S``, ``x_tm``, ``x_cm``), which stays dense when the attention
cache is paged.

Attention caches are written IN PLACE and need no rollback: stale slots
(rejected drafts) are overwritten before any query can see them.
Recurrent state is the honest cost of speculative decoding on these
families: ``decode_step`` leaves the cache's state as it was and returns,
for each recurrent position, per-step checkpoints with leaves (R, B, T+1,
...), index 0 the state before the step; ``commit_cache`` keeps the one
at each row's ``n_keep``, as the JAX package does. ``prefill`` and
``write_prompt`` (a chunked prefill) write their final state into the
cache in place.

Serving needs no full-sequence attention: ``prefill`` writes the prompt
into the cache through ``cached_attention``, as the JAX package's does.
``multidraft_verify_step`` / ``commit_multidraft`` verify every draft in
one row per sequence over a dense cache (``repro_torch.core.multidraft``),
attention patterns only. The full-sequence ``apply`` (training, ROADMAP.md
Queue 1 item 6.5) and cross-attention layers (item 6.4) are refused by
name.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.attention import (KVCache, PagedKVCache,
                                          cached_attention)
from repro_torch.models.layers import (apply_norm, embed, embed_init, ffn,
                                       ffn_init, logits_init, norm_init,
                                       rope_tables, unembed)

RECURRENT = ("mamba", "rwkv")
_NEEDS = {"moe": "moe", "mamba": "mamba", "rwkv": "rwkv"}


def check_serves(cfg: ModelConfig) -> None:
    """Refuse, by name, a pattern the port does not serve yet."""
    if cfg.family in ("seq2seq", "audio"):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a "
                         f"decoder-only language model")
    for k in cfg.layer_pattern + cfg.ffn_pattern:
        if k not in ("attn", "mamba", "rwkv", "dense", "moe"):
            raise NotImplementedError(
                f"{cfg.name}: layer kind {k!r} is not ported yet "
                f"(ROADMAP.md Queue 1 item 6.4)")
        if k in _NEEDS and getattr(cfg, _NEEDS[k]) is None:
            raise ValueError(f"{cfg.name}: layer kind {k!r} needs "
                             f"ModelConfig.{_NEEDS[k]}")


def recurrent(cfg: ModelConfig) -> bool:
    """True when the pattern holds a recurrent (Mamba / RWKV) position."""
    return any(k in RECURRENT for k in cfg.layer_pattern)


def refuse_recurrent(cfg: ModelConfig, what: str) -> None:
    """Refuse ``what`` on a pattern with a recurrent position, by name."""
    kinds = sorted({k for k in cfg.layer_pattern if k in RECURRENT})
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: {what} needs attention-only layers; the pattern "
            f"holds recurrent {'/'.join(kinds)} positions (use the "
            f"expanded-batch speculative path)")


# ---------------------------------------------------------------------------
# init


def _block_init(gen, cfg: ModelConfig, kind: str, ffn_kind: str, dev):
    d, norm = cfg.d_model, cfg.norm
    p = {"norm1": norm_init(d, norm, dev)}
    if kind == "rwkv":
        p["rwkv"] = rwkv_mod.rwkv_init(gen, cfg, device=dev)
        p["norm2"] = norm_init(d, norm, dev)
        p["cmix"] = rwkv_mod.rwkv_channel_init(gen, cfg, device=dev)
        return p
    if kind == "attn":
        p["attn"] = attn_mod.attn_init(gen, cfg, device=dev)
    else:
        p["mamba"] = mamba_mod.mamba_init(gen, cfg, device=dev)
    p["norm2"] = norm_init(d, norm, dev)
    p["ffn"] = (moe_mod.moe_init(gen, cfg, device=dev) if ffn_kind == "moe"
                else ffn_init(gen, d, cfg.d_ff, use_bias=cfg.use_bias,
                              gated=cfg.gated_ffn, device=dev))
    return p


def init(gen: torch.Generator, cfg: ModelConfig, *, device=None) -> dict:
    """Random params drawn from ``gen`` on the generator's own device, then
    placed on ``device``: the JAX init's distributions, not its numbers.
    A CPU generator gives the same weights whatever ``device`` is (the
    card's weights equal the CPU's); a CUDA generator draws on the card
    with no host copy (full-width models), and its numbers are its own."""
    check_serves(cfg)
    dev = resolve_device(device)
    params = {"tok": embed_init(gen, cfg.vocab_size, cfg.d_model, dev),
              "blocks": tuple([_block_init(gen, cfg, kind,
                                           cfg.ffn_pattern[i], dev)
                               for _ in range(cfg.n_repeats)]
                              for i, kind in enumerate(cfg.layer_pattern)),
              "final_norm": norm_init(cfg.d_model, cfg.norm, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = logits_init(gen, cfg.d_model, cfg.vocab_size, dev)
    return params


# ---------------------------------------------------------------------------
# caches


def _state_init(cfg: ModelConfig, kind: str, batch: int, dev, dtype) -> dict:
    """One layer's zero recurrent state, (B, ...) leaves."""
    if kind == "mamba":
        return mamba_mod.init_mamba_cache(cfg, batch, device=dev, dtype=dtype)
    H, hd = rwkv_mod._heads(cfg)
    return {"S": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=dev),
            "x_tm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=dev),
            "x_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=dev)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, paged=None, device=None) -> tuple:
    """One cache per pattern position, stacked over repeats (leading axis).

    ``paged``: ``(n_pages, page_size)`` allocates each attention position's
    cache as a ``PagedKVCache`` (one pool per layer, every layer's block
    table identical, one page-id space) whose pages the caller maps.
    Recurrent state stays dense: it is O(1) in sequence length a row."""
    check_serves(cfg)
    dev = resolve_device(device)
    R = cfg.n_repeats

    def stack(a):
        return a.expand(R, *a.shape).contiguous()

    caches = []
    for kind in cfg.layer_pattern:
        if kind in RECURRENT:
            caches.append({k: stack(v) for k, v in
                           _state_init(cfg, kind, batch, dev, dtype).items()})
        elif paged is not None:
            n_pages, page_size = paged
            one = attn_mod.init_paged_kv_cache(
                cfg, batch, max_len, n_pages=n_pages, page_size=page_size,
                device=dev, dtype=dtype)
            caches.append(PagedKVCache(
                k_pool=stack(one.k_pool), v_pool=stack(one.v_pool),
                pos=stack(one.pos), block_tables=stack(one.block_tables)))
        else:
            one = attn_mod.init_kv_cache(cfg, batch, max_len, device=dev,
                                         dtype=dtype)
            caches.append(KVCache(k=stack(one.k), v=stack(one.v),
                                  pos=stack(one.pos)))
    return tuple(caches)


def commit_cache(cfg: ModelConfig, cache: tuple, n_keep) -> tuple:
    """Keep each row's recurrent checkpoint at ``n_keep`` (B,) (fed tokens
    accepted, 0 = the state before the step): leaves (R, B, T+1, ...)
    become (R, B, ...). Attention caches pass through."""
    if not recurrent(cfg):
        return cache
    out = []
    for kind, c in zip(cfg.layer_pattern, cache):
        if kind in RECURRENT:
            a0 = next(iter(c.values()))
            idx = torch.as_tensor(n_keep, device=a0.device).long()
            rows = torch.arange(a0.shape[1], device=a0.device)
            c = {k: a[:, rows, idx] for k, a in c.items()}
        out.append(c)
    return tuple(out)


def _layer(c, r: int):
    """Repeat ``r`` of a stacked cache (views, written in place)."""
    if isinstance(c, PagedKVCache):
        return PagedKVCache(c.k_pool[r], c.v_pool[r], c.pos[r],
                            c.block_tables[r])
    if isinstance(c, KVCache):
        return KVCache(c.k[r], c.v[r], c.pos[r])
    return {k: v[r] for k, v in c.items()}


# ---------------------------------------------------------------------------
# recurrent blocks


def _rwkv_decode_ckpt(p, cfg: ModelConfig, state: dict, x, ckpt: dict):
    """A whole RWKV block over T fed tokens, one token at a time, writing
    the state after each into ``ckpt`` (leaves (B, T+1, ...), index 0 the
    state before the step)."""
    S, x_tm, x_cm = state["S"], state["x_tm"], state["x_cm"]
    for k, v in state.items():
        ckpt[k][:, 0] = v
    outs = []
    for t in range(x.shape[1]):
        xt = x[:, t:t + 1, :]
        n1 = apply_norm(p["norm1"], xt, cfg.norm)
        mix, (S, x_tm) = rwkv_mod.rwkv_mixer(p["rwkv"], cfg, n1, state=S,
                                             x_last=x_tm)
        xt = xt + mix
        n2 = apply_norm(p["norm2"], xt, cfg.norm)
        cm, x_cm = rwkv_mod.rwkv_channel_mix(p["cmix"], n2, x_last=x_cm)
        outs.append(xt + cm)
        for k, v in (("S", S), ("x_tm", x_tm), ("x_cm", x_cm)):
            ckpt[k][:, t + 1] = v
    return torch.cat(outs, dim=1)


def _rwkv_prefill(p, cfg: ModelConfig, state: dict, x, lengths):
    """A whole RWKV block over the prompt; the state at each row's last
    valid token is written into ``state`` (views of the cache) in place."""
    B, T = x.shape[:2]
    valid = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    n1 = apply_norm(p["norm1"], x, cfg.norm) * valid[..., None].to(x.dtype)
    mix, (S, _) = rwkv_mod.rwkv_mixer(p["rwkv"], cfg, n1, state=state["S"],
                                      x_last=state["x_tm"], lengths=lengths)
    x = x + mix
    n2 = apply_norm(p["norm2"], x, cfg.norm)
    cm, _ = rwkv_mod.rwkv_channel_mix(p["cmix"], n2)
    rows = torch.arange(B, device=x.device)
    last = (lengths.long() - 1).clamp(0, T - 1)
    for k, v in (("S", S), ("x_tm", n1[rows, last]), ("x_cm", n2[rows, last])):
        state[k].copy_(v)
    return x + cm


def _mamba_decode_ckpt(p, cfg: ModelConfig, state: dict, h, ckpt: dict):
    """Mamba over T fed tokens one at a time (``mamba_step`` each),
    writing the state after each into ``ckpt``."""
    for k, v in state.items():
        ckpt[k][:, 0] = v
    c, ys = state, []
    for t in range(h.shape[1]):
        y, c = mamba_mod.mamba_step(p, cfg, c, h[:, t:t + 1, :])
        ys.append(y)
        for k, v in c.items():
            ckpt[k][:, t + 1] = v
    return torch.cat(ys, dim=1)


# ---------------------------------------------------------------------------
# stack


def _ffn(p, cfg: ModelConfig, kind: str, x):
    if kind == "moe":
        return moe_mod.moe_ffn(p, cfg, x)[0]
    return ffn(p, x)


def _run_stack(params, cfg: ModelConfig, x, cache, positions, *,
               lengths=None):
    """Every layer in order (repeat-major, as the JAX scan runs them).
    Attention writes its K/V into the cache in place; the rotary tables of
    the positions are made once for all layers.

    Recurrent positions: with ``lengths`` (B,) (prefill) each runs over
    the whole prompt and writes its state at each row's end into the cache
    in place; without (decode), each runs token by token and the state
    after every fed token goes into fresh checkpoints (R, B, T+1, ...).
    Returns (x, cache with those checkpoints)."""
    positions = positions.to(torch.int32).contiguous()
    rope = (rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.pos == "rope" and "attn" in cfg.layer_pattern else None)
    B, T = x.shape[:2]
    out = list(cache)
    if lengths is None:
        for i, kind in enumerate(cfg.layer_pattern):
            if kind in RECURRENT:
                out[i] = {k: v.new_empty((v.shape[0], B, T + 1, *v.shape[2:]))
                          for k, v in cache[i].items()}
    for r in range(cfg.n_repeats):
        for i, kind in enumerate(cfg.layer_pattern):
            p = params["blocks"][i][r]
            if kind == "rwkv":
                x = (_rwkv_prefill(p, cfg, _layer(cache[i], r), x, lengths)
                     if lengths is not None else
                     _rwkv_decode_ckpt(p, cfg, _layer(cache[i], r), x,
                                       _layer(out[i], r)))
                continue
            h = apply_norm(p["norm1"], x, cfg.norm)
            if kind == "attn":
                a, _ = cached_attention(p["attn"], cfg, h,
                                        _layer(cache[i], r), positions,
                                        rope=rope)
            elif lengths is not None:
                a, st = mamba_mod.mamba_mixer(p["mamba"], cfg, h,
                                              lengths=lengths,
                                              return_state=True)
                for k, v in _layer(cache[i], r).items():
                    v.copy_(st[k])
            else:
                a = _mamba_decode_ckpt(p["mamba"], cfg, _layer(cache[i], r),
                                       h, _layer(out[i], r))
            x = x + a
            x = x + _ffn(p["ffn"], cfg, cfg.ffn_pattern[i],
                         apply_norm(p["norm2"], x, cfg.norm))
    return x, (cache if lengths is not None or not recurrent(cfg)
               else tuple(out))


def _logits_out(params, cfg: ModelConfig, x):
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if cfg.tie_embeddings:
        return unembed(params["tok"], x)
    return x @ params["lm_head"]["w_vocab"]


# ---------------------------------------------------------------------------
# public API


def apply(params, cfg: ModelConfig, tokens, **kw):
    raise NotImplementedError(
        "transformer.apply (the full-sequence forward of LM training) is "
        "not ported yet (ROADMAP.md Queue 1 item 6.5)")


def prefill(params, cfg: ModelConfig, cache, tokens, *, lengths=None,
            logits_mode: str = "all"):
    """Write the prompt into the cache, in place. Returns (logits, cache).

    tokens: (B, T); ``lengths`` (B,) valid tokens per row (default T):
    positions past a row's length are -1, so their K/V land in the
    throwaway slot, and recurrent state stops at each row's length.
    ``logits_mode="last"`` gives (B, V) at each row's last valid position
    instead of (B, T, V)."""
    if logits_mode not in ("all", "last"):
        raise ValueError(f"logits_mode {logits_mode!r}")
    B, T = tokens.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32,
                             device=tokens.device)
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=tokens.device)
    pos = torch.arange(T, dtype=torch.int32, device=tokens.device)[None, :]
    positions = torch.where(pos < lengths[:, None], pos, -1)
    x, cache = _run_stack(params, cfg, embed(params["tok"], tokens), cache,
                          positions, lengths=lengths)
    if logits_mode == "last":
        last = (lengths - 1).clamp(0, T - 1).long()
        x = x[torch.arange(B, device=x.device), last]
    return _logits_out(params, cfg, x), cache


def decode_step(params, cfg: ModelConfig, cache, tokens, positions, *,
                memory_mask=None):
    """Feed T new tokens per row (T = 1 for greedy, DL+1 to verify) at
    ``positions`` (B, T) (rows may differ; -1 = a pad token). Returns
    (logits (B, T, V), cache): attention K/V written in place, recurrent
    positions as per-step checkpoints for ``commit_cache``."""
    if memory_mask is not None:
        raise NotImplementedError("memory_mask: cross-attention layers are "
                                  "not ported yet (ROADMAP.md Queue 1 item "
                                  "6.4)")
    x, cache = _run_stack(params, cfg, embed(params["tok"], tokens), cache,
                          positions)
    return _logits_out(params, cfg, x), cache


def write_prompt(params, cfg: ModelConfig, cache, tokens, positions,
                 n_valid):
    """``decode_step`` without the output head, committed: write the K/V
    of ``tokens`` at ``positions`` into the cache and keep each row's
    recurrent state after its first ``n_valid`` (B,) tokens (a chunked
    prefill, whose logits nobody reads; ``n_valid`` 0 leaves the row's
    state bitwise as it was). Returns the cache, written in place."""
    _, ckpt = _run_stack(params, cfg, embed(params["tok"], tokens), cache,
                         positions)
    if recurrent(cfg):
        for kind, c, kept in zip(cfg.layer_pattern, cache,
                                 commit_cache(cfg, ckpt, n_valid)):
            if kind in RECURRENT:
                for k, v in c.items():
                    v.copy_(kept[k])
    return cache


def multidraft_verify_step(params, cfg: ModelConfig, cache, tokens,
                           positions, local_mask):
    """Single-pass verification of ALL drafts (``attention.
    multidraft_attention``) over a dense cache. tokens: (B, 1 + N_d·DL) =
    [last committed, draft 0 ..., draft N_d-1 ...]; positions: their
    absolute positions; local_mask: the (T, T) segment mask.

    Attention patterns only (dense or MoE FFNs): a recurrent mixer runs
    its tokens in order, so drafts cannot share its row; those patterns
    use the expanded-batch verify path, as in the JAX package.

    Returns (logits (B, T, V), local_kv): local_kv holds, per pattern
    position, the fed tokens' (k, v) stacked over repeats, for
    ``commit_multidraft``. The cache is not modified."""
    check_serves(cfg)
    refuse_recurrent(cfg, "multi-draft verification")
    positions = positions.to(torch.int32).contiguous()
    rope = (rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.pos == "rope" else None)
    x = embed(params["tok"], tokens)
    kvs = [([], []) for _ in cfg.layer_pattern]
    for r in range(cfg.n_repeats):
        for i in range(len(cfg.layer_pattern)):
            p = params["blocks"][i][r]
            a, (k, v) = attn_mod.multidraft_attention(
                p["attn"], cfg, apply_norm(p["norm1"], x, cfg.norm),
                _layer(cache[i], r), positions, local_mask, rope=rope)
            x = x + a
            x = x + _ffn(p["ffn"], cfg, cfg.ffn_pattern[i],
                         apply_norm(p["norm2"], x, cfg.norm))
            kvs[i][0].append(k)
            kvs[i][1].append(v)
    local_kv = tuple((torch.stack(k), torch.stack(v)) for k, v in kvs)
    return _logits_out(params, cfg, x), local_kv


def commit_multidraft(cfg: ModelConfig, cache, local_kv, best, n_acc,
                      start_pos, *, draft_len: int):
    """Write the winning draft's accepted K/V into the cache, in place.

    best: (B,) winning draft index; n_acc: (B,) accepted draft tokens;
    start_pos: (B,) position of the fed last committed token. Commits the
    last token and the ``n_acc`` accepted draft tokens (``n_keep = 1 +
    n_acc``), as the expanded-batch path keeps them."""
    B, DL = best.shape[0], draft_len
    dev = best.device
    rel = torch.arange(DL + 1, dtype=torch.int32, device=dev)
    # local indices: 0 (the last token), then the winner's segment
    take_idx = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                          1 + best.to(torch.int32)[:, None] * DL
                          + rel[None, :-1]], dim=1)
    positions = start_pos.to(torch.int32)[:, None] + rel[None, :]
    n_keep = 1 + n_acc
    for c, (k, v) in zip(cache, local_kv):
        for r in range(cfg.n_repeats):
            attn_mod.commit_verified_kv(_layer(c, r), k[r], v[r], take_idx,
                                        positions, n_keep)
    return cache
