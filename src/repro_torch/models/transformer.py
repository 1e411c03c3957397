"""Decoder-only (and encoder-only) transformer, the port of
``repro.models.transformer``: a repeating layer-block pattern of
self-attention (GQA with RoPE, optional qk-norm and sliding window), gated
cross-attention to a frontend memory, Mamba and RWKV6 blocks, each
attention or Mamba block followed by a dense (SwiGLU or GELU) or MoE FFN;
RMSNorm or LayerNorm; tied or separate output head. It covers the dense
archs (SmolLM, Qwen3, StarCoder2, Command-R), MoE (Phi-3.5-MoE, Llama-4
with dense and MoE FFNs interleaved), the Mamba hybrid (Jamba), RWKV6, the
VLM (Llama-3.2-Vision: every fifth layer cross-attends to the image
memory through a ``tanh(xattn_gate)`` gate) and the audio encoder (HuBERT:
bidirectional, frame embeddings in, no token embedding).

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
cache is paged, and the memory K/V (``mk``, ``mv`` (R, B, M, H, hd)) of a
cross-attention position, written by ``prefill(memory=)``.

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
attention patterns only (cross-attention positions read their memory K/V).
``apply`` is the full-sequence forward of training: self-attention
through the ``flash_attention`` kernels (GQA, positions, padding,
causal or not), the recurrent mixers over the whole sequence, MoE FFNs
with their auxiliary losses; ``remat`` recomputes each repeat's
activations in the backward (``torch.utils.checkpoint``).

Sequence sharding: under ``ctx.activation_rules(mesh, seq=("model",))`` on
a tensor-parallel mesh rank, where the model axis divides T
(``ctx.seq_shards``), the residual stream ``(B, T, d)`` of ``apply``,
``prefill``, ``decode_step`` and ``write_prompt`` is split along T: each
rank of the model axis holds its ``T / m`` positions between blocks (the
embedding's sum a reduce-scatter, a whole embedding cut), norms and
residual adds run there, each mixer and FFN takes its normed input
gathered whole (``ctx.seq_gather``) and gives back the rank's positions
of its output (``ctx.split_stream``: its sum a reduce-scatter, a whole
output cut), and the final norm and head get the whole stream back by one
gather. The layers, the caches and the logits are those of the whole
stream; the norms' and the gates' weights, applied to the rank's
positions, are entered (``ctx.enter``: their gradients summed over the
model axis). The multi-draft verify step never splits, as in JAX.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.attention import (KVCache, PagedKVCache, attention,
                                          cached_attention, cross_attention)
from repro_torch.models.layers import (apply_norm, embed, embed_init, ffn,
                                       ffn_init, logits_init, norm_init,
                                       rope_tables, unembed, vocab_logits)
from repro_torch.sharding import ctx

RECURRENT = ("mamba", "rwkv")
_NEEDS = {"moe": "moe", "mamba": "mamba", "rwkv": "rwkv"}
_AUX = ("moe_aux_loss", "moe_z_loss")   # the MoE losses apply() sums


def check_pattern(cfg: ModelConfig) -> None:
    """Refuse a config this model cannot build: the seq2seq family, an
    unknown layer or FFN kind, a kind without its sub-config."""
    if cfg.family == "seq2seq":
        raise ValueError(f"{cfg.name}: family 'seq2seq' is the Molecular "
                         f"Transformer (repro_torch.models.seq2seq)")
    for k in cfg.layer_pattern + cfg.ffn_pattern:
        if k not in ("attn", "xattn", "mamba", "rwkv", "dense", "moe"):
            raise ValueError(f"{cfg.name}: unknown layer kind {k!r}")
        if k in _NEEDS and getattr(cfg, _NEEDS[k]) is None:
            raise ValueError(f"{cfg.name}: layer kind {k!r} needs "
                             f"ModelConfig.{_NEEDS[k]}")


def check_serves(cfg: ModelConfig) -> None:
    """``check_pattern``, and refuse the audio encoder (no decode step)."""
    check_pattern(cfg)
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name}: encoder-only architecture: no decode "
                         f"step")


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
    elif kind == "xattn":
        p["attn"] = attn_mod.attn_init(gen, cfg, device=dev, cross=True)
        p["xattn_gate"] = torch.zeros((1,), device=dev)  # gated cross-attn
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
    with no host copy (full-width models), and its numbers are its own.
    ``device="meta"`` draws nothing (``gen`` may be None): shapes and
    dtypes only, the counterpart of ``jax.eval_shape(init)``, for a dry
    run of a model no host could hold.
    The audio encoder takes frame embeddings and has no token embedding."""
    check_pattern(cfg)
    dev = resolve_device(device)
    params = {}
    if cfg.family != "audio":
        params["tok"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dev)
    params["blocks"] = tuple([_block_init(gen, cfg, kind, cfg.ffn_pattern[i],
                                          dev)
                              for _ in range(cfg.n_repeats)]
                             for i, kind in enumerate(cfg.layer_pattern))
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = logits_init(gen, cfg.d_model, cfg.vocab_size, dev)
    return params


# ---------------------------------------------------------------------------
# caches


def local_widths(params, cfg: ModelConfig) -> dict:
    """The per-channel widths a params tree holds (a mesh rank's shard, or
    the whole model): Mamba's ``d_inner``, RWKV's heads and the
    cross-attention positions' heads, for ``init_cache(widths=)``.
    ``d_model`` is never cut: the token shift's inputs stay whole."""
    out = {}
    for kind, blocks in zip(cfg.layer_pattern, params["blocks"]):
        p = blocks[0]
        if kind == "mamba":
            out["d_inner"] = int(p["mamba"]["conv_b"].shape[0])
        elif kind == "rwkv":
            out["rwkv_heads"] = int(p["rwkv"]["u"].shape[0])
        elif kind == "xattn":
            out["xattn_heads"] = int(p["attn"]["wq"]["w"].shape[1]
                                     // cfg.head_dim)
    return out


def _state_init(cfg: ModelConfig, kind: str, batch: int, dev, dtype,
                widths: dict) -> dict:
    """One layer's zero recurrent state, (B, ...) leaves, at ``widths``."""
    if kind == "mamba":
        return mamba_mod.init_mamba_cache(cfg, batch, device=dev, dtype=dtype,
                                          d_inner=widths.get("d_inner"))
    H, hd = rwkv_mod._heads(cfg)
    H = widths.get("rwkv_heads", H)
    return {"S": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=dev),
            "x_tm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=dev),
            "x_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=dev)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, paged=None, device=None,
               widths: dict | None = None) -> tuple:
    """One cache per pattern position, stacked over repeats (leading axis).

    ``paged``: ``(n_pages, page_size)`` allocates each attention position's
    cache as a ``PagedKVCache`` (one pool per layer, every layer's block
    table identical, one page-id space) whose pages the caller maps.
    Recurrent state stays dense: it is O(1) in sequence length a row; so
    does a cross-attention position's memory K/V (zeros of
    ``max(memory_tokens, 1)`` slots until ``prefill(memory=)`` writes it,
    as in the JAX package). ``widths``: the channels a mesh rank holds
    (``local_widths``: ``d_inner``, ``rwkv_heads``, ``xattn_heads``),
    default the model's; attention heads come from ``cfg``."""
    check_pattern(cfg)
    dev = resolve_device(device)
    R = cfg.n_repeats
    widths = widths or {}

    def stack(a):
        return a.expand(R, *a.shape).contiguous()

    caches = []
    for kind in cfg.layer_pattern:
        if kind in RECURRENT:
            caches.append({k: stack(v) for k, v in
                           _state_init(cfg, kind, batch, dev, dtype,
                                       widths).items()})
        elif kind == "xattn":
            shape = (R, batch, max(cfg.memory_tokens, 1),
                     widths.get("xattn_heads", cfg.n_heads), cfg.head_dim)
            caches.append({k: torch.zeros(shape, dtype=dtype, device=dev)
                           for k in ("mk", "mv")})
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
    become (R, B, ...). Attention and memory caches pass through."""
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


def _normed(p_norm: dict, cfg: ModelConfig, x, seq: int):
    """A mixer's or FFN's input: ``x`` normed, whole along T (on a stream
    split ``seq`` ways, this rank's positions normed, the norm's weights
    entered, then gathered)."""
    if seq == 1:
        return apply_norm(p_norm, x, cfg.norm)
    return ctx.seq_gather(apply_norm(ctx.enter_tree(p_norm), x, cfg.norm))


def _rwkv_decode_ckpt(p, cfg: ModelConfig, state: dict, x, ckpt: dict,
                      seq: int = 1):
    """A whole RWKV block over T fed tokens, writing the state after each
    into ``ckpt`` (leaves (B, T+1, ...), index 0 the state before the
    step). Within a block token t reads only the inputs and the WKV state,
    so the projections run over the T tokens at once and only the state
    update loops (``rwkv_mixer``)."""
    for k, v in state.items():
        ckpt[k][:, 0] = v
    n1 = _normed(p["norm1"], cfg, x, seq)
    mix, _ = rwkv_mod.rwkv_mixer(p["rwkv"], cfg, n1, state=state["S"],
                                 x_last=state["x_tm"],
                                 states_out=ckpt["S"][:, 1:])
    x = x + mix
    n2 = _normed(p["norm2"], cfg, x, seq)
    cm, _ = rwkv_mod.rwkv_channel_mix(p["cmix"], n2, x_last=state["x_cm"])
    ckpt["x_tm"][:, 1:] = n1
    ckpt["x_cm"][:, 1:] = n2
    return x + cm


def _rwkv_prefill(p, cfg: ModelConfig, state: dict, x, lengths,
                  seq: int = 1):
    """A whole RWKV block over the prompt; the state at each row's last
    valid token is written into ``state`` (views of the cache) in place."""
    n1 = _normed(p["norm1"], cfg, x, seq)
    B, T = n1.shape[:2]
    valid = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    n1 = n1 * valid[..., None].to(x.dtype)
    mix, (S, _) = rwkv_mod.rwkv_mixer(p["rwkv"], cfg, n1, state=state["S"],
                                      x_last=state["x_tm"], lengths=lengths)
    x = x + mix
    n2 = _normed(p["norm2"], cfg, x, seq)
    cm, _ = rwkv_mod.rwkv_channel_mix(p["cmix"], n2)
    rows = torch.arange(B, device=x.device)
    last = (lengths.long() - 1).clamp(0, T - 1)
    for k, v in (("S", S), ("x_tm", n1[rows, last]), ("x_cm", n2[rows, last])):
        state[k].copy_(v)
    return x + cm


def _mamba_decode_ckpt(p, cfg: ModelConfig, state: dict, h, ckpt: dict):
    """Mamba over T fed tokens in order (``mamba_step``), writing the
    state after each into ``ckpt``."""
    for k, v in state.items():
        ckpt[k][:, 0] = v
    y, _ = mamba_mod.mamba_step(p, cfg, state, h,
                                states_out={k: v[:, 1:]
                                            for k, v in ckpt.items()})
    return y


# ---------------------------------------------------------------------------
# stack


def _ffn(p, cfg: ModelConfig, kind: str, x):
    if kind == "moe":
        return moe_mod.moe_ffn(p, cfg, x)[0]
    return ffn(p, x)


def _xattn(p, cfg: ModelConfig, h, layer_cache, memory, memory_mask):
    """A cross-attention position's gated output: prefill (``memory``
    given) attends to the memory and writes its K/V into ``layer_cache``
    (views of the stacked cache) in place; decode reads that K/V."""
    if memory is None:
        q = attn_mod.cached_cross_attention(p["attn"], cfg, h, layer_cache,
                                            memory_mask=memory_mask)
    else:
        q = cross_attention(p["attn"], cfg, h, memory,
                            memory_mask=memory_mask)
        for k, v in attn_mod.memory_kv(p["attn"], cfg, memory).items():
            layer_cache[k].copy_(v)
    return torch.tanh(ctx.on_positions(p["xattn_gate"])) * q


def _run_stack(params, cfg: ModelConfig, x, cache, positions, *,
               lengths=None, memory=None, memory_mask=None, seq: int = 1):
    """Every layer in order (repeat-major, as the JAX scan runs them).
    Attention writes its K/V into the cache in place; the rotary tables of
    the positions are made once for all layers.

    Recurrent positions: with ``lengths`` (B,) (prefill) each runs over
    the whole prompt and writes its state at each row's end into the cache
    in place; without (decode), each runs over the fed tokens in order and
    the state after every one goes into fresh checkpoints (R, B, T+1, ...).
    Cross-attention positions attend to ``memory`` (prefill) or to its K/V
    in the cache (decode), under ``memory_mask``. ``seq``: the parts the
    stream ``x`` is split into along T (``x`` this rank's positions).
    Returns (x, cache with those checkpoints)."""
    positions = positions.to(torch.int32).contiguous()
    rope = (rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.pos == "rope" and "attn" in cfg.layer_pattern else None)
    B, T = positions.shape
    out = list(cache)
    if lengths is None:
        for i, kind in enumerate(cfg.layer_pattern):
            if kind in RECURRENT:
                out[i] = {k: v.new_empty((v.shape[0], B, T + 1, *v.shape[2:]))
                          for k, v in cache[i].items()}
    with ctx.split_stream(seq > 1):
        for r in range(cfg.n_repeats):
            for i, kind in enumerate(cfg.layer_pattern):
                ckpt = (_layer(out[i], r) if lengths is None
                        and kind in RECURRENT else None)
                x = _stack_block(params["blocks"][i][r], cfg, kind,
                                 cfg.ffn_pattern[i], x, _layer(cache[i], r),
                                 ckpt, positions, rope=rope, lengths=lengths,
                                 memory=memory, memory_mask=memory_mask,
                                 seq=seq)
    return x, (cache if lengths is not None or not recurrent(cfg)
               else tuple(out))


def _stack_block(p, cfg: ModelConfig, kind: str, ffn_kind: str, x, layer,
                 ckpt, positions, *, rope, lengths, memory, memory_mask,
                 seq: int):
    """One layer of ``_run_stack``: its cache ``layer`` (views) written in
    place, a recurrent decode's states into ``ckpt``."""
    if kind == "rwkv":
        return (_rwkv_prefill(p, cfg, layer, x, lengths, seq)
                if lengths is not None else
                _rwkv_decode_ckpt(p, cfg, layer, x, ckpt, seq))
    h = _normed(p["norm1"], cfg, x, seq)
    if kind == "attn":
        a, _ = cached_attention(p["attn"], cfg, h, layer, positions,
                                rope=rope)
    elif kind == "xattn":
        a = _xattn(p, cfg, h, layer, memory, memory_mask)
    elif lengths is not None:
        a, st = mamba_mod.mamba_mixer(p["mamba"], cfg, h, lengths=lengths,
                                      return_state=True)
        for k, v in layer.items():
            v.copy_(st[k])
    else:
        a = _mamba_decode_ckpt(p["mamba"], cfg, layer, h, ckpt)
    x = x + a
    return x + _ffn(p["ffn"], cfg, ffn_kind, _normed(p["norm2"], cfg, x, seq))


def _logits_out(params, cfg: ModelConfig, x):
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if cfg.tie_embeddings:
        return unembed(params["tok"], x)
    return vocab_logits(params["lm_head"], x)


# ---------------------------------------------------------------------------
# public API


def _stream_in(params, tokens, embeddings):
    """(the residual stream's input, the parts it is split into along T):
    the embedded tokens or the frame ``embeddings``, on a stream split
    ``seq`` ways (``ctx.seq_shards``) this rank's positions of them (a
    vocab-split embedding's sum a reduce-scatter, a whole one cut)."""
    seq = ctx.seq_shards((tokens if embeddings is None
                          else embeddings).shape[1])
    with ctx.split_stream(seq > 1):
        x = (ctx.out_part(embeddings) if embeddings is not None
             else embed(params["tok"], tokens))
    return x, seq


def _stream_out(x, seq: int):
    """The stream whole along T again, for the final norm and the head."""
    return x if seq == 1 else ctx.seq_gather(x)


def _full_block(kind: str, ffn_kind: str, p, cfg: ModelConfig, x, *,
                causal: bool, positions, pad, lengths, rope, memory,
                memory_mask, seq: int = 1):
    """One layer of the full-sequence forward (``x``: this rank's
    positions on a stream split ``seq`` ways, inside ``ctx.split_stream``).
    Returns (x, aux)."""
    if kind == "rwkv":
        # zero the pad positions (of the whole sequence) so the state
        # skips them
        n1 = _normed(p["norm1"], cfg, x, seq)
        if pad is not None:
            n1 = n1 * pad[..., None].to(n1.dtype)
        mix, _ = rwkv_mod.rwkv_mixer(p["rwkv"], cfg, n1, lengths=lengths)
        x = x + mix
        cm, _ = rwkv_mod.rwkv_channel_mix(p["cmix"],
                                          _normed(p["norm2"], cfg, x, seq))
        return x + cm, {}
    h = _normed(p["norm1"], cfg, x, seq)
    if kind == "attn":
        x = x + attention(p["attn"], cfg, h, positions=positions,
                          causal=causal, padding_mask=pad, rope=rope)
    elif kind == "xattn":
        x = x + torch.tanh(ctx.on_positions(p["xattn_gate"])) * \
            cross_attention(p["attn"], cfg, h, memory,
                            memory_mask=memory_mask)
    else:
        x = x + mamba_mod.mamba_mixer(p["mamba"], cfg, h, lengths=lengths)
    h2 = _normed(p["norm2"], cfg, x, seq)
    if ffn_kind == "moe":
        out, aux = moe_mod.moe_ffn(p["ffn"], cfg, h2)
        return x + out, aux
    return x + ffn(p["ffn"], h2), {}


def apply(params, cfg: ModelConfig, tokens=None, *, embeddings=None,
          memory=None, memory_mask=None, lengths=None, positions=None,
          causal=None, remat: bool = False):
    """Full-sequence forward (training). Returns (logits (B, T, V), aux).

    tokens: (B, T), or ``embeddings`` (B, T, d) (the audio encoder's
    frames); ``memory`` (B, M, memory_dim) and ``memory_mask`` (B, M) for
    the cross-attention positions; ``lengths`` (B,) valid tokens a row (a
    padding mask on the keys; recurrent mixers skip the pads);
    ``positions`` (B, T) absolute, default ``arange(T)`` (left as None to
    the attention kernels, which then mask by index); ``causal`` defaults
    to ``cfg.causal``. ``aux`` holds ``moe_aux_loss`` and ``moe_z_loss``
    summed over the layers on a pattern with MoE FFNs, else nothing.
    ``remat`` recomputes each repeat's activations in the backward
    (``torch.utils.checkpoint``): equal results, less memory."""
    check_pattern(cfg)
    x, seq = _stream_in(params, tokens, embeddings)
    T = x.shape[1] * seq
    causal = cfg.causal if causal is None else causal
    pad = None
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=x.device)
        pad = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    if positions is not None:
        positions = positions.to(device=x.device,
                                 dtype=torch.int32).contiguous()
    rope = None
    if cfg.pos == "rope" and "attn" in cfg.layer_pattern:
        rp = (positions if positions is not None else
              torch.arange(T, dtype=torch.int32, device=x.device)[None])
        rope = rope_tables(rp, cfg.head_dim, cfg.rope_theta)
    kw = dict(causal=causal, positions=positions, pad=pad, lengths=lengths,
              rope=rope, memory=memory, memory_mask=memory_mask, seq=seq)
    keys = _AUX if "moe" in cfg.ffn_pattern else ()

    def repeat(r: int, h):
        """Repeat ``r`` of the pattern: (h, its summed aux losses)."""
        sums = [h.new_zeros((), dtype=torch.float32) for _ in keys]
        with ctx.split_stream(seq > 1):
            for i, kind in enumerate(cfg.layer_pattern):
                h, aux = _full_block(kind, cfg.ffn_pattern[i],
                                     params["blocks"][i][r], cfg, h, **kw)
                sums = [a + aux[k] if k in aux else a
                        for a, k in zip(sums, keys)]
        return (h, *sums)

    totals = [x.new_zeros((), dtype=torch.float32) for _ in keys]
    tp = ctx.current()

    def recomputed(r: int, h):
        """``repeat`` as the backward recomputes it: whole (no early stop,
        so a mesh rank reissues every collective of its forward) and under
        this rank's tensor-parallel context (on the card the backward runs
        on autograd's own thread, where no context is set; the stream's
        split, ``seq``, was decided once, here, and ``repeat`` sets the
        split-stream block itself)."""
        with ctx.tensor_parallel(tp):
            return repeat(r, h)

    for r in range(cfg.n_repeats):
        if remat:
            with set_checkpoint_early_stop(False):
                out = checkpoint(recomputed, r, x, use_reentrant=False)
        else:
            out = repeat(r, x)
        x = out[0]
        totals = [t + a for t, a in zip(totals, out[1:])]
    return (_logits_out(params, cfg, _stream_out(x, seq)),
            dict(zip(keys, totals)))


def _fit_memory(cfg: ModelConfig, cache, memory):
    """The cache with each cross-attention position's memory K/V sized to
    ``memory``'s M tokens (new zeros where the cache holds another M; the
    JAX package's prefill replaces the entry whatever its size)."""
    out = list(cache)
    M = memory.shape[1]
    for i, kind in enumerate(cfg.layer_pattern):
        c = cache[i]
        if kind == "xattn" and c["mk"].shape[2] != M:
            shape = (*c["mk"].shape[:2], M, *c["mk"].shape[3:])
            out[i] = {k: c[k].new_zeros(shape) for k in c}
    return tuple(out)


def prefill(params, cfg: ModelConfig, cache, tokens=None, *,
            embeddings=None, memory=None, memory_mask=None, lengths=None,
            logits_mode: str = "all"):
    """Write the prompt into the cache, in place. Returns (logits, cache).

    tokens: (B, T) (or ``embeddings`` (B, T, d)); ``lengths`` (B,) valid
    tokens per row (default T): positions past a row's length are -1, so
    their K/V land in the throwaway slot, and recurrent state stops at each
    row's length. ``memory`` (B, M, memory_dim): the cross-attention
    positions attend to it and keep its K/V in the cache (``memory_mask``
    (B, M) masks it). ``logits_mode="last"`` gives (B, V) at each row's
    last valid position instead of (B, T, V)."""
    if logits_mode not in ("all", "last"):
        raise ValueError(f"logits_mode {logits_mode!r}")
    x, seq = _stream_in(params, tokens, embeddings)
    B, T = x.shape[0], x.shape[1] * seq
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=x.device)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=x.device)
    pos = torch.arange(T, dtype=torch.int32, device=x.device)[None, :]
    positions = torch.where(pos < lengths[:, None], pos, -1)
    if memory is not None:
        cache = _fit_memory(cfg, cache, memory)
    x, cache = _run_stack(params, cfg, x, cache, positions, lengths=lengths,
                          memory=memory, memory_mask=memory_mask, seq=seq)
    x = _stream_out(x, seq)
    if logits_mode == "last":
        last = (lengths - 1).clamp(0, T - 1).long()
        x = x[torch.arange(B, device=x.device), last]
    return _logits_out(params, cfg, x), cache


def decode_step(params, cfg: ModelConfig, cache, tokens, positions, *,
                memory_mask=None):
    """Feed T new tokens per row (T = 1 for greedy, DL+1 to verify) at
    ``positions`` (B, T) (rows may differ; -1 = a pad token). Returns
    (logits (B, T, V), cache): attention K/V written in place, recurrent
    positions as per-step checkpoints for ``commit_cache``; cross-attention
    positions read the memory K/V ``prefill`` kept, under ``memory_mask``
    (B, M)."""
    x, seq = _stream_in(params, tokens, None)
    x, cache = _run_stack(params, cfg, x, cache, positions,
                          memory_mask=memory_mask, seq=seq)
    return _logits_out(params, cfg, _stream_out(x, seq)), cache


def write_prompt(params, cfg: ModelConfig, cache, tokens, positions,
                 n_valid):
    """``decode_step`` without the output head, committed: write the K/V
    of ``tokens`` at ``positions`` into the cache and keep each row's
    recurrent state after its first ``n_valid`` (B,) tokens (a chunked
    prefill, whose logits nobody reads; ``n_valid`` 0 leaves the row's
    state bitwise as it was). Returns the cache, written in place."""
    x, seq = _stream_in(params, tokens, None)
    _, ckpt = _run_stack(params, cfg, x, cache, positions, seq=seq)
    if recurrent(cfg):
        for kind, c, kept in zip(cfg.layer_pattern, cache,
                                 commit_cache(cfg, ckpt, n_valid)):
            if kind in RECURRENT:
                for k, v in c.items():
                    v.copy_(kept[k])
    return cache


def multidraft_verify_step(params, cfg: ModelConfig, cache, tokens,
                           positions, local_mask, *, memory_mask=None):
    """Single-pass verification of ALL drafts (``attention.
    multidraft_attention``) over a dense cache. tokens: (B, 1 + N_d·DL) =
    [last committed, draft 0 ..., draft N_d-1 ...]; positions: their
    absolute positions; local_mask: the (T, T) segment mask.

    Attention patterns only (dense or MoE FFNs; cross-attention positions
    read their memory K/V under ``memory_mask``): a recurrent mixer runs
    its tokens in order, so drafts cannot share its row; those patterns
    use the expanded-batch verify path, as in the JAX package.

    Returns (logits (B, T, V), local_kv): local_kv holds, per pattern
    position, the fed tokens' (k, v) stacked over repeats, for
    ``commit_multidraft`` (empty at a cross-attention position). The cache
    is not modified."""
    check_serves(cfg)
    refuse_recurrent(cfg, "multi-draft verification")
    positions = positions.to(torch.int32).contiguous()
    rope = (rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.pos == "rope" else None)
    x = embed(params["tok"], tokens)
    kvs = [([], []) for _ in cfg.layer_pattern]
    for r in range(cfg.n_repeats):
        for i, kind in enumerate(cfg.layer_pattern):
            p = params["blocks"][i][r]
            h = apply_norm(p["norm1"], x, cfg.norm)
            if kind == "xattn":
                x = x + _xattn(p, cfg, h, _layer(cache[i], r), None,
                               memory_mask)
                k = v = x.new_zeros((0,))
            else:
                a, (k, v) = attn_mod.multidraft_attention(
                    p["attn"], cfg, h, _layer(cache[i], r), positions,
                    local_mask, rope=rope)
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
    for kind, c, (k, v) in zip(cfg.layer_pattern, cache, local_kv):
        if kind != "attn":
            continue   # the memory K/V stays as prefill wrote it
        for r in range(cfg.n_repeats):
            attn_mod.commit_verified_kv(_layer(c, r), k[r], v[r], take_idx,
                                        positions, n_keep)
    return cache
