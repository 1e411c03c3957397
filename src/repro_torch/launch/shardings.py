"""Sharding specs for params (FSDP + tensor parallel), optimizer state,
batches, decode caches and a serving session's state: the port of
``repro.launch.shardings``, as spec functions (a spec is a tuple of
mesh-axis names or None per tensor dim, ``repro_torch.sharding.rules``).

Cache layout reminders (leaves carry a leading layer / repeat dim R):
  attn KVCache : k/v (R, B, S, Kv, hd), pos (R, B, S)
  xattn        : mk/mv (R, B, M, H, hd)
  mamba        : conv (R, B, d_conv-1, d_inner), ssm (R, B, d_inner, d_state)
  rwkv         : S (R, B, H, hd, hd), x_tm/x_cm (R, B, d)

Decode caches shard batch over the data axes; the KV sequence dim shards
over 'model' (a sequence-sharded cache), because GQA KV heads (8) do not
divide the 16-way model axis.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import dp_axes
from repro_torch.models.attention import KVCache, PagedKVCache
from repro_torch.sharding import rules

_MODEL = rules.MODEL


def _maybe(mesh, dim: int, axes):
    """``axes`` (one name when one) if ``dim`` divides by their size, else
    None (replicate)."""
    if not axes:
        return None
    if dim % rules.axes_size(mesh, tuple(axes)):
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def _repl(ndim: int) -> tuple:
    return (None,) * ndim


def param_shardings(params, mesh, *, fsdp: bool = True):
    """``fsdp=False`` keeps params tensor-parallel only (replicated over the
    data axes): the right layout for decode, where a per-step FSDP gather
    would move the whole parameter footprint every step."""
    return rules.param_pspecs(params, mesh,
                              fsdp_axes=dp_axes(mesh) if fsdp else ())


def serving_param_shardings(params, cfg, mesh):
    """Tensor-parallel specs that execute exactly on a serving mesh: the
    JAX package's serving specs (``repro.launch.shardings``), which are
    the rules' specs (``repro_torch.sharding.rules``) with one departure,
    plus one of the port's own:

    - Q/K/V projections whose head count does not divide the model axis
      stay whole (a split that cuts inside ``head_dim`` would split RoPE's
      rotation pairs). The count is ``n_heads`` for ``wq``, ``n_kv_heads``
      for ``wk`` / ``wv``, by name, wherever they sit: a cross-attention
      position's whole ``wk`` / ``wv`` beside a split ``wq`` are cut to the
      rank's heads when used, and RWKV's ``wr`` / ``wg``, split inside its
      heads where ``wk`` / ``wv`` stay whole, are gathered whole
      (``models.rwkv``);
    - every Mamba leaf stays whole where ``d_inner`` does not divide the
      model axis (the rules would still split the fused ``w_in``, whose
      width is twice ``d_inner``, and nothing else).

    The rules' layouts the layers rely on: Mamba's fused ``w_in``
    (``(d, 2 * d_inner)``) keeps its spec ``(None, MODEL)`` but is not cut
    contiguously: ``serving_shard`` gives each rank its x-columns AND its
    z-columns, where a contiguous cut would hand rank 0 all of x and rank
    1 all of z; ``wo`` / ``w_out`` / ``w_xdbc`` are row-parallel;
    ``w_dt``, ``conv_*``, ``A_log``, ``D`` and RWKV's ``u`` split by
    channel or head; the stacked experts split on their expert dim where
    ``n_experts`` divides the model axis (else every rank holds every
    expert and the MoE output needs no sum); the router, ``w_base``, the
    LoRA, ``ln_x`` and the gates stay whole; the vocabulary splits."""
    model = rules.axis_sizes(mesh).get(_MODEL, 1)
    heads = {"wq": int(getattr(cfg, "n_heads", 1) or 1),
             "wk": int(getattr(cfg, "n_kv_heads", 0)
                       or getattr(cfg, "n_heads", 1) or 1)}
    heads["wv"] = heads["wk"]
    mamba_whole = getattr(cfg, "mamba", None) is not None and bool(
        (cfg.mamba.expand * cfg.d_model) % model)

    def one(path, leaf):
        names = rules.path_names(path)
        parent = names[-2] if len(names) >= 2 else ""
        if parent in heads and heads[parent] % model:
            return _repl(len(leaf.shape))
        if mamba_whole and "mamba" in names:
            return _repl(len(leaf.shape))
        return rules.leaf_pspec(path, leaf.shape, mesh)

    return rules.tree_map_with_path(one, params)


def serving_shard(path, t, spec: tuple, index: int, size: int):
    """Shard ``index`` of ``size`` of the leaf ``t`` at ``path`` under its
    ``serving_param_shardings`` spec: contiguous chunks of every dim the
    spec splits over the model axis (``rules.shard_tensor``), except
    Mamba's fused ``w_in``, whose x- and z-halves are each cut and put
    side by side (a view only where the spec keeps it whole)."""
    names = rules.path_names(path)
    if (rules.split_dims(spec, _MODEL) and "mamba" in names
            and names[-2:] == ["w_in", "w"]):
        halves = t.reshape(t.shape[0], 2, t.shape[1] // 2)
        return rules.shard_tensor(halves, (None, None, _MODEL), _MODEL,
                                  index, size).reshape(t.shape[0], -1)
    return rules.shard_tensor(t, spec, _MODEL, index, size)


def lay_out_params(params, cfg, mesh, tp, device):
    """This rank's shard of every weight (``serving_param_shardings``, cut
    by ``serving_shard``) on ``device``, with the split weights recorded
    in ``tp`` (a ``repro_torch.sharding.ctx.TensorParallel``) for the
    layers' collectives: ``wo`` / ``w_out`` / ``w_xdbc`` input dim split
    (``row_split``), ``embed`` / ``w_vocab`` vocabulary split
    (``vocab_split``), the stacked experts expert dim split
    (``expert_split``). A shard that is a view of a weight on ``device``
    is copied, so the whole weight can be freed.

    ``mesh`` may be a ``launch.mesh.MeshShape`` and ``tp`` a recorder
    (``sharding.ctx.recording_tensor_parallel``: a rank's coordinates, no
    process group), with ``params`` and ``device`` on meta: a dry run's
    rank 0 (``launch.steps``). The model-axis cut is the serving one for
    both layouts: the dry run's ``param_shardings(fsdp=...)`` splits the
    same dims over ``model`` except where a split would cut inside a head
    (or leave Mamba's fused ``w_in`` with a ``d_inner`` that does not
    divide), which a rank runs whole, and its data-axis FSDP split is
    gathered before a layer runs."""
    specs = serving_param_shardings(params, cfg, mesh)
    row, vocab, expert = set(), set(), set()

    def one(path, t):
        spec = specs
        for k in path:
            spec = spec[k]
        local = serving_shard(path, t, spec, tp.rank, tp.size).to(device)
        local = local.contiguous() if local._base is None else local.clone()
        names = rules.path_names(path)
        if rules.split_dims(spec, _MODEL):
            if "experts" in names:
                expert.add(id(local))
            elif names[-1] == "w" and names[-2] in ("wo", "w_out", "w_xdbc"):
                row.add(id(local))
            if names[-1] in ("embed", "w_vocab"):
                vocab.add(id(local))
        return local

    out = rules.tree_map_with_path(one, params)
    tp.row_split, tp.vocab_split = frozenset(row), frozenset(vocab)
    tp.expert_split = frozenset(expert)
    return out


def local_cache_cfg(cfg: ModelConfig, tp) -> ModelConfig:
    """``cfg`` with the attention heads a model rank's cache holds
    (``tp``: its ``TensorParallel``): the heads split where they divide
    the model axis, else whole; the kv heads its query heads read."""
    from repro_torch.sharding.ctx import kv_heads_for

    H, Kv = cfg.n_heads, cfg.n_kv_heads
    Hl = H // tp.size if H % tp.size == 0 else H
    if Kv % tp.size == 0:
        Kvl = Kv // tp.size
    else:
        lo, hi = kv_heads_for(tp.rank, Hl, H, Kv)
        Kvl = hi - lo
    return dataclasses.replace(cfg, n_heads=Hl, n_kv_heads=Kvl)


def opt_shardings(opt_state, params, mesh):
    """Adam's moments follow the FSDP param specs; its step replicates."""
    pspec = rules.param_pspecs(params, mesh, fsdp_axes=dp_axes(mesh))
    return type(opt_state)(step=(), mu=pspec, nu=pspec)


def batch_shardings(batch, mesh):
    dp = dp_axes(mesh)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        return (_maybe(mesh, shape[0], dp), *_repl(len(shape) - 1))

    return rules.tree_map_with_path(one, batch)


def _shard_one_axis(mesh, shape, axis: int, axes) -> tuple:
    """A spec splitting exactly dim ``axis`` (when it divides)."""
    spec = list(_repl(len(shape)))
    spec[axis] = _maybe(mesh, shape[axis], axes)
    return tuple(spec)


def serving_state_shardings(gstate, mesh):
    """Specs for a serving ``GroupedState``. Every per-slot leaf of a
    group's ``SessionState`` splits its slot axis over the data axes (the
    engine makes each group's slots divide them); paged pools split their
    page axis (one contiguous segment per data shard); dense K/V rows
    split by row; the block tables, and any leaf that does not divide,
    replicate."""
    dp = dp_axes(mesh)

    def group_leaf(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            return ()
        return _shard_one_axis(mesh, shape, 0, dp)

    def cache_node(node):
        if isinstance(node, PagedKVCache):
            pool = _shard_one_axis(mesh, tuple(node.k_pool.shape),
                                   node.k_pool.ndim - 4, dp)
            return PagedKVCache(
                k_pool=pool, v_pool=pool,
                pos=_shard_one_axis(mesh, tuple(node.pos.shape),
                                    node.pos.ndim - 2, dp),
                block_tables=_repl(node.block_tables.ndim))
        if isinstance(node, KVCache):
            kv = _shard_one_axis(mesh, tuple(node.k.shape), node.k.ndim - 4,
                                 dp)
            return KVCache(k=kv, v=kv,
                           pos=_shard_one_axis(mesh, tuple(node.pos.shape),
                                               node.pos.ndim - 2, dp))
        if isinstance(node, dict):
            return {k: cache_node(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(cache_node(v) for v in node)
        return _repl(node.ndim)

    groups = tuple(
        type(gs)(*(None if v is None else
                   rules.tree_map_with_path(group_leaf, v)
                   for v in gs)) for gs in gstate.groups)
    return type(gstate)(groups=groups, cache=cache_node(gstate.cache))


def cache_shardings(cache, cfg: ModelConfig, mesh):
    """Per-pattern-position cache specs (a tuple aligned with the cache)."""
    dp = dp_axes(mesh)
    out = []
    for kind, c in zip(cfg.layer_pattern, cache):
        if kind == "attn":
            B, S = c.k.shape[1], c.k.shape[2]
            b = _maybe(mesh, B, dp)
            s = _maybe(mesh, S, (_MODEL,))
            kv = (None, b, s, None, None)
            out.append(KVCache(k=kv, v=kv, pos=(None, b, s)))
        elif kind == "xattn":
            B = c["mk"].shape[1]
            b = _maybe(mesh, B, dp)
            h = _maybe(mesh, c["mk"].shape[3], (_MODEL,))
            out.append({"mk": (None, b, None, h, None),
                        "mv": (None, b, None, h, None)})
        elif kind == "mamba":
            b = _maybe(mesh, c["conv"].shape[1], dp)
            di = _maybe(mesh, c["ssm"].shape[2], (_MODEL,))
            out.append({"conv": (None, b, None, di),
                        "ssm": (None, b, di, None)})
        elif kind == "rwkv":
            b = _maybe(mesh, c["S"].shape[1], dp)
            h = _maybe(mesh, c["S"].shape[2], (_MODEL,))
            out.append({"S": (None, b, h, None, None),
                        "x_tm": (None, b, None),
                        "x_cm": (None, b, None)})
        else:
            raise ValueError(kind)
    return tuple(out)
