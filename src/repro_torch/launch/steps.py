"""Per-(arch x input-shape) step builders for the dry run and the card:
the port of ``repro.launch.steps``.

Every spec is a meta tensor (``torch.empty(..., device="meta")``, the
counterpart of ``jax.ShapeDtypeStruct``): nothing is allocated for a
full-size config, so a dry run plans Llama-4-Maverick in one process.
A ``BuiltStep`` holds the step function, its inputs as meta tensors of the
global shapes, their in/out specs (``launch.shardings``'s spec tuples),
the global outputs (the counterpart of ``jax.eval_shape(fn, *inputs)``)
and ``local_inputs``, rank 0's inputs, which ``fn`` takes.

On a mesh of one rank ``fn`` is the step itself: on real tensors (the
card, or the CPU when the tests ask) it runs the port's step and its
kernels; on meta tensors it propagates shapes. On a planned mesh of more
ranks (a ``MeshShape``, no process group) ``fn`` runs rank 0's step at its
local widths (``launch.shardings.lay_out_params``: the model-axis cut a
serving rank runs, where a head that does not divide the axis stays
whole) under a recording ``TensorParallel`` (``sharding.ctx``), which
records each collective of the layers; ``fsdp_records`` holds the FSDP
traffic of the specs (each data-sharded leaf gathered at the model-local
size a rank holds, in a train step its gradient reduce-scattered, each
replicated leaf's gradient all-reduced over the data axes).

On a world of ranks (a ``DeviceMesh`` of more than one rank, every rank
calling ``build_step`` alike) the serving kinds run live: each rank holds
``lay_out_params``' model-axis cut under the mesh's live
``TensorParallel`` and, with FSDP params, only its data-axis shard of each
leaf the specs split over the data axes; ``fn`` all-gathers those leaves
over the data group once a step before the model runs, and returns the
rank's part of each output (its rows; the logits' vocabulary cut where the
out spec splits it; its cache's heads). ``example_inputs`` draws the
global inputs from the seed as for one rank and cuts out the rank's part
(``rank_part``), so the one-rank step on the same seed is the reference
(``rank_outputs`` cuts its outputs alike). The train kinds run live too:
the rank's params and Adam moments are its shards; the train step
gathers the FSDP leaves itself (``ctx.layers_params``, by the layout
``_Local`` sets on the rank's context), its backward sums over the model
axis where the layers ask (``ctx.enter``), and it reduces its gradients
over the data axis in tree order (``ctx.reduce_gradients``: FSDP leaves
reduce-scattered, the others all-reduced), sums its token count and
metrics there and takes the global norm of the whole params before Adam
updates its shards. The plan holds the same collectives: the recorder
records the layers' (a remat'd forward's again in the backward), the
conjugates and the scalar sums where the live context issues them, and
``fsdp_records`` the gathers and the gradient reduction.

Input shapes:
  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> prefill (last-token logits)
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token,
                                                 KV cache of seq_len)
  long_500k    seq 524,288 global_batch 1     -> serve_step; sub-quadratic
               attention required: SSM/hybrid run natively, dense/MoE/VLM
               run the sliding-window variant (window 8192), encoder-only
               audio is skipped (no decode step exists)

Sequence sharding: a step built and run under ``sharding.ctx.
activation_rules(mesh, batch=("data",), seq=("model",))`` splits the
decoder-only residual stream along T over the model axis wherever the axis
divides the step's T (``models.transformer``; train_4k and prefill_32k on
the production mesh, not the 1-token decode, verify 11, multi-draft 51 or
the MT), as JAX's rules do; its note says so (``seq_shard=T/m``). A
planned rank records the gathers and reduce-scatters along T a live rank
issues.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import MeshShape, dp_axes
from repro_torch.models import transformer as tr
from repro_torch.models.attention import KVCache, PagedKVCache
from repro_torch.sharding import ctx, rules
from repro_torch.training.optimizer import adam_init
from repro_torch.training.trainer import make_lm_train_step

SHAPES = {
    "train_4k":    dict(seq=4096,   batch=256, kind="train"),
    "prefill_32k": dict(seq=32768,  batch=32,  kind="prefill"),
    "decode_32k":  dict(seq=32768,  batch=128, kind="decode"),
    "long_500k":   dict(seq=524288, batch=1,   kind="decode"),
}

# The paper's own Molecular Transformer at pod scale: one request stream a
# data slot, the model replicated (an 11M-param model does not shard).
# seq 256 covers USPTO SMILES lengths; mt_verify is the speculative verify
# pass (DL=10).
MT_SHAPES = {
    "mt_train":  dict(seq=256, batch=4096, kind="mt_train"),
    "mt_verify": dict(seq=256, batch=4096, kind="mt_verify", verify=11),
}

SLIDING_WINDOW_LONG = 8192  # the dense archs' variant at 500k


class BuiltStep(NamedTuple):
    fn: Any                 # the step; takes ``local_inputs``
    inputs: tuple           # meta tensors, the global shapes
    in_shardings: tuple     # spec tuples (launch.shardings)
    out_shardings: Any      # None = left to the step (metrics)
    note: str
    outputs: Any = None     # meta tensors, the global outputs
    local_inputs: tuple = ()  # rank 0's meta inputs (== inputs on one rank)
    tp: Any = None          # the recorder of a planned mesh, else None
    fsdp_records: tuple = ()  # (kind, bytes) of the FSDP traffic
    kind: str = ""
    cfg: ModelConfig | None = None
    shape: str = ""         # the SHAPES / MT_SHAPES entry
    draft_len: int = 0      # a multi-draft step's DL (its fed layout)
    rank: Any = None        # a world rank's cut of the inputs (``_Local``)
    vocab_cut: bool = False  # the logits' vocabulary split over "model"


def skip_reason(arch: str, shape_name: str) -> str | None:
    cfg = get_config(arch)
    if shape_name in MT_SHAPES:
        return None if cfg.family == "seq2seq" else \
            "mt_* shapes apply to the seq2seq Molecular Transformer only"
    if cfg.family == "seq2seq":
        return "MT uses its own shapes (mt_train / mt_verify)"
    kind = SHAPES[shape_name]["kind"]
    if cfg.family == "audio" and kind == "decode":
        return "encoder-only: no autoregressive decode step (DESIGN.md §4)"
    return None


def _dryrun_cfg(arch: str, shape_name: str) -> ModelConfig:
    cfg = get_config(arch)
    if shape_name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
        # sub-quadratic requirement: sliding-window variant for full-attention
        cfg = dataclasses.replace(cfg, sliding_window=SLIDING_WINDOW_LONG)
    return cfg


def _cast(tree, dtype):
    """Float leaves of a param tree in ``dtype`` (free on meta)."""
    return rules.tree_map_with_path(
        lambda _, t: t.to(dtype) if t.is_floating_point() else t, tree)


def _params_specs(cfg: ModelConfig, dtype=torch.bfloat16):
    """The param tree as meta tensors (``jax.eval_shape(tr.init)``)."""
    if cfg.family == "seq2seq":
        from repro_torch.models import seq2seq as s2s

        return _cast(s2s.init(None, cfg, device="meta"), dtype)
    return _cast(tr.init(None, cfg, device="meta"), dtype)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape_name: str, *, dtype=torch.bfloat16) -> dict:
    """Meta stand-ins for every model input of this pair."""
    return input_specs_for(_dryrun_cfg(arch, shape_name), shape_name,
                           dtype=dtype)


def input_specs_for(cfg: ModelConfig, shape_name: str, *,
                    dtype=torch.bfloat16, batch: int | None = None,
                    widths: dict | None = None,
                    cache_cfg: ModelConfig | None = None) -> dict:
    """``batch``, ``widths`` and ``cache_cfg``: a rank's rows, channels and
    cache heads (``_Local``), default the global ones."""
    meta = SHAPES[shape_name]
    S, kind = meta["seq"], meta["kind"]
    B = meta["batch"] if batch is None else batch
    i32 = torch.int32
    out: dict = {}
    if kind == "train":
        if cfg.family == "audio":
            out["embeddings"] = _meta((B, S, cfg.d_model), dtype)
            out["labels"] = _meta((B, S), i32)
        else:
            out["tokens"] = _meta((B, S + 1), i32)
            out["loss_mask"] = _meta((B, S + 1), torch.float32)
        if cfg.family == "vlm":
            out["memory"] = _meta((B, cfg.memory_tokens, cfg.memory_dim),
                                  dtype)
    elif kind == "prefill":
        if cfg.family == "audio":
            out["embeddings"] = _meta((B, S, cfg.d_model), dtype)
        else:
            out["tokens"] = _meta((B, S), i32)
        if cfg.family == "vlm":
            out["memory"] = _meta((B, cfg.memory_tokens, cfg.memory_dim),
                                  dtype)
    else:  # decode
        out["tokens"] = _meta((B, 1), i32)
        out["positions"] = _meta((B, 1), i32)
        out["cache"] = tr.init_cache(cache_cfg or cfg, B, S, dtype=dtype,
                                     device="meta", widths=widths)
    return out


# ---------------------------------------------------------------------------
# a rank of a planned mesh


def _mesh_size(mesh) -> int:
    n = 1
    for s in rules.axis_sizes(mesh).values():
        n *= s
    return n


def _live(mesh) -> bool:
    """A world of ranks: a ``DeviceMesh`` of more than one rank."""
    return not isinstance(mesh, (MeshShape, dict)) and _mesh_size(mesh) > 1


def _spec_leaves(tree, spec):
    """(leaf, spec) pairs of a tree and its spec tree (a None spec:
    replicated)."""
    if isinstance(tree, torch.Tensor):
        yield tree, spec
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, None if spec is None else spec[k])
    elif isinstance(tree, (KVCache, PagedKVCache)):
        for f in dataclasses.fields(tree):
            yield from _spec_leaves(getattr(tree, f.name), None if spec is None
                                    else getattr(spec, f.name))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, None if spec is None else spec[i])


def _split(spec, sizes: dict, axes) -> int:
    """The product of the sizes of ``axes`` that ``spec`` splits over."""
    n = 1
    for ax in spec or ():
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a in axes:
                n *= sizes[a]
    return n


def shard_bytes(tree, specs, mesh) -> int:
    """The bytes one rank holds of ``tree`` laid out by ``specs``: each
    leaf's size over the product of the axes its spec splits it over."""
    sizes = rules.axis_sizes(mesh)
    return sum(t.numel() * t.element_size() // _split(s, sizes, sizes)
               for t, s in _spec_leaves(tree, specs))


def fsdp_records(params, specs, mesh, *, train: bool, held=None) -> list:
    """The FSDP collectives of a step, counted as JAX's parser counts a
    line (the largest shape on it): each leaf sharded over the data axes
    gathered at its model-local size, in a train step its gradient
    reduce-scattered at that size; in a train step each leaf replicated
    over the data axes has its gradient all-reduced there. ``held``: the
    spec tree of the model-axis cut a rank holds (``launch.shardings.
    serving_param_shardings``, which keeps whole a head that does not
    divide the axis), default ``specs``."""
    sizes = rules.axis_sizes(mesh)
    dp = set(dp_axes(mesh))
    n_data = 1
    for a in dp:
        n_data *= sizes[a]
    out = []
    model = [_split(h, sizes, {rules.MODEL}) for _, h in
             _spec_leaves(params, specs if held is None else held)]
    for (t, s), m in zip(_spec_leaves(params, specs), model):
        local = t.numel() * t.element_size() // m
        if _split(s, sizes, dp) > 1:
            out.append(("all-gather", local))
            if train:
                out.append(("reduce-scatter", local))
        elif train and n_data > 1:
            out.append(("all-reduce", local))
    return out


class _Local:
    """A rank of ``mesh``: its tensor-parallel context (a recorder for rank
    0 of a planned mesh, the live one on a world), its params (the
    model-axis cut; on a world with FSDP params, its data-axis shard of
    each leaf the specs split over the data axes), its rows and its
    cache's heads and channels. One rank: the global ones, no context."""

    def __init__(self, cfg: ModelConfig, mesh, params, specs, *,
                 train: bool):
        self.cfg, self.params, self.tp = cfg, params, None
        self.data = 1
        self.cache_cfg, self.widths = cfg, None
        self.fsdp = []
        self.mesh, self.world, self.laid = mesh, _live(mesh), False
        self.split: dict[str, list] = {}   # "row" / "vocab" / "expert"
        self.gather_dims: dict[tuple, int] = {}   # path -> FSDP data dim
        self.kv_lo = 0                     # the rank's first cache kv head
        if _mesh_size(mesh) == 1:
            return
        if self.world:
            from repro_torch.launch.mesh import mesh_tensor_parallel

            tp = mesh_tensor_parallel(mesh)
        else:
            tp = ctx.recording_tensor_parallel(mesh)
        self.tp, self.data = tp, tp.data_size
        cut = any(rules.split_dims(s, rules.MODEL)
                  for _, s in _spec_leaves(params, specs))
        self.laid = laid = tp.size > 1 and cut
        held = (sh.serving_param_shardings(params, cfg, mesh) if laid else
                rules.tree_map_with_path(lambda _, t: (), params))
        self.fsdp = fsdp_records(params, specs, mesh, train=train, held=held)
        self.held = held
        self.model_cut = {path: bool(rules.split_dims(h, rules.MODEL))
                          for (path, _), (_, h) in zip(
                              _paths(params), _spec_leaves(params, held))}
        if laid:
            self.params = sh.lay_out_params(params, cfg, mesh, tp, "meta")
            self.cache_cfg = c = sh.local_cache_cfg(cfg, tp)
            if "blocks" in self.params:
                self.widths = tr.local_widths(self.params, cfg)
            if c.n_kv_heads != cfg.n_kv_heads:
                self.kv_lo = (tp.rank * c.n_kv_heads
                              if cfg.n_kv_heads % tp.size == 0 else
                              ctx.kv_heads_for(tp.rank, c.n_heads,
                                               cfg.n_heads,
                                               cfg.n_kv_heads)[0])
        if not self.world:
            return
        leaves = _paths(self.params)
        self.split = {k: [p for p, t in leaves
                          if id(t) in getattr(tp, f"{k}_split")]
                      for k in ("row", "vocab", "expert")}
        if self.data > 1:
            dp = set(dp_axes(mesh))
            for path, _ in leaves:
                spec = _lookup(specs, path)
                dims = [i for i, ax in enumerate(spec or ())
                        if ax is not None and set(
                            ax if isinstance(ax, tuple) else (ax,)) & dp]
                if dims:
                    self.gather_dims[path] = dims[0]
        # the param layout the step's layers_params, its gradient
        # reduction and global norm read
        tp.model_cut, tp.gather_dims = self.model_cut, self.gather_dims
        tp.split_paths = {k: frozenset(v) for k, v in self.split.items()}
        self.params = self.shard(self.params)

    def rows(self, B: int) -> int:
        """The rows of a batch of ``B`` this rank holds: its equal part, or
        every row when ``B`` does not divide the data axes."""
        return B // self.data if B % self.data == 0 else B

    def shard(self, params):
        """This rank's data-axis shard of each leaf FSDP splits (a copy; on
        meta, the shapes)."""
        def one(path, t):
            d = self.gather_dims.get(path)
            if d is None:
                return t
            n = t.shape[d] // self.data
            return t.narrow(d, self.tp.data_rank * n, n).clone()

        return rules.tree_map_with_path(one, params)

    def wrap(self, body, *, grad: bool = False, vocab_cut: bool = False):
        """``body`` under this rank's context (and, unless ``grad``,
        without autograd: a serving step); on a world, a serving step with
        the FSDP leaves gathered first (``ctx.layers_params``) and the
        logits (the first output, when ``vocab_cut``) cut to the rank's
        vocabulary, a train step (``grad``) on the rank's shards, which it
        gathers itself."""
        tp, world = self.tp, self.world

        def fn(params, *args):
            with ctx.tensor_parallel(tp), torch.set_grad_enabled(grad):
                if world and not grad:
                    params = ctx.layers_params(params)
                out = body(params, *args)
            if world and vocab_cut:
                out = (self.vocab(out[0]), *out[1:])
            return out

        return fn

    # -- a world rank's part of the global tensors (copies)

    def cut(self, tree):
        """The rank's part of a whole param-shaped tree (params, Adam's
        moments, gradients; copies): ``lay_out_params``' model-axis cut,
        then its data-axis shard of each FSDP leaf."""
        if self.laid:
            tree = sh.lay_out_params(tree, self.cfg, self.mesh,
                                     dataclasses.replace(self.tp),
                                     _paths(tree)[0][1].device)
        return self.shard(tree)

    def placement(self, tree) -> list:
        """Where each leaf of the rank's part of a whole param-shaped tree
        (``cut``) sits in the whole leaf: per leaf, ``(dim, start, stop)``
        of every dim it is cut on (a contiguous cut; Mamba's fused
        ``w_in``, cut half by half, is not one)."""
        out = []
        for (path, t), (_, h) in zip(_paths(tree),
                                     _spec_leaves(tree, self.held)):
            split = rules.split_dims(h, rules.MODEL) if self.laid else []
            d_dim = self.gather_dims.get(path)
            cuts = []
            for d in range(t.dim()):
                n, start = t.shape[d], 0
                if d in split:
                    n //= self.tp.size
                    start = self.tp.rank * n
                if d == d_dim:
                    n //= self.data
                    start += self.tp.data_rank * n
                if n != t.shape[d]:
                    cuts.append((d, start, start + n))
            out.append(cuts)
        return out

    def take_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's rows (dim 0) of a batch input or output."""
        n = self.rows(t.shape[0])
        whole = n == t.shape[0]   # every row on every data shard
        return t.narrow(0, 0 if whole else self.tp.data_rank * n, n).clone()

    def vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """The rank's equal part of the last (vocabulary) dim."""
        n = logits.shape[-1] // self.tp.size
        return logits.narrow(-1, self.tp.rank * n, n).clone()

    def take_cache(self, cache, like):
        """The part of each leaf of a cache tree shaped like the leaf of
        ``like`` (the rank's cache spec): its rows on dim 1, then its heads
        or channels on every other dim that differs (the kv heads of a
        ``KVCache``'s k / v from ``kv_lo``, anything else the rank's equal
        contiguous part)."""
        def take(t, spec, name):
            for d in range(t.dim()):
                n = spec.shape[d]
                if t.shape[d] == n:
                    continue
                off = (self.tp.data_rank * n if d == 1 else
                       self.kv_lo if name in ("k", "v") and d == 3 else
                       self.tp.rank * n)
                t = t.narrow(d, off, n)
            return t.clone()

        return _map_named2(cache, like, take)


def _seq_note(mesh, T: int) -> str:
    """The note's mark of a stream split along T by the rules in force
    (``ctx.activation_rules(seq=("model",))``): where the mesh's model
    axis divides ``T``."""
    r = ctx._rules()
    m = rules.axes_size(mesh, rules.MODEL)
    if r is None or r["seq"] is None or m == 1 or T % m:
        return ""
    return f" seq_shard=T/{m}"


def _paths(tree) -> list:
    """(path, leaf) of every leaf of a params tree."""
    out = []
    rules.tree_map_with_path(lambda path, t: out.append((path, t)), tree)
    return out


# ---------------------------------------------------------------------------
# the builders


def build_step(arch: str, shape_name: str, mesh, *, dtype=torch.bfloat16,
               remat: bool = True, cfg_override: ModelConfig | None = None,
               fsdp_inference: bool = True, verify_tokens: int = 0,
               multidraft: int = 0) -> BuiltStep:
    """``fsdp_inference=False``: tensor-parallel-only params for prefill /
    decode. ``verify_tokens=T``: the speculative verify step (T = DL+1 fed
    tokens) instead of the 1-token serve step. ``multidraft=N_d`` (with
    verify_tokens): the single-pass N_d-draft verify (one row a sequence,
    segmented attention) instead of the B·N_d expanded batch. ``mesh``: a
    ``MeshShape`` (a plan), a mesh of one rank, or a ``DeviceMesh`` over a
    world of ranks (every rank builds the step alike; the serving kinds)."""
    if shape_name in MT_SHAPES:
        return _build_mt_step(arch, shape_name, mesh, dtype=dtype,
                              cfg_override=cfg_override,
                              fsdp_inference=fsdp_inference)
    cfg = cfg_override if cfg_override is not None else _dryrun_cfg(
        arch, shape_name)
    meta = SHAPES[shape_name]
    S, B, kind = meta["seq"], meta["batch"], meta["kind"]
    fsdp = fsdp_inference or kind == "train"
    params = _params_specs(cfg, dtype)
    p_sh = sh.param_shardings(params, mesh, fsdp=fsdp)
    dp = dp_axes(mesh)
    n_dp = rules.axes_size(mesh, dp)
    specs = input_specs_for(cfg, shape_name, dtype=dtype)
    loc = _Local(cfg, mesh, params, p_sh, train=kind == "train")
    Bl = loc.rows(B)
    lspecs = input_specs_for(cfg, shape_name, dtype=dtype, batch=Bl,
                             widths=loc.widths, cache_cfg=loc.cache_cfg)
    common = dict(tp=loc.tp, fsdp_records=tuple(loc.fsdp), kind=kind,
                  cfg=cfg, shape=shape_name,
                  rank=loc if loc.world else None)

    if kind == "train":
        step = make_lm_train_step(cfg, remat=remat)
        opt = adam_init(params)
        batch = dict(specs)
        lbatch = dict(lspecs)
        return BuiltStep(
            fn=loc.wrap(step, grad=True), inputs=(params, opt, batch),
            in_shardings=(p_sh, sh.opt_shardings(opt, params, mesh),
                          sh.batch_shardings(batch, mesh)),
            out_shardings=(p_sh, sh.opt_shardings(opt, params, mesh), None),
            note=f"train {arch} B={B} S={S} remat={remat}"
                 + _seq_note(mesh, S),
            outputs=(params, opt, {}),
            local_inputs=(loc.params, adam_init(loc.params), lbatch),
            **common)

    if kind == "prefill":
        cache_like = tr.init_cache(cfg, B, S, dtype=dtype, device="meta")
        c_sh = sh.cache_shardings(cache_like, cfg, mesh)
        logits_sh = (dp if B % n_dp == 0 else None, None)
        V = cfg.vocab_size

        if cfg.family == "audio":
            def body(params, embeddings):
                logits, _ = tr.apply(params, cfg, embeddings=embeddings)
                return logits
            emb = specs["embeddings"]
            return BuiltStep(
                fn=loc.wrap(body), inputs=(params, emb),
                in_shardings=(p_sh, sh.batch_shardings(emb, mesh)),
                out_shardings=(dp, None, None),
                note=f"encode {arch} B={B} S={S}" + _seq_note(mesh, S),
                outputs=_meta((B, S, V), dtype),
                local_inputs=(loc.params, lspecs["embeddings"]), **common)

        def fresh(tokens):
            return tr.init_cache(loc.cache_cfg, tokens.shape[0], S,
                                 dtype=dtype, device=tokens.device,
                                 widths=loc.widths)

        if cfg.family == "vlm":
            def body(params, tokens, memory):
                return tr.prefill(params, cfg, fresh(tokens), tokens,
                                  memory=memory, logits_mode="last")
            args = (params, specs["tokens"], specs["memory"])
            largs = (loc.params, lspecs["tokens"], lspecs["memory"])
            in_sh = (p_sh, sh.batch_shardings(specs["tokens"], mesh),
                     sh.batch_shardings(specs["memory"], mesh))
        else:
            def body(params, tokens):
                return tr.prefill(params, cfg, fresh(tokens), tokens,
                                  logits_mode="last")
            args = (params, specs["tokens"])
            largs = (loc.params, lspecs["tokens"])
            in_sh = (p_sh, sh.batch_shardings(specs["tokens"], mesh))
        return BuiltStep(fn=loc.wrap(body), inputs=args, in_shardings=in_sh,
                         out_shardings=(logits_sh, c_sh),
                         note=f"prefill {arch} B={B} S={S}"
                              + _seq_note(mesh, S),
                         outputs=(_meta((B, V), dtype), cache_like),
                         local_inputs=largs, **common)

    # decode: one new token against a seq_len cache (serve_step), or the
    # speculative verify pass (T = DL+1 fed tokens) when verify_tokens > 0
    cache, lcache = specs["cache"], lspecs["cache"]
    c_sh = sh.cache_shardings(cache, cfg, mesh)
    T = max(1, verify_tokens)
    if multidraft > 0:
        from repro_torch.core.multidraft import build_local_mask

        DL = T - 1
        T = 1 + multidraft * DL
        mask_np = build_local_mask(multidraft, DL)
    i32 = torch.int32

    if multidraft > 0:
        def body(params, cache, tokens, positions):
            Bb, dev = tokens.shape[0], tokens.device
            local_mask = torch.as_tensor(mask_np, device=dev)
            logits, kv = tr.multidraft_verify_step(
                params, cfg, cache, tokens, positions, local_mask)
            cache = tr.commit_multidraft(
                cfg, cache, kv, torch.zeros((Bb,), dtype=i32, device=dev),
                torch.full((Bb,), DL, dtype=i32, device=dev),
                positions[:, 0], draft_len=DL)
            return logits, cache
    else:
        def body(params, cache, tokens, positions):
            logits, cache = tr.decode_step(params, cfg, cache, tokens,
                                           positions)
            cache = tr.commit_cache(cfg, cache, torch.full(
                (tokens.shape[0],), T, dtype=i32, device=tokens.device))
            return logits, cache

    tokens_spec, pos_spec = _meta((B, T), i32), _meta((B, T), i32)
    common["draft_len"] = DL if multidraft > 0 else 0
    n_model = rules.axes_size(mesh, rules.MODEL)
    common["vocab_cut"] = n_model > 1 and cfg.vocab_size % n_model == 0
    logits_sh = (dp if B % n_dp == 0 else None, None,
                 rules.MODEL if cfg.vocab_size % n_model == 0 else None)
    return BuiltStep(
        fn=loc.wrap(body, vocab_cut=common["vocab_cut"]),
        inputs=(params, cache, tokens_spec, pos_spec),
        in_shardings=(p_sh, c_sh, sh.batch_shardings(tokens_spec, mesh),
                      sh.batch_shardings(pos_spec, mesh)),
        out_shardings=(logits_sh, c_sh),
        note=f"serve {arch} B={B} T={T} cache={S}"
             + (f" window={cfg.sliding_window}" if cfg.sliding_window else "")
             + ("" if multidraft > 0 else _seq_note(mesh, T)),
        outputs=(_meta((B, T, cfg.vocab_size), dtype), cache),
        local_inputs=(loc.params, lcache, _meta((Bl, T), i32),
                      _meta((Bl, T), i32)), **common)


# ---------------------------------------------------------------------------
# Molecular Transformer (seq2seq) at pod scale: the paper's model through
# the same dry-run machinery (shapes: MT_SHAPES).


def _build_mt_step(arch: str, shape_name: str, mesh, *,
                   dtype=torch.bfloat16,
                   cfg_override: ModelConfig | None = None,
                   fsdp_inference: bool = True) -> BuiltStep:
    from repro_torch.models import seq2seq as s2s
    from repro_torch.training.trainer import make_seq2seq_train_step

    cfg = cfg_override if cfg_override is not None else get_config(arch)
    meta = MT_SHAPES[shape_name]
    S, B, kind = meta["seq"], meta["batch"], meta["kind"]
    train = kind == "mt_train"
    dp = dp_axes(mesh)
    params = _params_specs(cfg, dtype)
    if not train and not fsdp_inference:
        # pure request-parallel serving: an 11M-param model replicates
        p_sh = rules.tree_map_with_path(lambda _, t: (), params)
    else:
        p_sh = sh.param_shardings(params, mesh, fsdp=train)
    loc = _Local(cfg, mesh, params, p_sh, train=train)
    Bl = loc.rows(B)
    common = dict(tp=loc.tp, fsdp_records=tuple(loc.fsdp), kind=kind,
                  cfg=cfg, shape=shape_name,
                  rank=loc if loc.world else None)
    i32 = torch.int32

    if train:
        step = make_seq2seq_train_step(cfg)
        opt = adam_init(params)
        batch = {k: _meta((B, S), i32) for k in ("src", "tgt_in", "tgt_out")}
        lbatch = {k: _meta((Bl, S), i32) for k in batch}
        o_sh = sh.opt_shardings(opt, params, mesh)
        return BuiltStep(fn=loc.wrap(step, grad=True),
                         inputs=(params, opt, batch),
                         in_shardings=(p_sh, o_sh,
                                       sh.batch_shardings(batch, mesh)),
                         out_shardings=(p_sh, o_sh, None),
                         note=f"mt train {arch} B={B} S={S}",
                         outputs=(params, opt, {}),
                         local_inputs=(loc.params, adam_init(loc.params),
                                       lbatch), **common)

    # mt_verify: the speculative verify pass (T = DL+1 tokens a sequence)
    T = meta["verify"]

    def mk_cache(rows: int, c: ModelConfig):
        one = s2s.init_cache(c, rows, S, dtype=dtype, device="meta")
        shape = (cfg.n_layers, rows, S, c.n_heads, c.head_dim)
        return {"self": one["self"],
                "cross": {"mk": _meta(shape, dtype),
                          "mv": _meta(shape, dtype)}}

    cache = mk_cache(B, cfg)
    b_ax = dp if B % rules.axes_size(mesh, dp) == 0 else None

    def leaf_spec(t):
        return (None, b_ax, *((None,) * (t.dim() - 2)))

    c_sh = {"self": KVCache(k=leaf_spec(cache["self"].k),
                            v=leaf_spec(cache["self"].v),
                            pos=leaf_spec(cache["self"].pos)),
            "cross": {k: leaf_spec(v) for k, v in cache["cross"].items()}}

    def body(params, cache, tokens, positions):
        return s2s.decode_step(params, cfg, cache, tokens, positions)

    tokens_spec = _meta((B, T), i32)
    t_sh = sh.batch_shardings(tokens_spec, mesh)
    return BuiltStep(fn=loc.wrap(body),
                     inputs=(params, cache, tokens_spec, _meta((B, T), i32)),
                     in_shardings=(p_sh, c_sh, t_sh, t_sh),
                     out_shardings=((b_ax, None, None), c_sh),
                     note=f"mt verify {arch} B={B} T={T} cache={S}",
                     outputs=(_meta((B, T, cfg.vocab_size), dtype), cache),
                     local_inputs=(loc.params, mk_cache(Bl, loc.cache_cfg),
                                   _meta((Bl, T), i32), _meta((Bl, T), i32)),
                     **common)


# ---------------------------------------------------------------------------
# real inputs for a built step (the card, or the CPU in the tests)


def _fed_positions(built: BuiltStep, seq: int, T: int):
    """(first fed position, the fed tokens' offsets from it): the fed
    tokens end the cache's ``seq`` positions (a verify pass of T, or one
    row of every draft: the last token, then each draft's DL)."""
    import numpy as np

    DL = built.draft_len
    if DL:
        n_d = (T - 1) // DL
        offs = np.concatenate([[0], np.tile(1 + np.arange(DL), n_d)])
        return seq - 1 - DL, offs
    return seq - T, np.arange(T)


def example_inputs(built: BuiltStep, *, device=None, seed: int = 0,
                   params=None) -> tuple:
    """Real tensors shaped like ``built.local_inputs``, drawn on ``device``
    (default: the card) by a generator seeded ``seed``: params from
    ``init`` (or ``params``) in the specs' dtype; tokens in [4, vocab); a
    train batch's ``loss_mask`` zero on each row's first ``1 + b % (S //
    2)`` positions, an MT ``tgt_out`` padded (0) on as many last ones;
    frames, memory and cache K/V, states normal; every cache slot filled
    with the latest position below the first fed one that maps to it (a
    full row: the decode read sees every slot), the fed tokens at the end
    of the shape's sequence. On a world rank: the global inputs drawn as
    for one rank (``params``: the global ones), then cut to the rank's
    part (``rank_part``)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if built.rank is not None:
        return rank_part(built, _draw(built, built.inputs, dev, seed, params))
    return _draw(built, built.local_inputs, dev, seed, params)


def _draw(built: BuiltStep, specs: tuple, dev, seed: int, params) -> tuple:
    from repro_torch.models import seq2seq as s2s

    gen = torch.Generator(dev).manual_seed(seed)
    cfg = built.cfg
    if params is None:
        init = s2s.init if cfg.family == "seq2seq" else tr.init
        params = init(gen, cfg, device=dev)
    leaves = rules.tree_map_with_path(lambda _, t: t, specs[0])
    params = rules.tree_map_with_path(   # copies: a train step updates them
        lambda path, t: t.to(dev, _lookup(leaves, path).dtype, copy=True),
        params)

    def normal(t):
        return (torch.randn(t.shape, generator=gen, device=dev) * 0.5).to(
            t.dtype)

    def ints(t, lo):
        return torch.randint(lo, cfg.vocab_size, tuple(t.shape),
                             generator=gen, device=dev, dtype=t.dtype)

    if built.kind in ("train", "mt_train"):
        batch = {}
        for k, t in specs[2].items():
            if k == "loss_mask":
                batch[k] = _ragged(t, dev, head=True).to(t.dtype)
            elif t.is_floating_point():
                batch[k] = normal(t)
            else:
                batch[k] = ints(t, 0 if k == "labels" else 4)
        if "tgt_out" in batch:   # pad (0) tails
            batch["tgt_out"] = torch.where(
                _ragged(batch["tgt_out"], dev, head=False),
                batch["tgt_out"], 0)
        return params, adam_init(params), batch
    if built.kind == "prefill":
        return (params, *(ints(t, 4) if not t.is_floating_point()
                          else normal(t) for t in specs[1:]))
    # decode / mt_verify: cache, tokens, positions
    _, cache_spec, tok_spec, _ = specs
    B, T = tok_spec.shape
    seq = (MT_SHAPES if built.kind == "mt_verify" else SHAPES)[
        built.shape]["seq"]
    first, offs = _fed_positions(built, seq, T)

    def cache_leaf(t, name):
        if name == "pos":
            S = t.shape[-1]
            j = torch.arange(S, device=dev)
            p = first - 1 - torch.remainder(first - 1 - j, S)
            p = torch.where(p >= 0, p, -1).to(t.dtype)
            return p.expand(t.shape).contiguous()
        return normal(t) if t.is_floating_point() else torch.zeros(
            t.shape, dtype=t.dtype, device=dev)

    cache = _map_named(cache_spec, cache_leaf)
    positions = (first + torch.as_tensor(offs, device=dev)).to(
        torch.int32).expand(B, T).contiguous()
    return params, cache, ints(tok_spec, 4), positions


def _ragged(t, dev, *, head: bool) -> torch.Tensor:
    """(B, S) bool, False on row b's first (``head``) or last ``1 + b %
    max(1, S // 2)`` positions: each row counts another number of tokens,
    so the data shards of a world count different numbers (a denominator
    taken per shard would show)."""
    B, S = t.shape
    n = 1 + torch.arange(B, device=dev)[:, None] % max(1, S // 2)
    j = torch.arange(S, device=dev)[None, :]
    return j >= n if head else j < S - n


def rank_part(built: BuiltStep, inputs: tuple) -> tuple:
    """The part of a one-rank step's inputs (the global ones) that this
    rank of a world's built step takes, as copies: its params and a train
    step's Adam moments (``lay_out_params``' model-axis cut, then with
    FSDP its data-axis shard of each leaf the specs split there), its rows
    of every batch input, its cache's rows and heads."""
    loc = built.rank
    if loc is None:
        return inputs
    params = loc.cut(inputs[0])
    if built.kind in ("train", "mt_train"):
        opt, batch = inputs[1:]
        return (params, type(opt)(opt.step, loc.cut(opt.mu), loc.cut(opt.nu)),
                {k: loc.take_rows(t) for k, t in batch.items()})
    if built.kind == "prefill":
        return (params, *(loc.take_rows(t) for t in inputs[1:]))
    _, cache, tokens, positions = inputs
    return (params, loc.take_cache(cache, built.local_inputs[1]),
            loc.take_rows(tokens), loc.take_rows(positions))


def rank_outputs(built: BuiltStep, outputs):
    """A one-rank step's outputs cut as this rank of a world's built step
    returns them: its rows, the logits' vocabulary where the out spec
    splits it, its cache's rows and heads; a train step's new params and
    Adam moments as the rank holds them (``_Local.cut``), its metrics
    whole."""
    loc = built.rank
    if loc is None:
        return outputs
    if built.kind in ("train", "mt_train"):
        params, opt, metrics = outputs
        return (loc.cut(params),
                type(opt)(opt.step, loc.cut(opt.mu), loc.cut(opt.nu)), metrics)
    if built.kind == "prefill" and built.cfg.family == "audio":
        return loc.take_rows(outputs)
    logits, cache = outputs
    logits = loc.take_rows(logits)
    if built.vocab_cut:
        logits = loc.vocab(logits)
    if built.kind == "prefill":
        B = logits.shape[0]
        like = tr.init_cache(loc.cache_cfg, B, SHAPES[built.shape]["seq"],
                             device="meta", widths=loc.widths)
    else:
        like = built.local_inputs[1]
    return logits, loc.take_cache(cache, like)


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _map_named2(tree, like, fn, name: str = ""):
    """``fn(leaf, like leaf, field name)`` over a cache tree and a tree of
    the same structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, like, name)
    if isinstance(tree, dict):
        return {k: _map_named2(v, like[k], fn, k) for k, v in tree.items()}
    if isinstance(tree, (KVCache, PagedKVCache)):
        return type(tree)(**{f.name: _map_named2(
            getattr(tree, f.name), getattr(like, f.name), fn, f.name)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named2(v, w, fn, name)
                          for v, w in zip(tree, like))
    return tree


def _map_named(tree, fn, name: str = ""):
    """``fn(leaf, field name)`` over a cache tree (dicts, tuples, caches)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, name)
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (KVCache, PagedKVCache)):
        return type(tree)(**{f.name: _map_named(getattr(tree, f.name), fn,
                                                f.name)
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # AdamState
        return type(tree)(*(_map_named(v, fn, name) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(v, fn, name) for v in tree)
    return tree
