"""Rank bodies that drive a ``StreamingEngine`` on a serving mesh and
report what it did: the jobs a ``repro_torch.launch.world.World`` runs on
every rank (the mesh tests and ``chip_smoke.py`` start one world and run
many engines through it).

``layer`` runs one layer function of a model on a mesh rank, under the
rank's tensor-parallel context, on given inputs: the per-layer checks of
the sharded MoE, Mamba, RWKV and cross-attention layers.

``serve`` builds the model (seeded weights, or a saved state; any
decoder-only family, with an MoE capacity factor of its own), the engine
(sharded over a ``(data, model)`` mesh, or unsharded in the rank), submits
the jobs, serves them and returns each job's tokens, log-probs and calls
with the engine's counters (``shard_stats()``, ``loop_stats()``,
``prefix_stats()``, preemptions and the shards they named, the shard of
each admission, the MoE dropped fraction, kernel launches and their
launch groups, walls, this rank's slots, rows, weight shapes and local
widths). ``probe`` calls engine methods
with engine attributes set first (placement checks). Every rank returns
its own report; the ranks' reports must agree.

On the card every launch is recorded by kernel and input shape
(``LaunchGroups``), and each group's first launch is held against the
kernel's plain version on the same inputs: a rank's local heads, rows
and segment give shapes that no unsharded path launches.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

_MESHES: dict = {}


def _mesh(shape):
    """One DeviceMesh per shape for the life of the world (a mesh makes
    process groups: every rank makes them together, once)."""
    from repro_torch.launch.mesh import make_serving_mesh

    shape = tuple(shape)
    if shape not in _MESHES:
        _MESHES[shape] = make_serving_mesh(shape)
    return _MESHES[shape]


def _device(on_card: bool):
    import torch.distributed as dist

    from repro_torch.launch.world import rank_device

    return rank_device(dist.get_rank() if dist.is_initialized() else 0,
                       "cuda" if on_card else "cpu")


def _model(model: dict, device=None):
    """(cfg, params, tokenizer) from a model description: ``family`` "mt"
    (``cfg``, and a ``tokenizer`` dict or a ``SyntheticReactionDataset(n,
    seed)``'s, ``dataset``) or "lm" (``cfg``, and ``capacity_factor`` to
    override its MoE's); weights from ``params`` (a ``torch.save`` file)
    or drawn from ``seed`` by a CPU generator (the same on every rank), or
    with ``draw="card"`` by a generator on ``device``'s card (the same on
    every rank of one card; full-width models, with no host copy)."""
    import dataclasses

    from repro_torch.data import SyntheticReactionDataset
    from repro_torch.models import seq2seq as s2s
    from repro_torch.models import transformer as tr

    from repro_torch.data.tokenizer import SmilesTokenizer

    cfg = model["cfg"]
    if model.get("capacity_factor") is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(model["capacity_factor"])))
    tok = None
    if "tokenizer" in model:
        tok = SmilesTokenizer.from_dict(model["tokenizer"])
    elif model["family"] == "mt":
        n, seed = model["dataset"]
        tok = SyntheticReactionDataset(n, seed=seed).tokenizer
    if model.get("params"):
        params = torch.load(model["params"], map_location="cpu",
                            weights_only=False)
    else:
        init = s2s.init if model["family"] == "mt" else tr.init
        on = (device if model.get("draw") == "card" and device is not None
              and device.type == "cuda" else "cpu")
        params = init(torch.Generator(on).manual_seed(model["seed"]), cfg,
                      device=on)
    return cfg, params, tok


def _engine(model: dict, engine: dict, mesh, device):
    """The engine; with ``draw="card"`` the ranks of a world draw their
    weights and take their shards one at a time (each holds the whole
    model only while it lays its shard out)."""
    import torch.distributed as dist

    from repro_torch.serving import EngineConfig, StreamingEngine

    dm = None if mesh is None else _mesh(mesh)   # made by every rank

    def build():
        cfg, params, tok = _model(model, device)
        return StreamingEngine(params, cfg, tok,
                               EngineConfig(**engine, mesh=dm),
                               device=device)

    if model.get("draw") != "card" or mesh is None:
        return build()
    from repro_torch.launch.world import host_group

    eng = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            eng = build()
            _free(device)
        dist.barrier(group=host_group(None))
    return eng


def _free(device) -> None:
    """Collect dropped engines (their scheduler hooks form reference
    cycles) and hand their card memory back."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def engine_widths(eng) -> dict:
    """The widths an engine's weights and cache hold: attention and kv
    heads a rank's cache holds, experts, Mamba's ``d_inner``, RWKV's and
    the cross-attention heads (a mesh rank's own; the model's
    unsharded)."""
    from repro_torch.models import transformer as tr

    cfg = getattr(eng, "_local_cfg", None) or eng.cfg
    out = {}
    if "attn" in getattr(cfg, "layer_pattern", ("attn",)):
        out.update(heads=cfg.n_heads, kv_heads=cfg.n_kv_heads)
    if "blocks" not in eng.params:
        return out
    out.update(tr.local_widths(eng.params, eng.cfg))
    for blocks in eng.params["blocks"]:
        ffn = blocks[0].get("ffn", {})
        if "experts" in ffn:
            out["experts"] = int(ffn["experts"]["w_in"]["w"].shape[0])
    return out


# the decode tolerance of the kernel checks: |kernel - plain| <= TOL + TOL *
# |plain| in fp32 (draft_verify: bitwise)
TOL = 2e-5


class LaunchGroups:
    """Every launch of the kernels a served engine reaches on the card, by
    kernel and input shape, each group's first launch with a live query
    (a decode read's first with a query position >= 0; an idle slot's
    rows give 0 on both sides) also held against the kernel's plain
    version on the same inputs, and its first launch where no launch of
    the group is live. It wraps the references
    the model and the session call through (``models.attention``'s decode
    reads and flash forward, ``core.session.draft_verify``), for as long
    as it is open; the launch counts stay the wrappers' own, and the plain
    versions launch no kernel."""

    def __init__(self):
        import repro_torch.core.session as session
        import repro_torch.models.attention as attention
        from repro_torch.kernels.decode_gqa.ref import (decode_gqa_ref,
                                                        paged_decode_gqa_ref)
        from repro_torch.kernels.draft_verify.ref import draft_verify_ref
        from repro_torch.kernels.flash_attention.ref import \
            flash_attention_ref

        def flash_ref(q, k, v, *, causal, window=0, key_mask=None,
                      positions=None):
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       key_mask=key_mask, q_pos=positions,
                                       k_pos=positions)[0]

        # (kernel, shape): [launches, largest err, held on a live launch]
        self.groups: dict[tuple, list] = {}
        self._undo = []
        # shapes: decode (B, T, H, Kv, S, hd), paged (B, T, H, Kv, P, ps,
        # nb, hd), flash (B, S, H, Kv, hd), draft_verify (N, T, V)
        self._wrap(attention, "decode_gqa_attention", "decode_gqa",
                   lambda a: (*a[0].shape[:3], a[1].shape[2], a[1].shape[1],
                              a[0].shape[3]), decode_gqa_ref,
                   live=lambda a: bool((a[4] >= 0).any()))
        self._wrap(attention, "paged_decode_gqa_attention",
                   "paged_decode_gqa",
                   lambda a: (*a[0].shape[:3], a[1].shape[2], a[1].shape[0],
                              a[1].shape[1], a[4].shape[1], a[0].shape[3]),
                   paged_decode_gqa_ref,
                   live=lambda a: bool((a[5] >= 0).any()))
        self._wrap(attention, "flash_attention_bshd", "flash_attention",
                   lambda a: (*a[0].shape[:3], a[1].shape[2], a[0].shape[3]),
                   flash_ref)
        self._wrap(session, "draft_verify", "draft_verify",
                   lambda a: tuple(a[0].shape), draft_verify_ref)

    def _wrap(self, module, attr: str, kernel: str, shape, ref,
              live=lambda a: True) -> None:
        op = getattr(module, attr)

        def call(*args, **kw):
            out = op(*args, **kw)
            if not args[0].is_cuda:
                return out
            key = (kernel, tuple(int(n) for n in shape(args)))
            group = self.groups.setdefault(key, [0, None, False])
            group[0] += 1
            if not group[2]:
                now = live(args)
                if group[1] is None or now:
                    e = _disagreement(out, ref(*args, **kw))
                    group[1] = e if group[1] is None else max(group[1], e)
                    group[2] = now
            return out

        setattr(module, attr, call)
        self._undo.append((module, attr, op))

    def close(self) -> None:
        for module, attr, op in reversed(self._undo):
            setattr(module, attr, op)
        self._undo = []

    def report(self) -> list[dict]:
        return [dict(kernel=k, shape=list(shape), launches=n, err=err,
                     live=live)
                for (k, shape), (n, err, live) in sorted(self.groups.items())]


def _disagreement(out, ref) -> float:
    """The largest |kernel - plain|, or inf where it passes ``TOL`` (a
    tuple: draft_verify's tokens and accepted lengths, held bitwise)."""
    if isinstance(out, tuple):
        same = all(torch.equal(a, b) for a, b in zip(out, ref))
        return 0.0 if same else float("inf")
    e = (out.float() - ref.float()).abs()
    if not bool(torch.all(e <= TOL + TOL * ref.float().abs())):
        return float("inf")
    return float(e.max()) if e.numel() else 0.0


def serve(model: dict, engine: dict, jobs: list, *, mesh=(2, 2),
          on_card: bool = False, realtime: bool = False,
          predict: bool = False, arrivals: bool = True,
          serve_first: list | None = None) -> dict:
    """Serve ``jobs`` (``(query, mode)`` pairs; a query is a SMILES string
    or a token list) through one engine and report. ``mesh``: the mesh
    shape, or None for an unsharded engine in this rank. ``predict``:
    through ``predict()`` (greedy / speculative engines; no arrivals).
    ``arrivals``: job i arrives at step (or second, ``realtime``) i.
    ``serve_first``: jobs served to the end before ``jobs`` (a prefix
    cache's parents), outside the report."""
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.models import moe

    device = _device(on_card)
    _free(device)         # the engines of earlier calls
    eng = _engine(model, engine, mesh, device)
    for q, m in serve_first or ():
        eng.submit(np.asarray(q, np.int32), mode=m)
        eng.serve()
    seen, placed = [], []
    orig = eng.scheduler._preempt_youngest
    orig_match = eng._admit_match_prefix

    def spy(prefer=None, shard=None):
        seen.append(shard)
        return orig(prefer=prefer, shard=shard)

    def match(state, slot, rec):
        placed.append(eng._shard_of_slot[slot] if mesh is not None else 0)
        return orig_match(state, slot, rec)

    eng.scheduler._preempt_youngest = spy
    eng._admit_match_prefix = match
    _build.reset_launch_counts()
    groups = LaunchGroups()
    try:
        with moe.count_drops() as drops:
            out, wall = _drive(eng, jobs, device, realtime=realtime,
                               predict=predict, arrivals=arrivals)
    finally:
        groups.close()
    if eng.allocator is not None:
        eng.allocator.check()
    state = eng.scheduler.state
    return dict(
        results=out, wall_s=wall, shard_stats=eng.shard_stats(),
        loop_stats=eng.loop_stats(), prefix_stats=eng.prefix_stats(),
        preemptions=eng.scheduler.n_preemptions, preempt_shards=seen,
        prefix_shards=placed, steps=eng.scheduler.n_steps,
        launches=dict(_build.launch_counts), groups=groups.report(),
        rank=dist.get_rank() if dist.is_initialized() else 0,
        local_slots=[int(gs.active.shape[0]) for gs in state.groups],
        global_slots=[s.n_slots for s in eng._groups.values()],
        param_elems=sum(int(t.numel()) for t in _leaves(eng.params)),
        footprint=eng.cache_footprint(), widths=engine_widths(eng),
        dropped_frac=drops.fraction())


def _drive(eng, jobs: list, device, *, realtime: bool, predict: bool,
           arrivals: bool):
    """Submit and serve ``jobs``: (each job's result, wall seconds)."""
    t0 = time.perf_counter()
    if predict:
        preds = eng.predict([q for q, _ in jobs])
        out = [dict(smiles=p.smiles, n_calls=p.n_calls) for p in preds]
    else:
        rids = [eng.submit(np.asarray(q, np.int32) if isinstance(q, list)
                           else q, mode=m,
                           arrival=float(i) if arrivals else 0.0)
                for i, (q, m) in enumerate(jobs)]
        res = eng.serve(realtime=realtime)
        out = [dict(tokens=np.asarray(res[int(h)].tokens),
                    lengths=np.asarray(res[int(h)].lengths),
                    logprobs=np.asarray(res[int(h)].logprobs),
                    n_calls=int(res[int(h)].n_calls),
                    accepted=int(res[int(h)].accepted)) for h in rids]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def probe(model: dict, engine: dict, calls: list, *, mesh=(2, 2),
          serve_first: list | None = None) -> list:
    """Build an engine, serve ``serve_first`` (token lists) if given, then
    run ``calls``: ``(attributes to set, method name, args)`` each, an
    arg ``("payload", query, mode)`` standing for ``eng._payload(...)``;
    returns each call's result (``("radix_shard", query)`` calls report
    the shard holding the query's cached prefix instead)."""
    eng = _engine(model, engine, mesh, _device(False))
    for q in serve_first or ():
        eng.submit(np.asarray(q, np.int32))
        eng.serve()
    out = []
    for attrs, name, args in calls:
        if name == "radix_shard":
            body = eng.backend.prompt_body(
                eng._payload(np.asarray(args[0], np.int32),
                             eng.default_mode)[1])
            chain = eng.radix.peek(body)
            out.append(eng.allocator.shard_of_page(chain[-1].page)
                       if chain else None)
            continue
        for k, v in attrs.items():
            setattr(eng, k, v)
        args = [eng._payload(np.asarray(a[1], np.int32), a[2])
                if isinstance(a, tuple) and a and a[0] == "payload" else a
                for a in args]
        got = getattr(eng, name)(*args)
        out.append(list(got) if isinstance(got, (list, tuple)) else got)
    return out


def layer(model: dict, kind: str, args: dict, *, mesh=(1, 4),
          block: int = 0, split_rows: bool = False) -> dict:
    """Run layer ``kind`` of pattern position ``block`` (repeat 0) of the model on
    this rank, with the rank's shard of the weights
    (``lay_out_params``) under its ``TensorParallel``, on ``args`` (numpy
    arrays; ``split_rows``: the rank's data shard takes its equal part of
    every array's rows). A state argument is cut to the rank's channels
    or heads. Returns numpy arrays, per-channel ones (states, memory K/V)
    the rank's own:

    - ``moe``: ``moe_ffn(x)`` (``out``, ``dropped``, ``top1``) and
      ``moe_route`` of its rows (``gate_idx``, ``pos``, ``keep``,
      ``capacity``);
    - ``mamba``: ``mamba_mixer(x, lengths)`` with its state, then
      ``mamba_step(x_step)`` from the state ``conv`` / ``ssm``;
    - ``rwkv``: ``rwkv_mixer(x, state=S, x_last=x_tm)`` and
      ``rwkv_channel_mix(x, x_last=x_cm)``;
    - ``xattn``: ``memory_kv(memory)``, then ``cached_cross_attention(x)``
      over it and ``cross_attention(x, memory)``, under ``memory_mask``."""
    from repro_torch.launch.mesh import mesh_tensor_parallel
    from repro_torch.launch.shardings import lay_out_params
    from repro_torch.models import attention, mamba, moe, rwkv
    from repro_torch.sharding import ctx

    cfg, params, _ = _model(model)
    dm = _mesh(mesh)
    tp = mesh_tensor_parallel(dm)
    p = lay_out_params(params, cfg, dm, tp, "cpu")["blocks"][block][0]
    a = {k: torch.from_numpy(np.asarray(v)) for k, v in args.items()}
    if split_rows:
        a = {k: v.chunk(tp.data_size)[tp.data_rank] for k, v in a.items()}

    def own(t, dim, n):
        """``t``'s ``n`` channels of this rank on ``dim``."""
        return t if t.shape[dim] == n else t.narrow(dim, tp.rank * n, n)

    out = {}
    with torch.no_grad(), ctx.tensor_parallel(tp):
        if kind == "moe":
            y, aux = moe.moe_ffn(p["ffn"], cfg, a["x"])
            r = moe.moe_route(p["ffn"], cfg, a["x"].reshape(-1, cfg.d_model))
            out.update(out=y, dropped=aux["moe_dropped_frac"],
                       top1=aux["moe_top1_frac"], gate_idx=r["gate_idx"],
                       pos=r["pos"], keep=r["keep"],
                       capacity=torch.tensor(r["capacity"]))
        elif kind == "mamba":
            pm = p["mamba"]
            y, st = mamba.mamba_mixer(pm, cfg, a["x"], lengths=a["lengths"],
                                      return_state=True)
            n = pm["conv_b"].shape[0]
            cache = {"conv": own(a["conv"], 2, n), "ssm": own(a["ssm"], 1, n)}
            ys, after = mamba.mamba_step(pm, cfg, cache, a["x_step"])
            out.update(out=y, conv=st["conv"], ssm=st["ssm"], step=ys,
                       step_conv=after["conv"], step_ssm=after["ssm"])
        elif kind == "rwkv":
            H = p["rwkv"]["u"].shape[0]
            y, (S, _) = rwkv.rwkv_mixer(p["rwkv"], cfg, a["x"],
                                        state=own(a["S"], 1, H),
                                        x_last=a["x_tm"])
            cm, _ = rwkv.rwkv_channel_mix(p["cmix"], a["x"],
                                          x_last=a["x_cm"])
            out.update(out=y, S=S, cmix=cm)
        elif kind == "xattn":
            pa, mask = p["attn"], a["memory_mask"]
            kv = attention.memory_kv(pa, cfg, a["memory"])
            out.update(mk=kv["mk"], mv=kv["mv"],
                       out=attention.cached_cross_attention(
                           pa, cfg, a["x"], kv, memory_mask=mask),
                       full=attention.cross_attention(
                           pa, cfg, a["x"], a["memory"], memory_mask=mask))
        else:
            raise ValueError(f"unknown layer {kind!r}")
    return {k: np.asarray(v) for k, v in out.items()}


def refusals(model: dict, engine: dict, *, mesh=(2, 2),
             front_door: bool = True) -> str:
    """The error a mesh engine (or, with ``front_door``, a front door over
    one) raises, by type and message; "" when it builds."""
    from repro_torch.serving import FrontDoorServer

    try:
        eng = _engine(model, engine, mesh, _device(False))
        if front_door:
            FrontDoorServer(eng)
    except (NotImplementedError, ValueError, TypeError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
