"""Rank bodies that drive a ``StreamingEngine`` on a serving mesh and
report what it did: the jobs a ``repro_torch.launch.world.World`` runs on
every rank (the mesh tests and ``chip_smoke.py`` start one world and run
many engines through it).

``layer`` runs one layer function of a model on a mesh rank, under the
rank's tensor-parallel context, on given inputs: the per-layer checks of
the sharded MoE, Mamba, RWKV and cross-attention layers.

``built_step`` runs one ``launch.steps.build_step`` serving step on every
rank of a world (FSDP params gathered over the data axis, the model-axis
cut under the live tensor-parallel context) against the one-rank step on
the same seed, and reports the rank's outputs, the live collectives and
the built step's plan of them.

``front_door`` serves over the wire: the engine on every rank, a
``FrontDoorServer`` over it on every rank (rank 0's holds the socket; its
port is written to a file the caller names), until the caller writes the
stop file; each rank returns its counters. ``late_stream`` subscribes to
a request's stream on rank 0 alone, mid-flight.

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
import importlib
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
    """This rank's device: its card (``on_card``, the default of every job
    function: a machine with no card raises), or the CPU when asked."""
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


def _above(device, fn, *args):
    """``fn(*args)`` and, on the card, the most bytes it held allocated at
    once above what was allocated when it started (None elsewhere)."""
    if device.type != "cuda":
        return fn(*args), None
    torch.cuda.synchronize(device)
    held = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn(*args)
    torch.cuda.synchronize(device)
    return out, torch.cuda.max_memory_allocated(device) - held


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
# |plain| in fp32 (draft_verify: bitwise); the flash backward's:
# |kernel - plain| <= BWD_TOL * (max |plain| + |plain|)
TOL = 2e-5
BWD_TOL = 1e-4


class LaunchGroups:
    """Every launch of the kernels a served engine or a built step reaches
    on the card (a train step's flash backward too), by
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
        from repro_torch.kernels.flash_attention.ref import (
            flash_attention_bwd_ref, flash_attention_ref)

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
        # the flash backward, where the autograd Function calls it:
        # (q, k, v, o, lse, do, key_mask, causal, window, positions)
        self._wrap(importlib.import_module(
            "repro_torch.kernels.flash_attention.ops"), "_backward",
            "flash_attention_bwd",
            lambda a: (*a[0].shape[:3], a[1].shape[2], a[0].shape[3]),
            lambda q, k, v, o, lse, do, key_mask, causal, window,
            positions=None: flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal=causal, window=window,
                key_mask=key_mask, q_pos=positions, k_pos=positions),
            tol=BWD_TOL)
        self._wrap(session, "draft_verify", "draft_verify",
                   lambda a: tuple(a[0].shape), draft_verify_ref)

    def _wrap(self, module, attr: str, kernel: str, shape, ref,
              live=lambda a: True, tol: float | None = None) -> None:
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
                    # outside autograd: a check inside a remat'd forward
                    # must save nothing its recomputation would not
                    with torch.no_grad():
                        e = _disagreement(out, ref(*args, **kw), tol)
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


def _disagreement(out, ref, tol: float | None = None) -> float:
    """The largest |kernel - plain|, or inf where it passes ``TOL`` (a
    tuple: draft_verify's tokens and accepted lengths, held bitwise; with
    ``tol``, the flash backward's dq / dk / dv, each held within ``tol``
    of the plain one's largest |value| plus ``tol`` of its own: the
    kernel's 3xTF32 sums over S keys round another way)."""
    if tol is not None:
        worst = 0.0
        for a, b in zip(out, ref):
            e, b = (a.float() - b.float()).abs(), b.float().abs()
            if not e.numel():
                continue
            if not bool(torch.all(e <= tol * (b.max() + b))):
                return float("inf")
            worst = max(worst, float(e.max()))
        return worst
    if isinstance(out, tuple):
        same = all(torch.equal(a, b) for a, b in zip(out, ref))
        return 0.0 if same else float("inf")
    e = (out.float() - ref.float()).abs()
    if not bool(torch.all(e <= TOL + TOL * ref.float().abs())):
        return float("inf")
    return float(e.max()) if e.numel() else 0.0


def serve(model: dict, engine: dict, jobs: list, *, mesh=(2, 2),
          on_card: bool = True, realtime: bool = False,
          predict: bool = False, arrivals: bool = True,
          serve_first: list | None = None) -> dict:
    """Serve ``jobs`` (``(query, mode)`` pairs; a query is a SMILES string
    or a token list) through one engine and report, on this rank's card
    (``on_card=False``: the CPU). ``mesh``: the mesh shape, or None for an
    unsharded engine in this rank. ``predict``:
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
          serve_first: list | None = None, on_card: bool = True) -> list:
    """Build an engine, serve ``serve_first`` (token lists) if given, then
    run ``calls``: ``(attributes to set, method name, args)`` each, an
    arg ``("payload", query, mode)`` standing for ``eng._payload(...)``;
    returns each call's result (``("radix_shard", query)`` calls report
    the shard holding the query's cached prefix instead). On the rank's
    card unless ``on_card=False``."""
    eng = _engine(model, engine, mesh, _device(on_card))
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
          block: int = 0, split_rows: bool = False,
          on_card: bool = True) -> dict:
    """Run layer ``kind`` of pattern position ``block`` (repeat 0) of the model on
    this rank, with the rank's shard of the weights
    (``lay_out_params``) under its ``TensorParallel``, on ``args`` (numpy
    arrays; ``split_rows``: the rank's data shard takes its equal part of
    every array's rows), on the rank's card unless ``on_card=False``. A
    state argument is cut to the rank's channels or heads. Returns numpy
    arrays, per-channel ones (states, memory K/V)
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

    device = _device(on_card)
    cfg, params, _ = _model(model)
    dm = _mesh(mesh)
    tp = mesh_tensor_parallel(dm)
    p = lay_out_params(params, cfg, dm, tp, device)["blocks"][block][0]
    a = {k: torch.from_numpy(np.asarray(v)).to(device)
         for k, v in args.items()}
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
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def step_collectives(model: dict, tokens, positions, *, cache_len: int,
                     mesh=(1, 2), on_card: bool = True) -> int:
    """The model-axis collectives of one ``transformer.decode_step`` of
    ``tokens`` at ``positions`` (numpy (B, T)) on this rank, with its shard
    of the weights and a fresh cache of ``cache_len`` slots at its widths:
    ``TensorParallel.n_collectives`` after the step (what a dry run's
    recorder counts for the same step)."""
    from repro_torch.launch.mesh import mesh_tensor_parallel
    from repro_torch.launch.shardings import lay_out_params, local_cache_cfg
    from repro_torch.models import transformer as tr
    from repro_torch.sharding import ctx

    device = _device(on_card)
    cfg, params, _ = _model(model)
    tp = mesh_tensor_parallel(_mesh(mesh))
    p = lay_out_params(params, cfg, _mesh(mesh), tp, device)
    tok = torch.as_tensor(np.asarray(tokens), device=device)
    cache = tr.init_cache(local_cache_cfg(cfg, tp), tok.shape[0], cache_len,
                          device=device, widths=tr.local_widths(p, cfg))
    with torch.no_grad(), ctx.tensor_parallel(tp):
        tr.decode_step(p, cfg, cache, tok,
                       torch.as_tensor(np.asarray(positions), device=device))
    return tp.n_collectives


def refusals(model: dict, engine: dict, *, mesh=(2, 2),
             on_card: bool = True) -> str:
    """The error a mesh engine raises, by type and message; "" when it
    builds. On the rank's card unless ``on_card=False``."""
    try:
        _engine(model, engine, mesh, _device(on_card))
    except (NotImplementedError, ValueError, TypeError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def front_door(model: dict, engine: dict, *, port_file: str,
               stop_file: str, mesh=(2, 2), server: dict | None = None,
               warm=None, leader: bool = True,
               on_card: bool = True) -> dict:
    """Serve through ``FrontDoorServer`` over a mesh engine until the
    caller stops it: every rank builds the engine, warms it on ``warm``
    (a ``(query, mode)``: submit, serve, reset) and builds the door
    (``ServerConfig(**server)``). Rank 0 starts the front door, writes its
    port to ``port_file`` and serves until ``stop_file`` exists, then
    shuts the door down, draining when the file says ``drain``; the other
    ranks follow rank 0 until it stops them. ``leader=False``: rank 0
    builds its door but never starts it (a rank 0 that is gone); the other
    ranks report how long they waited before their follower raised.
    Returns this rank's ``stats()``, steps, the scheduler's counters,
    ``shard_stats()``, ``loop_stats()``, launches and launch groups, and
    the follower's error (or None). On the rank's card unless
    ``on_card=False``."""
    import os

    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.serving import FrontDoorServer, ServerConfig

    device = _device(on_card)
    _free(device)
    eng = _engine(model, engine, mesh, device)
    if warm is not None:
        q, m = warm
        eng.submit(np.asarray(q, np.int32) if isinstance(q, list) else q,
                   mode=m)
        eng.serve()
        eng.reset()
    rank = dist.get_rank()
    _build.reset_launch_counts()
    groups = LaunchGroups()
    srv = FrontDoorServer(eng, ServerConfig(**(server or {})))
    error, t0 = None, time.perf_counter()
    try:
        if rank == 0 and not leader:
            return dict(rank=rank, error=None, waited_s=0.0)
        srv.start()
        if rank == 0:
            tmp = f"{port_file}.tmp"
            with open(tmp, "w") as f:
                f.write(str(srv.port))
            os.replace(tmp, port_file)
            while not os.path.exists(stop_file) and srv.error is None:
                time.sleep(0.01)
            drain = False
            if os.path.exists(stop_file):
                with open(stop_file) as f:
                    drain = f.read().strip() == "drain"
            srv.shutdown(drain=drain, timeout=None)
        else:
            try:
                srv.shutdown(timeout=None)
            except RuntimeError as e:
                error = str(e)
    finally:
        groups.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    sch = eng.scheduler
    return dict(
        rank=rank, error=error, waited_s=time.perf_counter() - t0,
        stats=srv.stats(), steps=sch.n_steps, n_cancelled=sch.n_cancelled,
        n_shed=sch.n_shed, shard_stats=eng.shard_stats(),
        loop_stats=eng.loop_stats(), launches=dict(_build.launch_counts),
        groups=groups.report())


# a world step against the one-rank step: |world - one rank| <= STEP_TOL +
# STEP_TOL * |one rank| on every output
STEP_TOL = 1e-4
# Adam's first step moves a param by lr * g / (|g| + eps), eps 1e-9: lr
# times g's sign, unless |g| is within a few hundred eps, where eps and
# fp32 rounding decide it. A train step's param and moments are exempt
# where the two gradients differ in sign, or both lie below TINY_GRAD and
# differ by more than a factor of two
TINY_GRAD = 1e-7
# a gradient leaf against the one-rank step's, over the rank's part:
# ||world - one rank|| <= GRAD_REL * ||one rank||, unless the leaf's
# gradient is rounding (its root mean square below TINY_GRAD)
GRAD_REL = 1e-5


def built_step(arch: str, shape: str, kw: dict | None = None, *,
               mesh=(2, 2), seed: int = 0, shape_override: dict | None = None,
               fields: dict | None = None, timed: bool = False,
               arrays: bool = False, full: bool = False,
               params: str | None = None, seq_shard: bool = False,
               on_card: bool = True) -> dict:
    """Build ``launch.steps.build_step(arch, shape, mesh, **kw)`` on this
    rank of the world (``arch``'s ``reduced()`` config, or with ``full``
    its whole config, with ``fields`` replaced, fp32), run it once on
    ``example_inputs`` (seed ``seed``; ``params``: a ``torch.save`` file
    of the global params to start from instead of the seed's), then the
    one-rank step on the same inputs, cut as the rank holds its outputs
    (``steps.rank_outputs``; on the card the ranks run a train step's
    one at a time). ``shape_override``: this process's
    ``SHAPES`` / ``MT_SHAPES`` entry for ``shape`` while the job runs (a
    test's small shapes: a spawned rank sees none of the caller's
    patches). On the rank's card unless ``on_card=False``; every launch is
    recorded by kernel and shape and each group held to plain
    (``LaunchGroups``). ``timed``: a second call of the world step, timed.
    Returns the rank's coordinates, each output part's largest |world -
    one rank| and whether every element is within ``STEP_TOL``, the live
    collectives ``(kind, bytes)`` of the call, the plan (the same step
    built on a ``MeshShape`` of the mesh's shape, run on meta: its
    ``fsdp_records`` and recorded collectives), launches and launch groups,
    and with ``arrays`` the outputs as numpy arrays (world, one rank).

    A train step (``train_4k``, ``mt_train``) is held part by part: its
    metrics, its gradients after the data-axis reduction and before the
    clip (``trainer.capture_grads``), all within ``STEP_TOL``, each
    gradient leaf also within ``GRAD_REL`` of the one-rank leaf's norm
    (``grad_rel``: the worst leaf's ratio), then its new params and Adam
    moments. Adam's first step moves a param by lr * g / (|g| + 1e-9):
    about lr times the sign of its gradient, so where a gradient is near
    0 (a key bias's, whose true gradient is 0) another order of sums moves
    the param by up to 2 lr. An element of the last three is exempt where
    its two gradients differ in sign (``sign_flips`` counts them) or both
    lie below ``TINY_GRAD`` and differ by more than a factor of two
    (``near_zero``); ``exempt_max_grad`` is the
    largest |gradient| among the exempt elements. With ``arrays`` a train
    step returns the rank's new params and first moments and their
    ``placement`` in the whole leaves, and on the card ``act_bytes``: the
    most bytes the world step and the one-rank step held above their
    inputs.

    ``seq_shard``: the world step and its plan built and run under
    ``ctx.activation_rules(mesh, batch=("data",), seq=("model",))``, the
    residual stream split along T over the model axis where it divides T
    (the one-rank reference, whose model axis is 1, runs whole)."""
    import contextlib
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.sharding import ctx
    from repro_torch.training.optimizer import tree_leaves, tree_unflatten
    from repro_torch.training.trainer import capture_grads

    def ruled(on):
        """The rules the world step and its plan run under."""
        return (ctx.activation_rules(on, batch=("data",), seq=("model",))
                if seq_shard else contextlib.nullcontext())

    device = _device(on_card)
    _free(device)
    kw = dict(kw or {})
    table = steps.MT_SHAPES if shape in steps.MT_SHAPES else steps.SHAPES
    saved = table[shape]
    if shape_override is not None:
        table[shape] = dict(shape_override)
    start = None
    if params is not None:
        start = torch.load(params, map_location=device, weights_only=False)
    try:
        cfg = dataclasses.replace(get_config(arch, reduced=not full),
                                  **(fields or {}))

        def build(on):
            return steps.build_step(arch, shape, on, dtype=torch.float32,
                                    cfg_override=cfg, **kw)

        with ruled(_mesh(mesh)):
            world = build(_mesh(mesh))
        train = world.kind in ("train", "mt_train")
        shape_mesh = MeshShape(("data", "model"), tuple(mesh))
        with ruled(shape_mesh):
            plan = build(shape_mesh)
            plan.fn(*plan.local_inputs)
        planned = list(plan.fsdp_records) + list(
            plan.tp.records if plan.tp is not None else [])
        del plan
        inputs = steps.example_inputs(world, device=device, seed=seed,
                                      params=start)
        world.tp.log = []
        _build.reset_launch_counts()
        groups = LaunchGroups()
        try:
            with capture_grads() as g_world, ruled(_mesh(mesh)):
                got, peak = _above(device, world.fn, *inputs)
        finally:
            groups.close()
        rows = int(_flat(inputs[2] if train else got)[0].shape[0])
        live, world.tp.log = world.tp.log, None
        launches = dict(_build.launch_counts)
        ref = build(MeshShape(("data", "model"), (1, 1)))

        def reference():
            args = steps.example_inputs(ref, device=device, seed=seed,
                                        params=start)
            with capture_grads() as g:
                out, ref_peak = _above(device, ref.fn, *args)
            return out, g, ref_peak

        if train and device.type == "cuda":
            # the ranks share a card: one global train step's activations
            # at a time
            from repro_torch.launch.world import host_group

            for r in range(dist.get_world_size()):
                if r == dist.get_rank():
                    want, g_ref, ref_peak = reference()
                    _free(device)
                dist.barrier(group=host_group(None))
        else:
            want, g_ref, ref_peak = reference()
        del start
        want = steps.rank_outputs(world, want)
    finally:
        table[shape] = saved
    errs, close, flips, near0 = {}, True, 0, 0
    exempt_max = rel = 0.0
    if train:
        gw = g_world[0]
        whole = tree_unflatten(want[0], g_ref[0])
        place = world.rank.placement(whole) if arrays else None
        gr = tree_leaves(world.rank.cut(whole))
        del g_ref, whole
        flipped = [torch.sign(a) != torch.sign(b) for a, b in zip(gw, gr)]
        flips = sum(int(f.sum()) for f in flipped)
        signs = [f | ((torch.maximum(a.abs(), b.abs()) < TINY_GRAD)
                      & ((a - b).abs() > torch.minimum(a.abs(), b.abs())))
                 for f, a, b in zip(flipped, gw, gr)]
        near0 = sum(int(f.sum()) for f in signs) - flips
        for a, b, f in zip(gw, gr, signs):
            if bool(f.any()):
                exempt_max = max(exempt_max, float(torch.maximum(
                    a.abs(), b.abs())[f].max()))
            norm = float(torch.linalg.vector_norm(b.float()))
            if norm >= TINY_GRAD * b.numel() ** 0.5:
                rel = max(rel, float(torch.linalg.vector_norm(
                    (a - b).float())) / norm)
        close &= rel <= GRAD_REL
        pairs = [("metrics", [got[2][k] for k in sorted(want[2])],
                  [want[2][k] for k in sorted(want[2])], None),
                 ("grads", gw, gr, None),
                 ("params", tree_leaves(got[0]), tree_leaves(want[0]), signs),
                 ("mu", tree_leaves(got[1].mu), tree_leaves(want[1].mu),
                  signs),
                 ("nu", tree_leaves(got[1].nu), tree_leaves(want[1].nu),
                  signs)]
        if sorted(got[2]) != sorted(want[2]):
            raise AssertionError(f"built_step {arch} {shape}: metrics "
                                 f"{sorted(got[2])} != {sorted(want[2])}")
    else:
        pairs = [("logits", got, want, None)] if not isinstance(
            got, tuple) else [("logits", got[0], want[0], None),
                              ("cache", got[1], want[1], None)]
    for part, a, b, exempt in pairs:
        fa, fb = ([t.detach() for t in _flat(x)] for x in (a, b))
        if [tuple(t.shape) for t in fa] != [tuple(t.shape) for t in fb]:
            raise AssertionError(
                f"built_step {arch} {shape}: {part} shapes "
                f"{[tuple(t.shape) for t in fa]} != the one-rank step's "
                f"{[tuple(t.shape) for t in fb]}")
        worst = 0.0
        for i, (x, y) in enumerate(zip(fa, fb)):
            # in chunks: a full-size cache is GBs
            cut = (x.reshape(-1).split(1 << 24), y.reshape(-1).split(1 << 24))
            skip = (exempt[i].reshape(-1).split(1 << 24) if exempt else
                    [None] * len(cut[0]))
            for cx, cy, cs in zip(*cut, skip):
                e = (cx.float() - cy.float()).abs()
                if cs is not None:
                    e = torch.where(cs, 0.0, e)
                close &= bool(torch.all(e <= STEP_TOL + STEP_TOL *
                                        cy.float().abs()))
                worst = max(worst, float(e.max()) if e.numel() else 0.0)
        errs[part] = worst
    tp = world.tp
    out = dict(rank=dist.get_rank(), data_rank=tp.data_rank,
               model_rank=tp.rank, note=world.note, errors=errs, close=close,
               collectives=live, plan=planned, launches=launches,
               groups=groups.report(), wall_s=None, rows=rows,
               sign_flips=flips, near_zero=near0, exempt_max_grad=exempt_max,
               grad_rel=rel)
    if train:
        out["metrics"] = {k: float(v) for k, v in got[2].items()}
        # on the card: the most bytes the step held above its inputs, the
        # world rank's at its rows and the one-rank step's at the batch
        out["act_bytes"] = dict(world=peak, one_rank=ref_peak)
    if arrays and train:
        out["arrays"] = dict(
            params=[t.detach().cpu().numpy() for t in tree_leaves(got[0])],
            mu=[t.cpu().numpy() for t in tree_leaves(got[1].mu)],
            placement=place)
    elif arrays:
        out["arrays"] = [[t.cpu().numpy() for t in _flat(x)]
                         for x in (got, want)]
    del got, want, pairs
    if timed:   # after the check: a step writes its cache or params in place
        t0 = time.perf_counter()
        with ruled(_mesh(mesh)):
            world.fn(*inputs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["wall_s"] = time.perf_counter() - t0
    return out


def _flat(tree) -> list:
    """The tensors of an output tree (tuples, dicts, caches), in order."""
    import dataclasses

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in _flat(getattr(tree, f.name))]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat(v)]
    return []


def late_stream(model: dict, engine: dict, query, *, mode: str | None = None,
                after: int = 2, mesh=(2, 2), on_card: bool = True) -> dict:
    """Submit ``query``, serve ``after`` iterations, then subscribe to its
    stream on rank 0 alone (``mesh`` None: an unsharded engine here) and
    serve to the end: the chunks rank 0's sink caught up and collected
    (the other ranks': []), the tokens committed before it subscribed and
    the request's tokens."""
    import torch.distributed as dist

    eng = _engine(model, engine, mesh, _device(on_card))
    h = eng.submit(np.asarray(query, np.int32) if isinstance(query, list)
                   else query, mode=mode)
    for _ in range(after):
        eng._pump_once()
    before = max((log[2] for log in eng._row0_log.values()
                  if log[0] == int(h)), default=0)
    sink = None
    if mesh is None or dist.get_rank() == 0:
        sink = eng.subscribe(int(h))
    eng.serve()
    r = eng._done[int(h)]
    return dict(chunks=[] if sink is None else
                [[int(x) for x in c] for c in sink["buf"]], before=before,
                tokens=np.asarray(r.tokens[0][:int(r.lengths[0])]).tolist())


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
