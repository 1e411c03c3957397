"""Serving launcher, the port of ``repro.launch.serve``: speculative
decoding on a decoder-only architecture (prompt-lookup drafts), one-shot
and then continuous.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --reduced --requests 4 --max-new 48 --device cpu

Runs the one-shot greedy vs speculative comparison, then the continuous
serving pass: the same requests stream through a ``StreamingEngine`` on
the ``DecoderOnlyBackend`` through the request front door (ragged prompts
admitted by chunked prefill into fixed decode slots, optionally on the
paged cache, ``--paged``). Request 0's tokens are read incrementally
through ``handle.stream()`` while the other slots keep decoding; a probe
request with a private token budget and a cancelled request exercise
``GenerationParams`` and ``cancel()``; every engine output is asserted
equal to the one-shot speculative pass, itself asserted equal to greedy.
Weights and prompts come from seeded generators, so the checks are
internal. ``--no-continuous`` skips the serving pass.

``--mesh DATA MODEL`` serves the continuous pass on a ``(data, model)``
mesh: slots and page-pool segments split over DATA, params over MODEL
(attention and cross-attention by head, MoE by expert, Mamba by channel,
RWKV by head), for every decoder-only architecture. Rank 0 prints each
rank's local widths and, for an MoE architecture, the continuous pass's
dropped fraction. Run it inside a world of DATA x MODEL ranks started by
torchrun:

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.serve --arch smollm-135m \\
        --reduced --device cpu --requests 4 --prompt-len 24 --max-new 16 \\
        --paged --mesh 2 2

The backend is NCCL when every rank has a card of its own, gloo when the
ranks share a card or run on the CPU (``repro_torch.launch.world``). Every
rank runs the same program on the same requests; rank 0 prints.
``--device`` defaults to the card.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

EOS_ID = 2


def continuous_demo(params, cfg, prompts: np.ndarray, args, *, device, mesh,
                    say, expected=None) -> None:
    """Decoder-only continuous batching through the StreamingEngine: each
    prompt streams into a freed slot by chunked prefill, interleaved with
    the resident slots' decode steps."""
    from repro_torch.launch.mesh_runs import engine_widths
    from repro_torch.models import moe
    from repro_torch.serving import (EngineConfig, GenerationParams,
                                     RequestCancelled, StreamingEngine)

    B, P = prompts.shape
    n_slots = min(args.slots, B)
    if mesh is not None:
        # every mode group's slots must split evenly over the data shards:
        # round up rather than reject the request count
        data = args.mesh[0]
        n_slots = -(-n_slots // data) * data
    ecfg = EngineConfig(
        mode="speculative", draft_len=args.draft_len, n_drafts=args.n_drafts,
        max_new=args.max_new, max_src=P, n_slots=n_slots,
        prefill_chunk=args.prefill_chunk, eos_id=EOS_ID,
        paged=args.paged, page_size=args.page_size, mesh=mesh)
    eng = StreamingEngine(params, cfg, None, ecfg, device=device)
    # staggered arrivals: admissions interleave with running decodes
    handles = [eng.submit(row, arrival=float(3 * i))
               for i, row in enumerate(prompts)]
    # a low-budget probe sharing the session, and a cancelled request that
    # never runs (queued -> dequeued)
    probe = eng.submit(prompts[0],
                       params=GenerationParams(max_new=args.max_new // 2))
    doomed = eng.submit(prompts[0], arrival=float(3 * B))
    assert doomed.cancel() and doomed.status == "cancelled"
    t0 = time.time()
    with moe.count_drops() as drops:
        # request 0 read incrementally: each delta is the tokens one
        # scheduler iteration committed (the other slots decode in between)
        deltas = list(handles[0].stream())
        results = eng.serve()      # drain the rest of the queue
    dt = time.time() - t0
    ok = [r for r in results.values() if r.status == "finished"]
    acc = sum(r.accepted for r in ok)
    gen = sum(int(r.lengths[0]) for r in ok)
    mesh_txt = ("" if mesh is None else
                f", mesh {tuple(args.mesh)}, {eng.n_shards} data shards")
    say(f"continuous  : {B + 1} requests over {ecfg.n_slots} slots "
        f"({'paged' if args.paged else 'dense'} cache, "
        f"chunk={ecfg.prefill_chunk}{mesh_txt}), {eng.scheduler.n_steps} "
        f"steps, {dt:.2f}s, acceptance={acc / max(gen, 1):.2f}, "
        f"{len(deltas)} stream deltas for request 0")
    if drops.fraction() is not None:
        say(f"moe         : dropped fraction {drops.fraction():.4f} at "
            f"capacity factor {cfg.moe.capacity_factor}")
    if mesh is not None:
        import torch.distributed as dist

        say(f"mesh        : shard_stats {eng.shard_stats()}, loop_stats "
            f"{eng.loop_stats()}")
        widths = [None] * dist.get_world_size()
        dist.all_gather_object(widths, engine_widths(eng))
        for r, w in enumerate(widths):
            say(f"mesh widths : rank {r} {w}")
    r0 = handles[0].result()
    np.testing.assert_array_equal(
        np.concatenate(deltas) if deltas else np.zeros((0,), np.int32),
        r0.tokens[0][:int(r0.lengths[0])])
    assert int(probe.result().lengths[0]) <= args.max_new // 2
    try:
        doomed.result()
        raise AssertionError("cancelled request returned a result")
    except RequestCancelled:
        pass
    if expected is not None:
        for h, want in zip(handles, expected):
            np.testing.assert_array_equal(np.asarray(results[h].tokens[0]),
                                          np.asarray(want))
        say("continuous == one-shot speculative: True "
            "(stream deltas == committed tokens)")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--draft-len", type=int, default=8)
    ap.add_argument("--n-drafts", type=int, default=16)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--paged", action="store_true",
                    help="serve through a paged KV cache (attention archs)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--mesh", type=int, nargs=2, metavar=("DATA", "MODEL"),
                    help="serve the continuous pass on a (data, model) mesh: "
                         "slots and pages split over DATA, params over "
                         "MODEL; run under torchrun --nproc-per-node "
                         "DATA*MODEL")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--no-continuous", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import (greedy_decode, prompt_lookup_drafts,
                                  speculative_greedy_decode,
                                  transformer_handle)
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tr

    args = parse_args(argv)
    kind = resolve_device(args.device).type
    mesh, rank = None, 0
    if args.mesh is not None:
        from repro_torch.launch.mesh import make_serving_mesh
        from repro_torch.launch.world import init_world, rank_device

        rank = int(os.environ.get("RANK", "0"))
        world = int(os.environ.get("WORLD_SIZE", "1"))
        torch.set_num_threads(1)
        init_world(rank, world, device=kind)
        mesh = make_serving_mesh(tuple(args.mesh))
        device = rank_device(rank, kind)
    else:
        device = torch.device(kind)

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.family in ("audio", "seq2seq"):
        raise SystemExit(f"{cfg.name}: serve decoder-only architectures here "
                         f"(the audio encoder has no decode step; the MT "
                         f"serves through examples/ and the engines)")
    params = tr.init(torch.Generator().manual_seed(0), cfg, device=device)
    B, P = args.requests, args.prompt_len
    prompts = torch.randint(4, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32).numpy()
    handle = transformer_handle(params, cfg)
    toks = torch.from_numpy(prompts).to(device)

    @torch.no_grad()
    def fresh():
        c = tr.init_cache(cfg, B, P + args.max_new + args.draft_len + 4,
                          device=device)
        tr.prefill(params, cfg, c, toks[:, :-1])
        return c

    last = toks[:, -1]
    pos = torch.full((B,), P - 1, dtype=torch.int32, device=device)
    with torch.no_grad():
        t0 = time.time()
        g = greedy_decode(handle, fresh(), last, pos, max_new=args.max_new,
                          eos_id=EOS_ID)
        g_tokens = g.tokens.cpu().numpy()
        t_g = time.time() - t0
        ds, ms = zip(*(prompt_lookup_drafts(r, args.draft_len,
                                            args.n_drafts) for r in prompts))
        t0 = time.time()
        s = speculative_greedy_decode(
            handle, fresh(), last, pos,
            torch.from_numpy(np.stack(ds)).to(device),
            torch.from_numpy(np.stack(ms)).to(device),
            max_new=args.max_new, eos_id=EOS_ID)
        s_tokens = s.tokens.cpu().numpy()
        t_s = time.time() - t0
    say(f"arch={cfg.name} B={B} prompt={P} max_new={args.max_new} "
        f"device={device}")
    say(f"greedy      : {int(g.n_calls)} calls, {t_g:.2f}s")
    say(f"speculative : {int(s.n_calls)} calls, {t_s:.2f}s "
        f"acceptance={float(s.acceptance_rate.float().mean()):.2f}")
    same = bool((g_tokens == s_tokens).all())
    say(f"outputs identical: {same}")
    assert same, "speculative tokens differ from greedy"
    if not args.no_continuous:
        continuous_demo(params, cfg, prompts, args, device=device, mesh=mesh,
                        say=say, expected=s_tokens)
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
