#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # everything (what the card's run uses)
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only
    python3 chip_smoke.py --quick --baseline DIR   # also time the decode,
                                     # verify and MT flash kernels of
                                     # another tree (DIR, e.g. a git
                                     # archive of an earlier commit) in
                                     # turns with these, and hold the flash
                                     # outputs of the two bitwise equal
    python3 chip_smoke.py --plain-flash bwd   # train only, with the flash
                                     # backward's plain version (all: the
                                     # forward's too), for the loss curve

In order:
  1. print the card's name and power limit; exit nonzero without a card;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
     source, all started together; timed) and print each kernel
     instance's registers and spills (fail if a flash_attention instance
     of the model's head_dim bucket, 32, spills);
  3. hold each kernel against its plain PyTorch version on the card, at the
     test sweeps, the card-only decode lists (split rows, plain loads, the
     ring of stages) and at the main paths' shapes (decode_gqa and
     paged_decode_gqa: the verify pass of 8 slots, the greedy step, and
     where trained serving at B 1 launches them, and the decoder-only
     phase's shapes of ``kernels.cases.DECODE_LM`` / ``PAGED_LM`` at
     SmolLM-135M's heads, the MoE phase's ``DECODE_MOE`` /
     ``PAGED_MOE`` at Phi-3.5-MoE's (H 32 over 8 KV heads, hd 128) and the
     VLM phase's (``vlm_main_shapes``: its ragged prefill, verify pass and
     greedy step, the apply check's prefill and decode step, at
     Llama-3.2-Vision's H 32 over 8, hd 128); draft_verify, bitwise:
     its sweep and card-only list in fp32 and bf16 with NaN / -inf / +inf
     rows, and every launch group of the main path, ``VERIFY_LM`` at
     SmolLM's 49,152, Phi-3.5-MoE's 32,064, RWKV6's 65,536 and
     Llama-3.2-Vision's 128,256 vocabs among them; flash_attention forward
     and backward: the serving encoder's B 16 x S 128 and the training
     batch's B 24 x S 96, H 8, hd 32, the GQA sweep ``FLASH_GQA`` (9 / 3,
     6 / 2, 8 / 2 heads at hd 64, 80, 128, each mask, ragged or not, with
     positions that are not the indices or without), and the decoder-only
     training shapes: SmolLM-135M's B 16 x S 191, 9 heads over 3, hd 64,
     causal, and HuBERT-xlarge's B 4 x S 500, 16 heads of 80,
     bidirectional, and the VLM's apply forward over its first prompt, 32
     heads over 8, hd 128, causal; two calls of each kernel on the same
     inputs must agree bitwise), then time the kernel, the plain version
     and a PyTorch library call (a yardstick only) with CUDA events, median
     over launches with the L2 cache flushed before each, beside the least
     time the card could take (bytes or flops); the decode kernels also
     with each split count at the trained shapes and a long row,
     draft_verify at its launch groups and at a language model's vocabs
     (with each split count there), and a one-element fill as the timing
     floor;
  4. run the port's ReactionEngine at mt-product width (4+4 layers, d_model
     256, 8 heads, d_ff 2048) with weights drawn from a seed, in all four
     modes (16 synthetic queries batched for greedy and speculative, 2 one
     at a time for beam and SBS), with the launch counts set to 0 just
     before and read just after; speculative tokens must equal greedy's;
  5. run the port's StreamingEngine on the paged cache at the same width:
     greedy and speculative with 8 slots and 16 queries submitted at once
     (slots recycle), beam and SBS with 2 slots and 2 queries; counts set to
     0 before each mode and read after (paged_decode_gqa must run,
     decode_gqa must not); tokens must equal the ReactionEngine's; then one
     dense speculative pass, for the cache-copy comparison;
  6. train mt-product on synthetic reactions (``benchmarks/common.py``'s
     set-up: 512 forward reactions, batch 24, max_src = max_tgt = 96,
     constant lr 1e-3, label smoothing 0, clip 1.0, 20 epochs = 420 steps)
     through the port's Trainer: the encoder and decoder self-attention run
     the flash_attention kernels forward and backward (both counts must be
     > 0); the last logged loss must be < 0.7x the first;
  7. serve the trained weights on 64 held-out reactions at B 1 (the paper's
     Table 2 set-up): greedy, then speculative at DL 4 and 10 (24 drafts,
     max_new 72, max_src 96), whose tokens must equal greedy's; wall per
     query, decoder calls, acceptance, top-1 exact match; then one
     speculative paged StreamingEngine pass over the same queries; then
     (after the last phase) draft_verify's launches by (N, T, V) over the
     main path, each group's times and its launch-weighted gap, launches
     x (time - max(bound, floor)), with --baseline the other tree's
     beside; a shape that is no launch group is held to its plain
     version, bitwise, there;
  8. the serving surface on the trained weights: save them and the
     trainer's Adam state with ``repro_torch.checkpoint`` (the JAX package's
     file layout) under ``build/``, load them into fresh params on the card
     (bitwise, step round-trips, no ``msgpack`` module); serve the 64
     held-out queries through ``FrontDoorServer`` on loopback (realtime,
     overload policy with aging on; 32 over SSE and 32 over NDJSON from 16
     client threads): one accepted and one done each, deltas == done ==
     the trained streaming pass's tokens, time to first delta p50 / p95;
     serve them twice through a ``prefix_cache=True`` engine (the second
     pass hits the encoder-output LRU on every lookup and launches no
     flash_attention; tokens equal); ``submit_child`` against a plain
     submit of the joined query and ``cancel_subtree`` on a running parent
     with two queued children (all three cancelled, every page back); two
     in-process replicas behind a ``FleetRouter``, 16 queries through it
     (tokens equal). All five use the trained streaming pass's
     EngineConfig, on the loaded weights; counts set to 0 before each;
  9. the decoder-only phase (``serve_decoder``): SmolLM-135M at full width
     (30 layers, d_model 576, 9 query heads over 3 KV heads, hd 64, d_ff
     1536, vocab 49,152, tied embeddings), weights from seed 0, through
     the decoder-only StreamingEngine: 16 prompts of 64-448 random tokens
     (seed 1) in chunks of 32, max_src 512, max_new 64, EOS 2; greedy and
     speculative (DL 10, 25 drafts) with 8 slots and beam and SBS (5
     beams) with 2 slots and 2 prompts on the paged cache, the speculative
     group again dense; speculative == greedy, SBS == beam, dense ==
     paged, streaming == the one-shot prefill + decode on 4 prompts, the
     full-width prefill's last logits on the card == the CPU's within 1e-4
     of the largest |logit|, and the reduced config's tokens on the card
     == the CPU's in every mode; decode_gqa, paged_decode_gqa and
     draft_verify must each launch; wall per request, scheduler
     iterations, prefill chunks, peak pages and time to the first delta
     per mode;
  10. the prefix-sharing phase (``serve_prefix_sharing``): the same model
     and weights on the paged cache with the radix page cache; a 384-token
     prefix (seed 4) served alone, then 16 children extending it by 16-96
     tokens (seed 5) at 8 slots, max_new 32, greedy and speculative, once
     with ``prefix_cache=False`` (cold) and once shared: shared tokens ==
     cold tokens, paged_decode_gqa and draft_verify launch and decode_gqa
     does not; prints chunks written, ``prefix_stats()``, peak pages,
     wall per request and time to the first delta; the shared greedy pass
     again on a pool of 106 pages (radix evictions > 0, cold tokens);
     ``cancel_subtree`` on a running child with two queued children
     (after ``clear_prefix_cache()`` every page is free); two replicas
     behind a ``FleetRouter``, 8 children of each of two prefixes (tokens
     == a direct engine's; placements by reason, replica hit rates);
  11. the multi-draft phase (``serve_multidraft``): 4 of the decoder-only
     prompts at B 1 and B 4 on a dense cache through
     ``multidraft_speculative_decode`` (one row of T 251 a sequence), the
     expanded-batch speculative decode (25 rows of T 11) and greedy:
     tokens equal, calls equal the expanded path's, with prompt-lookup
     drafts and again with drafts cut from the greedy output (drafts
     accepted whole: every sequence accepts, fewer calls than greedy);
     wall per query, calls and one verify call's device time in each form;
  12. the MoE phase (``serve_moe``): Phi-3.5-MoE at its published widths
     (d_model 4096, 32 heads over 8 KV heads, hd 128, 16 experts top-2 of
     d_ff 6400, vocab 32,064), 4 of its 32 layers, capacity factor 8.0
     (E / top_k: dropless), weights drawn on the card from a CUDA
     generator seeded 0; 16 prompts of 64-448 tokens (seed 1), max_src
     512, max_new 32, chunks of 32, page 16, DL 10, 5 drafts: paged greedy
     and speculative at 8 slots, beam and SBS at 2 x 2, speculative again
     dense; speculative == greedy, SBS == beam, dense == paged, streaming
     == one-shot on the first prompt; then one MoE layer at capacity
     factor 1.25 on the first verify pass's layer-0 input, card vs CPU:
     equal experts and keep mask, outputs within 1e-4, the dropped
     fraction printed;
  13. the recurrent phase (``serve_rwkv``): RWKV6-1.6B whole (24 layers,
     d_model 2048, 32 WKV heads of 64, d_ff 7168, vocab 65,536) on the
     dense cache (a paged engine must be refused); 4 prompts of 64-256
     tokens (seed 6) at 4 slots, max_new 32, DL 10, 25 drafts, greedy and
     speculative: speculative == greedy (the checkpoint rollback),
     streaming == one-shot on the first prompt; prints the checkpoint
     bytes a verify pass holds and the card's peak memory a pass;
  14. reduced Jamba and Llama-4 (``serve_reduced_families``): greedy and
     speculative on the paged cache, card == CPU tokens and calls;
     Jamba's ``prefix_cache`` and multi-draft refusals;
  15. decoder-only training (``train_lm``): SmolLM-135M whole (weights
     from a CUDA generator seeded 0) on the 512 training reactions in
     ``lm_batch`` layout, batch 16, max_len 192, ``make_lm_train_step``'s
     defaults, 8 epochs = 256 steps: the flash kernels forward and
     backward with GQA must launch, the last logged loss must be < 0.7x
     the first; then the trained weights serve 32 held-out reactions
     ([bos] + src + [sep] prompts) through the paged decoder-only
     StreamingEngine, greedy and speculative (DL 10, 25 prompt-lookup
     drafts): speculative == greedy; exact-match top-1, acceptance and
     wall per request printed;
  16. HuBERT-xlarge at full width (``train_hubert``): 4 train steps at B 4
     x T 500 on seeded frames and codebook labels, bidirectional flash;
     steps/s and the peak memory above the phase's start;
  17. Llama-3.2-Vision-11B at full width cut to its first 5-layer block
     (``serve_vlm``): 4 prompts of 64-256 tokens, 1,601 memory tokens with
     a ragged memory mask; greedy == expanded speculative ==
     ``multidraft_speculative_decode``, and ``apply``'s logits ==
     ``prefill`` + ``decode_step``'s;
  18. run a tiny model on the card and on the CPU with the same weights: the
     card's tokens must match the CPU's plain path, one-shot and paged
     streaming, and a streaming speculative pass at draft_len 32 (T 33
     fed positions), and one train step's loss and gradients must match
     within 1e-4; then 50 train steps on both, printing the first step
     whose losses part by more than 1e-4; then one ``make_lm_train_step``
     step of every reduced decoder-only arch, the VLM and HuBERT, whose
     loss, metrics and gradients must match within 1e-4;
  19. the mesh phase (``serve_mesh``): a ``(data 2, model 2)`` world of 4
     ranks sharing the one card over gloo (the backend rule: NCCL refuses
     two ranks on one card). First ``repro_torch.launch.serve --mesh 2 2
     --paged`` under torchrun: SmolLM-135M whole, 8 requests of 128
     tokens, max_new 48, every check of that script. Then one world
     serves SmolLM-135M (8 prompts of 24-64 tokens, max_new 12, 2 slots a
     mode, the four modes, paged and dense) and mt-product (16 queries in
     the four modes, max_new 32, paged; and tests/test_sharded.py's pool
     of 52 pages of 8 at 4
     speculative slots, where a segment runs dry: preemptions > 0, each
     naming its shard), each against the same engine unsharded on the
     card in this process: tokens equal on every rank, log-probs within
     1e-4. Prints walls a request sharded and unsharded (tagged: the 4
     ranks share one card, so no time here is a multi-card figure),
     ``shard_stats()``, peak pages by shard, collectives an iteration and
     each rank's launches; a rank that launched no decode_gqa,
     paged_decode_gqa, draft_verify or flash_attention fails. Every
     launch of a rank (and of the unsharded engine) is recorded by kernel
     and input shape (``mesh_runs.LaunchGroups``): the first launch of
     each group is held against the kernel's plain version on the same
     inputs (fp32 within 2e-5 absolute and relative, draft_verify
     bitwise), the groups must cover every launch counted, and the
     ranks' draft_verify groups join the main path's shape accounting
     (timed and held to plain there); these shapes, a rank's local heads
     (mt-product's H = Kv = 4), rows and segment, no other phase
     launches. Then every decoder-only family on the same world
     (``family_runs``): Phi-3.5-MoE at full width cut to 2 of 32 layers
     (capacity factor 8.0, dropless; weights drawn on the card, the ranks
     one at a time), four modes at 2 slots a mode, paged; Llama-4, Jamba,
     RWKV6 (dense) and the VLM reduced, greedy and speculative, paged;
     8 prompts of 24-64 tokens, max_new 12; each against the unsharded
     engine as above, printing the MoE dropped fraction, the data-axis
     collectives (the router's global counts) and each rank's local
     widths; a rank of a family run that launched no draft_verify, or on
     an attention family no paged_decode_gqa, fails. Then the CLI on
     Jamba reduced (``--mesh 2 2 --paged``); last, each decode read's
     launch group of the family runs timed alone against its plain
     version and bound on seeded inputs at its shape;
  20. print the ``kernels`` JSON line, the card line, and
     ``{"ok": true, "device": {...}}`` last.

Every Molecular Transformer serving phase must launch flash_attention (the
encoder).

Any failed check raises, so the exit code is nonzero and no result prints.
fp32 throughout with TF32 off. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and fp32
# (non-tensor-core) rate; the bound is the larger of bytes/rate, flops/rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SEED = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        f"nvidia-smi failed: {out.stderr.strip()}")


def timed_ms(torch, fn, iters: int = 50, warm: int = 5) -> float:
    """Median device time of ``fn`` per call (CUDA events), with the 50 MB
    L2 flushed before each call: on the main path the next layer's cache
    and weights pass through L2 between two calls. A ~1 ms device-side
    sleep before each start event keeps the card busy while the host
    enqueues ``fn``, so the events time the device work and not the
    host's Python and launch overhead."""
    flush = torch.empty(64 * 2**20 // 4, device="cuda")
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def report_ptxas(source: str, log: str) -> None:
    """Print registers and spills of every kernel instance from nvcc's
    ``-Xptxas=-v`` output (flash instances as ``name<type, head_dim
    bucket>``, ``, pos`` for the instances that mask by positions, ``,
    gqa`` for the dK/dV instances that loop over a group of query heads);
    fail if a flash instance the MT runs (its bucket, hd 32, index masks,
    one query head a kv head) spills.
    The others' spills are printed: the decoder-only models' hd 64 and
    HuBERT's hd 80 (the 128 bucket), and the position-masked instances."""
    import re

    label, spills = None, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            m = re.search(r"(flash_fwd|flash_bwd_dq|flash_bwd_dkdv)I"
                          r"(f|13__nv_bfloat16)?Li(\d+)ELb([01])E"
                          r"(?:Lb([01])E)?", mangled)
            d = re.search(r"(decode_attention_kernel)I(f|13__nv_bfloat16)"
                          r"Li(\d+)ELi(\d+)E", mangled)
            dtypes = {"f": "float, ", "13__nv_bfloat16": "bf16, "}
            if m is not None:
                label = (f"{m.group(1)}<{dtypes.get(m.group(2), '')}"
                         f"{m.group(3)}{', pos' if m.group(4) == '1' else ''}"
                         f"{', gqa' if m.group(5) == '1' else ''}>")
            elif d is not None:   # <type, head_dim bucket, rows a pass>
                label = (f"{d.group(1)}<{dtypes[d.group(2)]}{d.group(3)}, "
                         f"{d.group(4)}>")
            else:
                label = mangled
            continue
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if stores:
            spills = (int(stores.group(1)), int(stores.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            print(f"  {source}: {label}: {regs.group(1)} registers, spill "
                  f"stores/loads {spills} bytes")
            if (label and label.startswith("flash_") and
                    re.search(r"\b32>$", label) and spills != (0, 0)):
                raise AssertionError(f"{label} spills: {spills} bytes")
        elif "error" in line:
            print(f"  {source}: {line.strip()}")


# ---------------------------------------------------------------------------
# kernel checks


def on_card(torch, arrays, dtype=None):
    """numpy inputs on the card (floats in ``dtype``, default fp32)."""
    dtype = dtype or torch.float32
    return [torch.from_numpy(a).to("cuda", dtype) if a.dtype == np.float32
            else torch.from_numpy(a).cuda() for a in arrays]


def sdpa_gqa(F, q, k, v, mask):
    """``scaled_dot_product_attention`` over (B, heads, T, hd) tensors whose
    K/V may carry fewer heads than q (GQA: ``enable_gqa``, one call)."""
    return F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=k.shape[1] != q.shape[1])


def decode_work(q, kc, k_pos, q_pos):
    """Bytes and flops that cached attention needs for these inputs: each
    input read once and the output written once, counting only the K/V of
    slots that some query of the row can see (the output does not depend
    on the rest), and 4·hd flops (QK^T and PV) per visible (query head,
    key) pair."""
    B, T, H, hd = q.shape
    Kv = kc.shape[2]
    qmax = q_pos.max(1, keepdims=True)
    visible = ((k_pos >= 0) & (k_pos <= qmax)).sum()
    pairs = ((k_pos[:, None, :] >= 0)
             & (k_pos[:, None, :] <= q_pos[:, :, None])).sum()
    nbytes = (2 * visible * Kv * hd * kc.itemsize + 2 * q.nbytes
              + k_pos.nbytes + q_pos.nbytes)
    return int(nbytes), int(4 * hd * H * pairs)


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, (
        "bytes" if t_bytes >= t_ops else "operations")


def paged_work(q, k_pool, pos_pool, bt, q_pos):
    """Bytes and flops that one paged read needs for these inputs, from the
    visible keys only: a key counts when its block is mapped, its stored
    position is >= 0 and <= the newest query of a row that maps it, and a
    page several rows alias (a shared prefix) counts once. Bytes: those
    keys' K and V, the stored positions of the mapped pages, the block
    table, q, the output and q_pos; flops: 4·hd per visible (query head,
    key) pair of each row."""
    B, T, H, hd = q.shape
    ps, Kv = k_pool.shape[1], k_pool.shape[2]
    mapped = bt >= 0
    kpos = np.where(mapped[..., None], pos_pool[np.where(mapped, bt, 0)], -1
                    ).reshape(B, -1)
    qmax = q_pos.max(1, keepdims=True)
    key_id = (np.where(mapped, bt, 0)[..., None] * ps
              + np.arange(ps)).reshape(B, -1)
    visible = np.unique(key_id[(kpos >= 0) & (kpos <= qmax)]).size
    pairs = ((kpos[:, None, :] >= 0)
             & (kpos[:, None, :] <= q_pos[:, :, None])).sum()
    nbytes = (2 * visible * Kv * hd * k_pool.itemsize + 2 * q.nbytes
              + np.unique(bt[mapped]).size * ps * pos_pool.itemsize
              + bt.nbytes + q_pos.nbytes)
    return int(nbytes), int(4 * hd * H * pairs)


PAGED_KEYS = ("B", "T", "H", "Kv", "P", "ps", "nb", "hd")
DECODE_KEYS = ("B", "T", "H", "Kv", "S", "hd")


def decode_main_shapes(ecfg, n_queries: int) -> dict:
    """The dense read's timed shapes (H 8, hd 32: mt-product's heads): the
    one-shot verify pass of ``n_queries`` slots x N_d drafts and its greedy
    step, then where trained serving at B 1 (``TABLE2``) launches it: the
    24 drafts at each draft length (T = DL + 1, S = max_new + DL + 2) and
    the greedy step (S = max_new + 2); and the card-only long row (B 1, S
    600), which the kernel splits over several blocks."""
    from repro_torch.kernels.cases import DECODE_CARD_ONLY

    H, hd = 8, 32
    main = {"speculative": dict(B=n_queries * ecfg.n_drafts,
                                T=ecfg.draft_len + 1, H=H, Kv=H,
                                S=ecfg.max_new + ecfg.draft_len + 2, hd=hd,
                                window=0),
            "greedy": dict(B=n_queries, T=1, H=H, Kv=H, S=ecfg.max_new + 2,
                           hd=hd, window=0),
            "trained_greedy": dict(B=1, T=1, H=H, Kv=H,
                                   S=TABLE2["max_new"] + 2, hd=hd, window=0)}
    for dl in TABLE2["draft_lens"]:
        main[f"trained_dl{dl}"] = dict(B=TABLE2["n_drafts"], T=dl + 1, H=H,
                                       Kv=H, S=TABLE2["max_new"] + dl + 2,
                                       hd=hd, window=0)
    main["long_row"] = DECODE_CARD_ONLY[0]   # split over several blocks
    return main


def paged_main_shapes(ecfg, n_queries: int) -> dict:
    """The paged read's timed shapes: the streaming engine's speculative
    group (``n_queries`` slots x N_d rows) and greedy group, and the
    trained streaming pass (``TRAINED_SLOTS`` slots x 24 drafts, DL 10,
    ceil((max_new + DL + 2) / 16) blocks of 16); and the card-only long
    row's paged twin."""
    from repro_torch.kernels.cases import PAGED_CARD_ONLY

    H, hd, ps = 8, 32, ecfg.page_size
    nb_spec = -(-(ecfg.max_new + ecfg.draft_len + 2) // ps)
    nb_greedy = -(-(ecfg.max_new + 2) // ps)
    B_spec = n_queries * ecfg.n_drafts
    dl = max(TABLE2["draft_lens"])
    B_tr = TRAINED_SLOTS * TABLE2["n_drafts"]
    return {"speculative": dict(B=B_spec, T=ecfg.draft_len + 1, H=H, Kv=H,
                                P=1 + 4 * B_spec, ps=ps, nb=nb_spec, hd=hd,
                                window=0, n_mapped=4),
            "greedy": dict(B=n_queries, T=1, H=H, Kv=H, P=1 + 3 * n_queries,
                           ps=ps, nb=nb_greedy, hd=hd, window=0, n_mapped=3),
            "trained_streaming": dict(
                B=B_tr, T=dl + 1, H=H, Kv=H, P=1 + 4 * B_tr, ps=16,
                nb=-(-(TABLE2["max_new"] + dl + 2) // 16), hd=hd, window=0,
                n_mapped=4),
            "long_row": dict(PAGED_CARD_ONLY[0],
                             n_mapped=PAGED_CARD_ONLY[0]["nb"] - 1)}


def check_paged(torch, ecfg, n_queries: int) -> dict:
    """paged_decode_gqa against its plain version on the card: the shared
    paged sweep and the card-only list in fp32 and bf16, the tables whose
    rows alias a shared prefix's pages (``cases.PAGED_ALIASED``), then the
    timed shapes (``paged_main_shapes``, the decoder-only phase's and the
    aliased tables), timed beside their visible-key bound
    and the library yardstick (the ``paged_view`` gather, then
    ``scaled_dot_product_attention``: two calls, since no one PyTorch call
    computes paged attention); at the trained streaming shape and the long
    row also with each split count."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_decode_gqa_attention
    from repro_torch.kernels.cases import (PAGED_ALIASED, PAGED_CARD_ONLY,
                                           PAGED_LM, PAGED_MOE, PAGED_SWEEP,
                                           aliased_paged_inputs, paged_inputs)
    from repro_torch.kernels.decode_gqa.kernel import (
        paged_decode_gqa_kernel, plan_splits)
    from repro_torch.kernels.decode_gqa.ref import paged_decode_gqa_ref
    from repro_torch.models.attention import PagedKVCache, paged_view

    keys = PAGED_KEYS
    main = dict(paged_main_shapes(ecfg, n_queries), **PAGED_LM, **PAGED_MOE)
    err = 0.0
    cases = [(c, dt) for c in PAGED_SWEEP + PAGED_CARD_ONLY
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(c, torch.float32) for c in main.values()]
    for c, dt in cases:
        x = on_card(torch, paged_inputs(*(c[k] for k in keys),
                                        n_mapped=c.get("n_mapped")), dt)
        out = paged_decode_gqa_attention(*x, window=c["window"])
        ref = paged_decode_gqa_ref(*x, window=c["window"])
        torch.cuda.synchronize()
        tol = 2e-5 if dt == torch.float32 else 2e-2
        e = (out.float() - ref.float()).abs()
        if not torch.all(e <= tol + tol * ref.float().abs()):
            raise AssertionError(f"paged_decode_gqa disagrees at {c} {dt}: "
                                 f"max err {e.max().item()}")
        if dt == torch.float32:
            err = max(err, e.max().item())
    # an inactive row gives 0: check_decode_determinism
    # the prefix-sharing phase's tables: rows alias the same leading pages
    aliased = {name: aliased_paged_inputs(*(c[k] for k in (
        "B", "T", "H", "Kv", "ps", "nb", "hd", "n_shared", "n_private")))
        for name, c in PAGED_ALIASED.items()}
    for name, arrays in aliased.items():
        x = on_card(torch, arrays)
        ref = paged_decode_gqa_ref(*x)
        e = (paged_decode_gqa_attention(*x) - ref).abs()
        torch.cuda.synchronize()
        if not torch.all(e <= 2e-5 + 2e-5 * ref.abs()):
            raise AssertionError(f"paged_decode_gqa disagrees on the aliased "
                                 f"table {name}: max err {e.max().item()}")
        err = max(err, e.max().item())

    shapes = {}
    for name, c in dict(main, **PAGED_ALIASED).items():
        arrays = (aliased[name] if name in aliased else
                  paged_inputs(*(c[k] for k in keys), n_mapped=c["n_mapped"]))
        x = on_card(torch, arrays)
        q, kp_, vp_, pp_, bt_, qp_ = x
        cache = PagedKVCache(k_pool=kp_, v_pool=vp_, pos=pp_, block_tables=bt_)
        qt = q.transpose(1, 2)

        def library():
            k, v, kpos = paged_view(cache)
            mask = ((kpos[:, None, :] >= 0)
                    & (kpos[:, None, :] <= qp_[:, :, None]))[:, None]
            return sdpa_gqa(F, qt, k.transpose(1, 2), v.transpose(1, 2),
                            mask)

        nbytes, flops = paged_work(arrays[0], arrays[1], arrays[3],
                                   arrays[4], arrays[5])
        bound_ms, bound_by = bound(nbytes, flops)
        n_split = plan_splits(c["B"], c["Kv"], c["nb"] * c["ps"],
                              c["T"] * c["H"] // c["Kv"], c["hd"])
        shapes[name] = dict(
            shape={d: c[d] for d in keys}, n_split=n_split,
            ms=timed_ms(torch, lambda: paged_decode_gqa_attention(*x)),
            plain_ms=timed_ms(torch, lambda: paged_decode_gqa_ref(*x)),
            library_ms=timed_ms(torch, library),
            bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by)
        if name.startswith("trained") or name == "long_row":
            shapes[name]["split_ms"] = {n: timed_ms(
                torch, lambda: paged_decode_gqa_kernel(*x, n_split=n))
                for n in SPLIT_SWEEP}
    return dict(max_abs_err=err, shapes=shapes)


def flash_work(B, S, H, hd, *, causal: bool, lengths=None, itemsize=4,
               backward: bool = False, with_lse: bool = True, Kv=None):
    """Bytes and flops that full-sequence attention needs for these inputs:
    each input read once and each output written once, counting the K/V
    reads of valid keys only (Kv kv heads, default H); the forward's lse
    write only ``with_lse`` (training keeps it for the backward, inference
    needs none); flops per visible (query, key) pair of each query head:
    4·hd forward (QK^T, PV), 10·hd backward (QK^T and dO·V^T recomputed,
    then dV, dQ, dK)."""
    Kv = H if Kv is None else Kv
    lengths = np.full(B, S) if lengths is None else np.asarray(lengths)
    qi, ki = np.arange(S)[:, None], np.arange(S)[None, :]
    vis = (ki <= qi) if causal else np.ones((S, S), bool)
    pairs = H * sum(int((vis & (ki < n)).sum()) for n in lengths)
    rows = B * S * H * hd              # q (and out, dO, dQ) elements
    keys = int(lengths.sum()) * Kv * hd  # K or V elements of valid keys
    mask = 0 if lengths.min() == S else B * S
    if not backward:
        lse = B * H * S * 4 if with_lse else 0
        nbytes = (2 * rows + 2 * keys) * itemsize + lse + mask
        return int(nbytes), int(4 * hd * pairs)
    nbytes = (4 * rows + 2 * keys + 2 * B * S * Kv * hd) * 4 + (
        B * H * S * 4 + mask)          # q,o,dO,dq + k,v + dk,dv; lse, mask
    return int(nbytes), int(10 * hd * pairs)


def check_flash(torch, main: dict) -> dict:
    """flash_attention forward and backward against their plain versions on
    the card: the shared sweep (JAX test shapes x causal / bidirectional /
    window 24, fp32 and bf16 forward, fp32 backward, with and without a
    ragged key mask), the GQA sweep (``FLASH_GQA``: q_per_kv 1, 3, 4 at hd
    80, 64, 128, the same masks, also with positions that are not the
    indices, fp32; bf16 forward without positions), then the main shapes
    (``main``: name -> B, S, H, Kv, hd, causal, lengths), timed beside
    their bound and the library yardstick (``scaled_dot_product_attention``
    with ``enable_gqa`` where Kv < H and the key mask as a bool mask, or
    ``is_causal``; its autograd backward for the backward)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_bshd
    from repro_torch.kernels.cases import (FLASH_GQA, FLASH_MASKS,
                                           FLASH_PLAIN_LOADS, FLASH_SWEEP,
                                           flash_inputs, permuted_positions,
                                           ragged_lengths)
    from repro_torch.kernels.flash_attention.ops import _backward, _forward
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)

    def inputs(B, S, H, hd, lengths, dtype=torch.float32, Kv=None):
        q, k, v, do, km = flash_inputs(B, S, H, hd, lengths=lengths, Kv=Kv)
        x = on_card(torch, (q, k, v, do), dtype)
        return x, None if km is None else torch.from_numpy(km).cuda()

    def agree(name, out, ref, tol):
        e = (out.float() - ref.float()).abs()
        if not torch.all(e <= tol + tol * ref.float().abs()):
            raise AssertionError(f"{name}: max err {e.max().item()}")
        return e.max().item()

    err_f = err_b = 0.0
    cases = [(c, cw, ragged, False) for c in FLASH_SWEEP + FLASH_PLAIN_LOADS
             for cw in FLASH_MASKS for ragged in (False, True)]
    cases += [(c, cw, ragged, pos) for c in FLASH_GQA for cw in FLASH_MASKS
              for ragged in (False, True) for pos in (False, True)]
    cases += [(dict(B=m["B"], S=m["S"], H=m["H"], hd=m["hd"],
                    Kv=m.get("Kv")), (m["causal"], 0), m["lengths"], False)
              for m in main.values()]
    for c, (causal, window), ragged, pos in cases:
        lengths = (ragged if not isinstance(ragged, bool) else
                   ragged_lengths(c["B"], c["S"]) if ragged else None)
        positions = (torch.from_numpy(permuted_positions(c["B"], c["S"])
                                      ).cuda() if pos else None)
        for dt in (torch.float32, torch.bfloat16):
            if pos and dt != torch.float32:
                continue   # the kernels take positions in fp32 only
            (q, k, v, do), km = inputs(c["B"], c["S"], c["H"], c["hd"],
                                       lengths, dt, c.get("Kv"))
            kw = dict(causal=causal, window=window, key_mask=km,
                      q_pos=positions, k_pos=positions)
            kern_kw = dict(causal=causal, window=window, key_mask=km,
                           positions=positions)
            label = f"{c} {causal} {window} pos {pos}"
            out = flash_attention_bshd(q, k, v, **kern_kw)
            ref, _ = flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            tol = 2e-5 if dt == torch.float32 else 2e-2
            e = agree(f"flash_attention {label} {dt}", out, ref, tol)
            if dt != torch.float32:
                continue
            err_f = max(err_f, e)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            grads = torch.autograd.grad(flash_attention_bshd(*leaves,
                                                             **kern_kw),
                                        leaves, do)
            o, lse = flash_attention_ref(q, k, v, **kw)
            refs = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            for g, r, n in zip(grads, refs, ("dq", "dk", "dv")):
                err_b = max(err_b, agree(f"flash_attention_bwd {n} {label}",
                                         g, r, 1e-4))

    # no atomics: two calls on the same inputs agree bitwise, at the MT's
    # train encoder and at the GQA training shapes (dK/dV summed over the
    # group in registers)
    for name in ("train_encoder", "smollm_train", "hubert_train"):
        m = main[name]
        (q, k, v, do), km = inputs(m["B"], m["S"], m["H"], m["hd"],
                                   m["lengths"], Kv=m.get("Kv"))
        fw = [_forward(q, k, v, km, m["causal"], 0, with_lse=True)
              for _ in range(2)]
        bw = [_backward(q, k, v, *fw[0], do, km, m["causal"], 0)
              for _ in range(2)]
        torch.cuda.synchronize()
        for kern, (a, b) in (("flash_attention", fw),
                             ("flash_attention_bwd", bw)):
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"{kern} [{name}]: two calls on the "
                                     f"same inputs differ")

    fwd, bwd = {}, {}
    for name, m in main.items():
        B, S, H, hd, causal = (m[k] for k in ("B", "S", "H", "hd", "causal"))
        Kv = m.get("Kv", H)
        (q, k, v, do), km = inputs(B, S, H, hd, m["lengths"], Kv=Kv)
        kw = dict(causal=causal, window=0, key_mask=km)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_kw = (dict(is_causal=True) if km is None and causal else
                  dict(attn_mask=None if km is None else km[:, None, None]))
        if Kv != H:
            lib_kw["enable_gqa"] = True
        if km is not None and causal:
            raise ValueError("no main shape is causal with a key mask")
        shape = dict(B=B, S=S, H=H, Kv=Kv, hd=hd, causal=causal,
                     ragged=m["lengths"] is not None)
        nbytes, flops = flash_work(B, S, H, hd, causal=causal,
                                   lengths=m["lengths"],
                                   with_lse=m["backward"], Kv=Kv)
        bound_ms, bound_by = bound(nbytes, flops)
        fwd[name] = dict(
            shape=shape,
            ms=timed_ms(torch, lambda: _forward(q, k, v, km, causal, 0,
                                                with_lse=m["backward"])),
            plain_ms=timed_ms(torch, lambda: flash_attention_ref(q, k, v,
                                                                 **kw)),
            library_ms=timed_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, **lib_kw)),
            bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by)
        if not m["backward"]:
            continue
        o, lse = _forward(q, k, v, km, causal, 0, with_lse=True)
        lq, lk, lv = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, **lib_kw)
        dot = do.transpose(1, 2)
        nbytes, flops = flash_work(B, S, H, hd, causal=causal,
                                   lengths=m["lengths"], backward=True,
                                   Kv=Kv)
        bound_ms, bound_by = bound(nbytes, flops)
        bwd[name] = dict(
            shape=shape,
            ms=timed_ms(torch, lambda: _backward(q, k, v, o, lse, do, km,
                                                 causal, 0)),
            plain_ms=timed_ms(torch, lambda: flash_attention_bwd_ref(
                q, k, v, o, lse, do, **kw)),
            library_ms=timed_ms(torch, lambda: torch.autograd.grad(
                lib_out, (lq, lk, lv), dot, retain_graph=True)),
            bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by)
    return {"flash_attention": dict(max_abs_err=err_f, shapes=fwd),
            "flash_attention_bwd": dict(max_abs_err=err_b, shapes=bwd)}


def check_decode_determinism(torch, ecfg, n_queries: int) -> None:
    """No float atomics: two calls of each decode kernel on the same inputs
    agree bitwise, dense and paged, at a shape split over several blocks
    (the card-only B 1 rows) and at one with one block a (row, kv head)
    (the verify pass); and a paged row whose queries and table are all -1
    gives 0, split and unsplit."""
    from repro_torch.kernels import (decode_gqa_attention,
                                     paged_decode_gqa_attention)
    from repro_torch.kernels.cases import (DECODE_CARD_ONLY, PAGED_CARD_ONLY,
                                           decode_inputs, paged_inputs)
    from repro_torch.kernels.decode_gqa.kernel import plan_splits

    runs = []
    for c in (DECODE_CARD_ONLY[0], decode_main_shapes(ecfg, n_queries)[
            "speculative"]):
        x = on_card(torch, decode_inputs(*(c[k] for k in DECODE_KEYS)))
        n = plan_splits(c["B"], c["Kv"], c["S"], c["T"] * c["H"] // c["Kv"],
                        c["hd"])
        runs.append((f"decode_gqa {c} ({n} splits)",
                     lambda x=x: decode_gqa_attention(*x)))
    for c in (PAGED_CARD_ONLY[0], paged_main_shapes(ecfg, n_queries)[
            "speculative"]):
        arrays = list(paged_inputs(*(c[k] for k in PAGED_KEYS),
                                   n_mapped=c.get("n_mapped")))
        x = on_card(torch, arrays)
        n = plan_splits(c["B"], c["Kv"], c["nb"] * c["ps"],
                        c["T"] * c["H"] // c["Kv"], c["hd"])
        runs.append((f"paged_decode_gqa {c} ({n} splits)",
                     lambda x=x: paged_decode_gqa_attention(*x)))
        arrays[4][0] = -1
        arrays[5][0] = -1
        out = paged_decode_gqa_attention(*on_card(torch, arrays))
        if not (torch.isfinite(out).all() and not out[0].any()):
            raise AssertionError(f"paged_decode_gqa: inactive row is not 0 "
                                 f"at {c} ({n} splits)")
    for label, fn in runs:
        a, b = fn(), fn()
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: two calls on the same inputs "
                                 f"differ")


def verify_main_shapes(ecfg, n_slots: int, n_oneshot: int, vocab: int,
                       trained_vocab: int) -> dict:
    """draft_verify's launch groups, (N, T, V) by name: the streaming
    verify pass (``n_slots`` x N_d rows, T = DL + 1) and greedy step
    (``n_slots`` rows, T 1), their one-shot twins at ``n_oneshot`` queries,
    and trained serving at B 1 (``TABLE2``: greedy, 24 drafts at each draft
    length, the streaming pass of ``TRAINED_SLOTS`` x 24) at the trained
    tokenizer's vocab. The main path's run counts its own shapes
    (``VerifyShapes``); a shape it launches that is not here is timed
    after it."""
    T = ecfg.draft_len + 1
    main = {"speculative": (n_slots * ecfg.n_drafts, T, vocab),
            "greedy": (n_slots, 1, vocab),
            "oneshot_speculative": (n_oneshot * ecfg.n_drafts, T, vocab),
            "oneshot_greedy": (n_oneshot, 1, vocab),
            "trained_greedy": (1, 1, trained_vocab)}
    for dl in TABLE2["draft_lens"]:
        main[f"trained_dl{dl}"] = (TABLE2["n_drafts"], dl + 1, trained_vocab)
    main["trained_streaming"] = (TRAINED_SLOTS * TABLE2["n_drafts"],
                                 max(TABLE2["draft_lens"]) + 1, trained_vocab)
    return main


# draft_verify's timed card-only shapes: the USPTO-MIT vocab at the verify
# pass of 8 slots, a decoder-only verify pass (24 drafts, DL 10) at
# SmolLM's 49,152 and a greedy step at Qwen3's 151,936 (split path)
VERIFY_TIMED_CARD_ONLY = {"uspto_vocab": (200, 11, 320),
                          "lm_verify": (24, 11, 49_152),
                          "lm_greedy": (1, 1, 151_936)}


def verify_timing(torch, N: int, T: int, V: int) -> dict:
    """draft_verify at (N, T, V) fp32 (``kernels.cases`` inputs): the kernel,
    the plain version and ``torch.argmax`` (tokens only; a yardstick),
    beside the bound: each input read once and each output written once,
    one compare per logit."""
    from repro_torch.kernels import draft_verify
    from repro_torch.kernels.cases import verify_inputs
    from repro_torch.kernels.draft_verify.kernel import (draft_verify_kernel,
                                                         plan)
    from repro_torch.kernels.draft_verify.ref import draft_verify_ref

    x = on_card(torch, verify_inputs(N, T, V))
    logits = x[0]
    nbytes = sum(t.nbytes for t in x) + (N * T + N) * 4
    bound_ms, bound_by = bound(nbytes, N * T * V)
    p = plan(N, T, V, 4)
    out = dict(shape=dict(N=N, T=T, V=V),
               ms=timed_ms(torch, lambda: draft_verify(*x)),
               plain_ms=timed_ms(torch, lambda: draft_verify_ref(*x)),
               library_ms=timed_ms(torch, lambda: torch.argmax(logits,
                                                               dim=-1)),
               bytes=nbytes, flops=N * T * V, bound_ms=bound_ms,
               bound_by=bound_by)
    if p.rows and not p.lanes:
        out["path"] = f"greedy kernel: {p.rows} row(s) a block, a warp each"
    elif p.rows:
        out["path"] = (f"row path: {p.rows} row(s) a block, {p.warps} "
                       f"warp(s) a row, {p.lanes} lanes a position")
    else:   # the split path, also with each split count forced
        out.update(path=f"split path, {p.chunk} entries a split",
                   n_split=p.n_split, split_ms={n: timed_ms(
                       torch, lambda: draft_verify_kernel(*x, n_split=n))
                       for n in VERIFY_SPLIT_SWEEP})
    return out


def verify_agrees(torch, N: int, T: int, V: int, dt) -> None:
    """draft_verify at (N, T, V) in ``dt`` on ``verify_inputs(special=
    True)``: tokens and accepted lengths equal to the plain version's, in
    one launch (none for no rows)."""
    from repro_torch.kernels import _build, draft_verify
    from repro_torch.kernels.cases import verify_inputs
    from repro_torch.kernels.draft_verify.ref import draft_verify_ref

    x = on_card(torch, verify_inputs(N, T, V, special=True), dt)
    before = _build.launch_counts["draft_verify"]
    tok, acc = draft_verify(*x)
    launched = _build.launch_counts["draft_verify"] - before
    rtok, racc = draft_verify_ref(*x)
    torch.cuda.synchronize()
    if not (torch.equal(tok, rtok) and torch.equal(acc, racc)):
        raise AssertionError(f"draft_verify disagrees at {(N, T, V)} {dt}")
    if launched != (1 if N else 0):
        raise AssertionError(f"draft_verify at {(N, T, V)}: {launched} "
                             f"launches")


def check_verify(torch, main: dict) -> dict:
    """draft_verify against its plain version on the card, bitwise (tokens
    and accepted lengths): the shared sweep and the card-only list in fp32
    and bf16 and the launch groups (``main``) in fp32, each with the NaN /
    -inf / +inf row of ``verify_inputs(special=True)``; T 40 must launch the
    kernel. Then each launch group and ``VERIFY_TIMED_CARD_ONLY`` timed
    (``verify_timing``)."""
    from repro_torch.kernels.cases import (VERIFY_CARD_ONLY, VERIFY_LM,
                                           VERIFY_SWEEP)

    main = dict(main, **VERIFY_LM)
    cases = [(c, dt) for c in VERIFY_SWEEP + VERIFY_CARD_ONLY
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(c, torch.float32) for c in main.values()]
    for (N, T, V), dt in cases:
        verify_agrees(torch, N, T, V, dt)
    shapes = {name: verify_timing(torch, *c)
              for name, c in dict(main, **VERIFY_TIMED_CARD_ONLY).items()}
    return dict(max_abs_err=0.0, shapes=shapes)


class VerifyShapes:
    """Counts the (N, T, V) of every ``draft_verify`` call the decoding
    session makes on the card, around the session's own reference to the
    op (the call itself, and its launch count, are the op's)."""

    def __init__(self):
        import threading

        import repro_torch.core.session as session

        self.counts: dict[tuple, int] = {}
        self._lock = threading.Lock()   # the fleet phase's two drive threads
        self._op = session.draft_verify
        session.draft_verify = self

    def __call__(self, logits, drafts, draft_mask):
        if logits.is_cuda:
            key = tuple(logits.shape)
            with self._lock:
                self.counts[key] = self.counts.get(key, 0) + 1
        return self._op(logits, drafts, draft_mask)

    def reset(self) -> None:
        with self._lock:
            self.counts = {}

    def read(self) -> dict:
        with self._lock:
            return dict(self.counts)


_verify_shapes: VerifyShapes | None = None   # installed by main()


def reset_counts() -> None:
    """Every launch count, and draft_verify's shape counts, to 0."""
    from repro_torch.kernels import reset_launch_counts

    reset_launch_counts()
    if _verify_shapes is not None:
        _verify_shapes.reset()


def verify_shapes() -> dict:
    """draft_verify's launches by (N, T, V) since ``reset_counts``."""
    return {} if _verify_shapes is None else _verify_shapes.read()


def check_kernels(torch, ecfg, n_queries: int, verify_main: dict,
                  flash_main: dict, decode_extra: dict) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import decode_gqa_attention
    from repro_torch.kernels.cases import (DECODE_CARD_ONLY, DECODE_SWEEP,
                                           decode_inputs, ring_inputs)
    from repro_torch.kernels.decode_gqa.kernel import (decode_gqa_kernel,
                                                       plan_splits)
    from repro_torch.kernels.decode_gqa.ref import decode_gqa_ref

    from repro_torch.kernels.cases import DECODE_LM, DECODE_MOE

    results = {}
    # -- decode_gqa ---------------------------------------------------------
    err = 0.0
    main = dict(decode_main_shapes(ecfg, n_queries), **DECODE_LM,
                **DECODE_MOE, **decode_extra)
    cases = [(c, dt) for c in DECODE_SWEEP + DECODE_CARD_ONLY
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(c, torch.float32) for c in main.values()]
    for c, dt in cases:
        shape = [c[k] for k in DECODE_KEYS]
        x = on_card(torch, decode_inputs(*shape, prefix=c.get("prefix")), dt)
        out = decode_gqa_attention(*x, window=c["window"])
        ref = decode_gqa_ref(*x, window=c["window"])
        torch.cuda.synchronize()
        tol = 2e-5 if dt == torch.float32 else 2e-2
        e = (out.float() - ref.float()).abs()
        if not torch.all(e <= tol + tol * ref.float().abs()):
            raise AssertionError(f"decode_gqa disagrees at {c} {dt}: "
                                 f"max err {e.max().item()}")
        if dt == torch.float32:
            err = max(err, e.max().item())
    x = on_card(torch, ring_inputs())
    e = (decode_gqa_attention(*x, window=32) - decode_gqa_ref(*x, window=32)
         ).abs().max().item()
    torch.cuda.synchronize()
    if e > 2e-5:
        raise AssertionError(f"decode_gqa ring buffer: max err {e}")
    err = max(err, e)

    check_decode_determinism(torch, ecfg, n_queries)

    shapes = {}
    for name, c in main.items():
        arrays = decode_inputs(*(c[k] for k in DECODE_KEYS),
                               prefix=c.get("prefix"))
        x = on_card(torch, arrays)
        q, k, v, kp, qp = x
        visible = ((kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[:, :, None]))
        mask = visible[:, None]                            # (B, 1, T, S)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        nbytes, flops = decode_work(arrays[0], arrays[1], arrays[3],
                                    arrays[4])
        bound_ms, bound_by = bound(nbytes, flops)
        shapes[name] = dict(
            shape={d: c[d] for d in DECODE_KEYS + ("prefix",) if d in c},
            n_split=plan_splits(c["B"], c["Kv"], c["S"],
                                c["T"] * c["H"] // c["Kv"], c["hd"]),
            ms=timed_ms(torch, lambda: decode_gqa_attention(*x)),
            plain_ms=timed_ms(torch, lambda: decode_gqa_ref(*x)),
            library_ms=timed_ms(torch, lambda: sdpa_gqa(F, qt, kt, vt,
                                                        mask)),
            bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by)
        if name.startswith("trained") or name == "long_row":
            shapes[name]["split_ms"] = {n: timed_ms(
                torch, lambda: decode_gqa_kernel(*x, n_split=n))
                for n in SPLIT_SWEEP}
    results["decode_gqa"] = dict(max_abs_err=err, shapes=shapes)

    # -- paged_decode_gqa ---------------------------------------------------
    results["paged_decode_gqa"] = check_paged(torch, ecfg, n_queries)

    # -- draft_verify -------------------------------------------------------
    results["draft_verify"] = check_verify(torch, verify_main)
    results.update(check_flash(torch, flash_main))
    return results


# ---------------------------------------------------------------------------
# the main path


def run_engine(torch, ds, cfg, params, ecfg_kw: dict, queries, modes,
               device="cuda"):
    """Each mode's predictions and launch counts (counts set to 0 just
    before the mode runs, read just after)."""
    from repro_torch.kernels import launch_counts
    from repro_torch.serving import EngineConfig, ReactionEngine

    out = {}
    for mode in modes:
        eng = ReactionEngine(params, cfg, ds.tokenizer,
                             EngineConfig(mode=mode, **ecfg_kw),
                             device=device)
        reset_counts()
        t0 = time.perf_counter()
        if mode in ("greedy", "speculative"):
            preds = eng.predict(queries)
        else:
            preds = [eng.predict_topn(q) for q in queries]
        wall = time.perf_counter() - t0
        out[mode] = dict(preds=preds, wall_s=wall,
                         launches=dict(launch_counts), shapes=verify_shapes())
    return out


def kernel_events(prof) -> list:
    """(name, device time in us, count) of every kernel in a profile
    (CPU ops also carry their kernels' time, so only device rows)."""
    return [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.device_time_total > 0]


def device_busy_ms(torch, fn, iters: int = 5, warm: int = 2) -> float:
    """Device time of ``fn`` per call: its kernels' times summed under
    torch.profiler. For a whole eager model call this, not a CUDA-event
    span, is the device's work: a call of a few thousand launches fills
    the launch queue, so the host's enqueue leaves gaps in the span."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(t for _, t, _ in kernel_events(prof)) / iters / 1e3


def report_profile(prof, wall_us: float, label: str, path: Path) -> None:
    """Print the device's busy share (sum of kernel times over the wall
    time; overlapping kernels would count twice, and eager PyTorch on one
    stream runs none) and the top kernels by device time; write the full
    table to ``path``."""
    events = kernel_events(prof)
    busy_us = sum(t for _, t, _ in events)
    events.sort(key=lambda e: -e[1])
    top = ", ".join(f"{k[:40]} {t / 1e3:.1f} ms x{n}"
                    for k, t, n in events[:8])
    print(f"profile [{label}]: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), "
          f"top: {top}", flush=True)
    path.write_text(prof.key_averages().table(sort_by="device_time_total",
                                              row_limit=-1))


def profile_modes(torch, ds, cfg, params, ekw, queries, modes,
                  out_dir: Path) -> None:
    """One traced one-shot run per mode (``report_profile``), tables in
    ``out_dir/profile_<mode>.txt``. The beam modes trace one query: their
    traces hold ~10^6 events per 8 queries, which take minutes to
    aggregate."""
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    for mode in modes:
        qs = queries if mode in ("greedy", "speculative") else queries[:1]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_engine(torch, ds, cfg, params, ekw, qs, (mode,))
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        report_profile(prof, wall_us, f"{mode}, {len(qs)} queries",
                       out_dir / f"profile_{mode}.txt")


# slots and queries of each streaming mode: greedy-family groups of 8 slots
# take 16 queries at once (slots recycle), beam groups 2 slots, 2 queries
STREAM_PLAN = {"greedy": (8, 16), "speculative": (8, 16), "beam": (2, 2),
               "speculative_beam": (2, 2)}


def run_streaming(torch, ds, cfg, params, ekw: dict, queries, plan: dict, *,
                  paged: bool, device="cuda"):
    """Each mode through a StreamingEngine (``plan``: mode -> (slots,
    queries)), every query submitted at once and served; launch counts set
    to 0 just before each mode and read just after. Returns per mode the
    SMILES and log-probs per query (best first), wall, steps, pages and
    counts."""
    from repro_torch.kernels import launch_counts
    from repro_torch.serving import EngineConfig, StreamingEngine

    out = {}
    for mode, (n_slots, n_q) in plan.items():
        eng = StreamingEngine(params, cfg, ds.tokenizer, EngineConfig(
            mode=mode, n_slots=n_slots, paged=paged, **ekw), device=device)
        qs = queries[:n_q]
        if device == "cuda":
            torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        handles = [eng.submit(q) for q in qs]
        res = eng.serve()
        wall = time.perf_counter() - t0
        launches = dict(launch_counts)
        shapes = verify_shapes()
        results = [res[int(h)] for h in handles]
        out[mode] = dict(
            smiles=[[ds.tokenizer.decode(t) for t in r.tokens]
                    for r in results],
            logprobs=[np.asarray(r.logprobs, np.float64) for r in results],
            n_calls=[r.n_calls for r in results],
            accepted=sum(r.accepted for r in results)
            / max(1, sum(int(r.lengths[0]) for r in results)),
            wall_s=wall, steps=eng.loop_stats()["n_iterations"],
            footprint=eng.cache_footprint(), launches=launches,
            shapes=shapes, preemptions=eng.scheduler.n_preemptions)
        if paged:
            eng.allocator.check()
    return out


def profile_streaming(torch, ds, cfg, params, ekw: dict, queries,
                      out_dir: Path, n_warm: int = 10,
                      n_traced: int = 12) -> None:
    """Trace a few steady-state iterations of the speculative StreamingEngine
    (8 slots, 16 queries), paged and dense: ``n_warm`` untraced iterations,
    then ``n_traced`` traced (``report_profile``), then the rest untraced."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import EngineConfig, StreamingEngine

    out_dir.mkdir(parents=True, exist_ok=True)
    for paged in (True, False):
        eng = StreamingEngine(params, cfg, ds.tokenizer, EngineConfig(
            mode="speculative", n_slots=8, paged=paged, **ekw))
        for q in queries[:16]:
            eng.submit(q)
        pump = eng.serve_steps()
        for _ in range(n_warm):
            next(pump)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_traced):
                next(pump)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        eng.serve()
        kind = "paged" if paged else "dense"
        report_profile(prof, wall_us,
                       f"streaming speculative {kind}, {n_traced} iterations",
                       out_dir / f"profile_streaming_{kind}.txt")


# the train phase: benchmarks/common.py's set-up at mt-product width
TRAIN = dict(n_train=512, n_test=64, batch=24, max_len=96, lr=1e-3,
             epochs=20, log_every=21)
# the decoder-only train phase: SmolLM-135M whole on the same synthetic
# forward reactions in ``lm_batch`` layout ([bos] + src + [sep] + tgt +
# [eos], loss on the target), ``make_lm_train_step``'s defaults (lr 3e-4,
# no label smoothing, clip 1.0); 32 steps an epoch; then greedy and
# speculative serving of the trained weights on held-out reactions
LM_TRAIN = dict(arch="smollm-135m", n_train=512, n_test=32, batch=16,
                max_len=192, epochs=8, log_every=16, draft_len=10,
                n_drafts=25, max_new=96, n_slots=8, page_size=16,
                prefill_chunk=32)
# HuBERT-xlarge at full width: a few train steps on seeded frame
# embeddings, labels from the 504-entry codebook
HUBERT = dict(arch="hubert-xlarge", batch=4, frames=500, steps=4)
# the VLM at full width, cut to its first 5-layer block: 4 prompts of
# 64-256 tokens (seed 7), a memory of 1,601 tokens masked to ragged lengths
# (apply_tail: the apply check's decode_step feeds the first prompt's last
# 8 tokens after a prefill of the rest)
VLM = dict(arch="llama-3.2-vision-11b", n_prompts=4, len_lo=64, len_hi=256,
           seed=7, memory_lengths=[1601, 1200, 800, 400], gate=0.5,
           draft_len=10, n_drafts=5, max_new=32, eos_id=2, apply_tail=8)
# the reduced configs held card == CPU for one LM train step
LM_ARCHS = ("command-r-35b", "qwen3-8b", "llama-3.2-vision-11b",
            "jamba-v0.1-52b", "llama4-maverick-400b-a17b", "starcoder2-15b",
            "smollm-135m", "rwkv6-1.6b", "phi3.5-moe-42b-a6.6b",
            "hubert-xlarge")
# the trained-serving phase: the paper's Table 2 (B 1), as
# benchmarks/table2_speculative_greedy.py runs it
TABLE2 = dict(max_new=72, max_src=96, n_drafts=24, draft_lens=(4, 10))
TRAINED_SLOTS = 8   # slots of the trained streaming pass


def trained_stream_kw() -> dict:
    """The trained streaming pass's EngineConfig. Every later phase held to
    its tokens serves with this config: the decode kernels' split counts
    follow the shapes it sets (slots, draft length, max_src), and another
    config may move a logit's last bits and so break an argmax tie."""
    return dict(mode="speculative", n_slots=TRAINED_SLOTS, paged=True,
                page_size=16, draft_len=max(TABLE2["draft_lens"]),
                max_new=TABLE2["max_new"], max_src=TABLE2["max_src"],
                n_drafts=TABLE2["n_drafts"])
# split counts the decode kernels are also timed with at the trained shapes
# (the choice of kernel.py's plan_splits); and those draft_verify is timed
# with at the shapes of its split path (the choice of its plan)
SPLIT_SWEEP = (1, 2, 3, 4, 8)
VERIFY_SPLIT_SWEEP = (1, 2, 4, 8, 16, 32, 64)


def check_encoder_launches(launches: dict, label: str) -> None:
    """A serving phase runs the encoder through the flash_attention forward
    kernel, and never its backward."""
    if launches["flash_attention"] == 0 or launches["flash_attention_bwd"]:
        raise AssertionError(f"{label}: flash_attention launches {launches}")


def train_step(cfg):
    from repro_torch.training import make_seq2seq_train_step

    return make_seq2seq_train_step(cfg, lr=TRAIN["lr"], label_smoothing=0.0,
                                   max_grad_norm=1.0)


def run_training(torch, train_ds):
    """Train mt-product (seeded init) on ``train_ds`` with the port's
    Trainer; launch counts set to 0 just before and read just after.
    Returns (trainer, summary)."""
    from repro_torch.configs.mt import product_config, with_vocab
    from repro_torch.data import batched_dataset
    from repro_torch.kernels import launch_counts
    from repro_torch.models import seq2seq as s2s
    from repro_torch.training import Trainer

    cfg = with_vocab(product_config(), train_ds.tokenizer.vocab_size)
    params = s2s.init(torch.Generator().manual_seed(SEED), cfg, device="cuda")
    trainer = Trainer(cfg, params, train_step(cfg))
    n = TRAIN["max_len"]

    def batches():
        for _ in range(TRAIN["epochs"]):
            yield from batched_dataset(train_ds.tokenizer, train_ds.pairs(),
                                       TRAIN["batch"], n, n)

    n_steps = TRAIN["epochs"] * (len(train_ds) // TRAIN["batch"])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    hist = trainer.fit(batches(), log_every=TRAIN["log_every"], verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts)
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: loss not finite {losses}")
    if launches["flash_attention"] == 0 or launches["flash_attention_bwd"] == 0:
        raise AssertionError(f"train: flash_attention launches {launches}")
    if not losses[-1] < 0.7 * losses[0]:
        raise AssertionError(f"train: last loss {losses[-1]} is not < 0.7 x "
                             f"the first {losses[0]}")
    print(f"train [mt-product, {len(train_ds)} reactions, batch "
          f"{TRAIN['batch']}, {TRAIN['epochs']} epochs]: {n_steps} steps in "
          f"{wall:.2f} s, {n_steps / wall:.2f} steps/s, launches {launches}",
          flush=True)
    print("train loss curve (step, loss, token accuracy, grad norm): "
          + ", ".join(f"({h['step']}, {h['loss']:.4f}, "
                      f"{h['token_accuracy']:.4f}, {h['grad_norm']:.3f})"
                      for h in hist), flush=True)
    return trainer, dict(steps=n_steps, wall_s=wall, losses=losses,
                         launches=launches)


def profile_training(torch, trainer, train_ds, out_dir: Path,
                     n_steps: int = 6) -> None:
    """Trace ``n_steps`` train steps of a copy of ``trainer``'s model (so
    the weights served next stay those of the timed run), after one
    untraced warm-up step (``report_profile``); the table goes to
    ``out_dir/profile_train.txt``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import batched_dataset
    from repro_torch.training import Trainer

    n = TRAIN["max_len"]
    batches = list(batched_dataset(train_ds.tokenizer, train_ds.pairs(),
                                   TRAIN["batch"], n, n))[:n_steps + 1]
    copy = Trainer(trainer.cfg, trainer.params, train_step(trainer.cfg))
    copy.fit(batches[:1], verbose=False)
    batches = batches[1:]
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        copy.fit(batches, log_every=n_steps, verbose=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, wall_us, f"train, {n_steps} steps",
                   out_dir / "profile_train.txt")


def serve_trained(torch, tok, cfg, params, test_ds) -> dict:
    """The trained weights on the held-out queries at B 1 (one
    ``predict([q])`` per query, as Table 2): greedy, speculative at each
    draft length (tokens must equal greedy's), then one speculative paged
    StreamingEngine pass with every query submitted at once. Launch counts
    set to 0 before each run, read after."""
    from repro_torch.kernels import launch_counts
    from repro_torch.serving import (EngineConfig, ReactionEngine,
                                     StreamingEngine)

    queries = [test_ds.pair(i)[0] for i in range(len(test_ds))]
    targets = [test_ds.pair(i)[1] for i in range(len(test_ds))]
    base = dict(max_new=TABLE2["max_new"], max_src=TABLE2["max_src"],
                n_drafts=TABLE2["n_drafts"])
    runs = {"greedy": dict(mode="greedy")}
    runs.update({f"speculative_dl{dl}": dict(mode="speculative",
                                             draft_len=dl)
                 for dl in TABLE2["draft_lens"]})
    out = {}
    for name, kw in runs.items():
        eng = ReactionEngine(params, cfg, tok, EngineConfig(**base, **kw))
        eng.predict(queries[:1])                             # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        preds = [eng.predict([q])[0] for q in queries]
        wall = time.perf_counter() - t0
        out[name] = dict(
            smiles=[p.smiles[0] for p in preds], wall_s=wall,
            n_calls=sum(p.n_calls for p in preds),
            acceptance=float(np.mean([p.acceptance_rate for p in preds])),
            launches=dict(launch_counts), shapes=verify_shapes())
    eng = StreamingEngine(params, cfg, tok, EngineConfig(**trained_stream_kw()))
    eng.submit(queries[0])
    eng.serve()                                              # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    handles = [eng.submit(q) for q in queries]
    res = eng.serve()
    wall = time.perf_counter() - t0
    results = [res[int(h)] for h in handles]
    out["streaming_speculative"] = dict(
        smiles=[tok.decode(r.tokens[0]) for r in results], wall_s=wall,
        tokens=[r.tokens[0][:int(r.lengths[0])].tolist() for r in results],
        n_calls=eng.loop_stats()["n_iterations"],
        acceptance=sum(r.accepted for r in results)
        / max(1, sum(int(r.lengths[0]) for r in results)),
        launches=dict(launch_counts), shapes=verify_shapes())
    greedy = out["greedy"]
    for name, r in out.items():
        if r["smiles"] != greedy["smiles"]:
            bad = [i for i, (a, b) in enumerate(zip(r["smiles"],
                                                    greedy["smiles"]))
                   if a != b]
            raise AssertionError(f"trained {name}: tokens differ from greedy "
                                 f"on queries {bad}")
        check_encoder_launches(r["launches"], f"trained {name}")
        top1 = float(np.mean([a == b for a, b in zip(r["smiles"], targets)]))
        n_q = len(queries)
        per = ("request (8 slots, all submitted at once)"
               if name.startswith("streaming") else
               f"query (B 1), speedup vs greedy "
               f"{greedy['wall_s'] / r['wall_s']:.3f}x")
        print(f"trained serving [{name}] {n_q} held-out queries: wall "
              f"{r['wall_s']:.3f} s, {r['wall_s'] / n_q * 1e3:.2f} ms per "
              f"{per}, decoder calls {r['n_calls']}, acceptance "
              f"{r['acceptance']:.4f}, top-1 {top1:.4f}, launches "
              f"{r['launches']}", flush=True)
    return out


# -- the serving surface on the trained weights: checkpoint, front door,
# encoder-output reuse, tree of requests, fleet ------------------------------
WIRE_CLIENTS = 16    # concurrent client threads of the front-door phase
FLEET_QUERIES = 16
FLEET_STAGGER_S = 0.02   # between the fleet phase's client arrivals


def same_tree(torch, a, b) -> bool:
    """Bitwise equality of two trees of tensors (dict keys as sets)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_tree(torch, a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (len(a) == len(b)
                and all(same_tree(torch, x, y) for x, y in zip(a, b)))
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.device == b.device and torch.equal(a, b))


def check_checkpoint(torch, trainer, build_dir: Path) -> dict:
    """Save the trained params and the trainer's Adam state (the JAX
    package's file layout, the port's own codec), load the file into fresh
    params on the card: every leaf bitwise equal, the steps round-trip, and
    no ``msgpack`` module was imported. Returns the loaded params."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.models import seq2seq as s2s
    from repro_torch.training.optimizer import adam_init

    build_dir.mkdir(parents=True, exist_ok=True)
    path = build_dir / "chip_smoke_mt_product.msgpack"
    step = trainer.opt_state.step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(str(path), params=trainer.params,
                    opt_state=trainer.opt_state, step=step)
    save_s = time.perf_counter() - t0
    fresh = s2s.init(torch.Generator().manual_seed(SEED + 3), trainer.cfg,
                     device="cuda")
    t0 = time.perf_counter()
    got = load_checkpoint(str(path), params_like=fresh,
                          opt_like=adam_init(fresh))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    opt = got["opt"]
    checks = {"params": same_tree(torch, got["params"], trainer.params),
              "mu": same_tree(torch, opt.mu, trainer.opt_state.mu),
              "nu": same_tree(torch, opt.nu, trainer.opt_state.nu),
              "step": got["step"] == step and opt.step == step,
              "no msgpack": "msgpack" not in sys.modules}
    if not all(checks.values()):
        raise AssertionError(f"checkpoint round trip: {checks}")
    size = path.stat().st_size
    print(f"checkpoint [mt-product, params + Adam state, step {step}]: "
          f"{size} bytes, save {save_s:.3f} s, load onto the card "
          f"{load_s:.3f} s; every leaf bitwise equal, step round-trips, "
          f"no msgpack module", flush=True)
    return got["params"]


def wire_request(port: int, query: str, sse: bool) -> dict:
    """One request over the front door's socket (SSE or NDJSON): its
    events, the seconds to the first delta and to the end."""
    import socket

    req = {"query": query}
    t0 = time.perf_counter()
    first = None
    events = []
    with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
        if sse:
            body = json.dumps(req).encode()
            s.sendall(f"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                      f"Content-Type: application/json\r\nContent-Length: "
                      f"{len(body)}\r\n\r\n".encode() + body)
        else:
            s.sendall(json.dumps({"op": "generate", **req}).encode() + b"\n")
        buf, head = b"", not sse
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
            if not head:
                if b"\r\n\r\n" not in buf:
                    continue
                status, _, buf = buf.partition(b"\r\n\r\n")
                if b" 200 " not in status.split(b"\r\n", 1)[0]:
                    raise AssertionError(f"front door answered {status!r}")
                head = True
            sep = b"\n\n" if sse else b"\n"
            *frames, buf = buf.split(sep)
            for f in frames:
                if not f.strip():
                    continue
                ev = json.loads(f[len(b"data: "):] if sse else f)
                if ev["event"] == "delta" and first is None:
                    first = time.perf_counter() - t0
                events.append(ev)
    return dict(events=events, first_s=first,
                wall_s=time.perf_counter() - t0)


def check_wire_events(label: str, i: int, events: list, want: list) -> None:
    """One accepted and one done, the deltas concatenated equal the done
    tokens, and the tokens equal the trained streaming pass's."""
    kinds = [e["event"] for e in events]
    if kinds.count("accepted") != 1 or kinds.count("done") != 1 \
            or kinds[-1] != "done" or events[-1]["status"] != "finished":
        raise AssertionError(f"{label} query {i}: events {kinds}, last "
                             f"{events[-1] if events else None}")
    deltas = [t for e in events if e["event"] == "delta" for t in e["tokens"]]
    done = events[-1]["tokens"][0]
    if deltas != done or done != want:
        raise AssertionError(f"{label} query {i}: deltas {deltas}, done "
                             f"{done}, trained streaming pass {want}")


def warm_engine(tok, cfg, params, query, **kw):
    from repro_torch.serving import EngineConfig, StreamingEngine

    eng = StreamingEngine(params, cfg, tok,
                          EngineConfig(**trained_stream_kw(), **kw))
    eng.submit(query)
    eng.serve()
    eng.reset()
    return eng


def percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def serve_front_door(torch, tok, cfg, params, queries, want) -> dict:
    """The 64 held-out queries through ``FrontDoorServer`` on loopback
    (realtime drive, overload policy with aging on) from concurrent client
    threads, half over SSE and half over NDJSON; every request's events
    checked against the trained streaming pass."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import launch_counts
    from repro_torch.serving import (FrontDoorServer, OverloadPolicy,
                                     ServerConfig)

    eng = warm_engine(tok, cfg, params, queries[0],
                      overload=OverloadPolicy(aging_rate=0.05))
    srv = FrontDoorServer(eng, ServerConfig(realtime=True)).start()
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(WIRE_CLIENTS) as pool:
            futs = [pool.submit(wire_request, srv.port, q, i % 2 == 0)
                    for i, q in enumerate(queries)]
            res = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        launches, shapes = dict(launch_counts), verify_shapes()
        stats = srv.stats()
    finally:
        srv.shutdown(drain=False)
    for i, r in enumerate(res):
        check_wire_events("front door", i, r["events"], want[i])
    check_stream_launches(launches, "front door")
    first = [r["first_s"] for r in res]
    n = len(queries)
    print(f"front door [trained mt-product, {n} held-out queries, "
          f"{n // 2} SSE + {n - n // 2} NDJSON, {WIRE_CLIENTS} client "
          f"threads, realtime, aging 0.05]: wall {wall:.3f} s, "
          f"{wall / n * 1e3:.2f} ms per request; time to first delta p50 "
          f"{percentile(first, 50) * 1e3:.2f} ms, p95 "
          f"{percentile(first, 95) * 1e3:.2f} ms; request wall p50 "
          f"{percentile([r['wall_s'] for r in res], 50) * 1e3:.2f} ms; "
          f"scheduler steps {stats['n_steps']}, preemptions "
          f"{stats['n_preemptions']}, launches {launches}; every request "
          f"one accepted + one done, deltas == done == the trained "
          f"streaming pass", flush=True)
    return dict(wall_s=wall, launches=launches, shapes=shapes,
                first_s=first)


def check_stream_launches(launches: dict, label: str) -> None:
    """A paged speculative phase runs paged_decode_gqa and draft_verify,
    never decode_gqa, and the encoder through flash_attention."""
    if launches["paged_decode_gqa"] == 0 or launches["draft_verify"] == 0 \
            or launches["decode_gqa"]:
        raise AssertionError(f"{label}: launches {launches}")
    check_encoder_launches(launches, label)


def serve_encode_reuse(torch, tok, cfg, params, queries, want) -> dict:
    """The 64 queries twice through a ``prefix_cache=True`` engine: the
    second pass hits the encoder-output LRU on every lookup and launches no
    encoder flash kernel; both passes' tokens equal the trained pass's."""
    from repro_torch.kernels import launch_counts

    eng = warm_engine(tok, cfg, params, queries[0], prefix_cache=True)
    out = []
    for n_pass in (1, 2):
        before = eng.prefix_stats()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        handles = [eng.submit(q) for q in queries]
        res = eng.serve()
        wall = time.perf_counter() - t0
        launches, shapes = dict(launch_counts), verify_shapes()
        after = eng.prefix_stats()
        toks = [res[int(h)].tokens[0][:int(res[int(h)].lengths[0])].tolist()
                for h in handles]
        if toks != want:
            bad = [i for i, (a, b) in enumerate(zip(toks, want)) if a != b]
            raise AssertionError(f"encoder reuse pass {n_pass}: tokens "
                                 f"differ from the trained pass on {bad}")
        hit = after["hit_tokens"] - before["hit_tokens"]
        look = after["lookup_tokens"] - before["lookup_tokens"]
        if n_pass == 1:
            check_stream_launches(launches, "encoder reuse pass 1")
        elif hit != look or launches["flash_attention"] \
                or launches["flash_attention_bwd"] \
                or launches["paged_decode_gqa"] == 0:
            raise AssertionError(f"encoder reuse pass 2: hit {hit} of "
                                 f"{look} lookup tokens, launches "
                                 f"{launches}")
        out.append(dict(wall_s=wall, launches=launches, shapes=shapes,
                        hit=hit, look=look, stats=after))
        print(f"encoder reuse pass {n_pass} [{len(queries)} queries, "
              f"prefix_cache on]: wall {wall:.3f} s, "
              f"{wall / len(queries) * 1e3:.2f} ms per request; lookups hit "
              f"{hit} of {look} source tokens, cumulative hit rate "
              f"{after['prefix_hit_rate']:.4f}, LRU entries "
              f"{after['nodes']}; launches {launches}", flush=True)
    return dict(passes=out)


def check_request_tree(torch, tok, cfg, params, queries) -> dict:
    """``submit_child(parent, suffix)`` gives the tokens of a plain submit
    of ``parent + suffix``; ``cancel_subtree`` on a running parent with two
    queued children cancels all three, and every page comes back."""
    from repro_torch.kernels import launch_counts

    eng = warm_engine(tok, cfg, params, queries[0])
    torch.cuda.synchronize()
    reset_counts()
    root = eng.submit(queries[1])
    root.result()
    child = root.submit_child(".C")
    plain = eng.submit(queries[1] + ".C")
    a, b = child.result(), plain.result()
    if not (np.array_equal(a.tokens, b.tokens)
            and np.array_equal(a.lengths, b.lengths)):
        raise AssertionError(f"submit_child tokens {a.tokens[0]} != plain "
                             f"submit {b.tokens[0]}")
    eng.allocator.reclaim(eng.scheduler.state)
    free0 = eng.allocator.free_pages
    parent = eng.submit(queries[2])
    fillers = [eng.submit(q) for q in queries[3:3 + TRAINED_SLOTS - 1]]
    while str(parent.status) != "running":
        eng._pump_once()
    kids = [parent.submit_child(s) for s in (".C", ".N")]
    statuses = [str(h.status) for h in (parent, *kids)]
    if statuses != ["running", "queued", "queued"]:
        raise AssertionError(f"request tree: before the cancel {statuses}")
    n = eng.cancel_subtree(int(parent))
    statuses = [str(h.status) for h in (parent, *kids)]
    eng.serve()
    eng.allocator.reclaim(eng.scheduler.state)
    eng.allocator.check()
    free1 = eng.allocator.free_pages
    if n != 3 or statuses != ["cancelled"] * 3 or free1 != free0 or \
            any(str(f.status) != "finished" for f in fillers):
        raise AssertionError(f"cancel_subtree: {n} cancelled, {statuses}, "
                             f"free pages {free0} -> {free1}")
    launches, shapes = dict(launch_counts), verify_shapes()
    check_stream_launches(launches, "request tree")
    print(f"request tree: submit_child tokens == plain submit of the "
          f"joined query ({int(a.lengths[0])} tokens); cancel_subtree "
          f"cancelled a running parent and its 2 queued children, free "
          f"pages back at {free1}; launches {launches}", flush=True)
    return dict(launches=launches, shapes=shapes)


def serve_fleet(torch, tok, cfg, params, queries, want) -> dict:
    """Two in-process replicas on the one card (each a ``FrontDoorServer``
    over its own engine) behind a ``FleetRouter`` on loopback: 16 queries
    through the router from concurrent clients; tokens equal the trained
    streaming pass's, one accepted and one done each."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import launch_counts
    from repro_torch.serving import (FleetConfig, FleetRouter,
                                     FrontDoorServer, ServerConfig)

    srvs = [FrontDoorServer(warm_engine(tok, cfg, params, queries[0]),
                            ServerConfig(realtime=True)).start()
            for _ in range(2)]
    router = None
    try:
        router = FleetRouter([("127.0.0.1", s.port) for s in srvs],
                             FleetConfig(probe_interval_s=0.05)).start()
        time.sleep(0.2)   # one probe round
        qs = queries[:FLEET_QUERIES]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(qs)) as pool:
            futs = []
            for i, q in enumerate(qs):
                futs.append(pool.submit(wire_request, router.port, q,
                                        i % 2 == 0))
                # the router books a replica's load once its stream is
                # open: arrivals this far apart see each other's bookings
                time.sleep(FLEET_STAGGER_S)
            res = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        launches, shapes = dict(launch_counts), verify_shapes()
        stats = router.stats()
    finally:
        if router is not None:
            router.shutdown()
        for s in srvs:
            s.shutdown(drain=False)
    for i, r in enumerate(res):
        check_wire_events("fleet", i, r["events"], want[i])
    check_stream_launches(launches, "fleet")
    placed = {k: v["submitted"] for k, v in stats["replicas"].items()}
    print(f"fleet [2 replicas on one card, {len(qs)} queries through the "
          f"router, concurrent clients arriving {FLEET_STAGGER_S * 1e3:.0f} "
          f"ms apart]: wall {wall:.3f} s, "
          f"{wall / len(qs) * 1e3:.2f} ms per request; placements by "
          f"replica {placed}, reroutes {stats['reroutes']}, lost "
          f"{stats['lost']}; launches {launches}; tokens == the trained "
          f"streaming pass", flush=True)
    return dict(wall_s=wall, launches=launches, shapes=shapes,
                placed=placed)


def serve_surface(torch, trainer, tok, test_ds, trained: dict,
                  build_dir: Path) -> dict:
    """The five serving-surface phases on the trained weights, loaded back
    from their checkpoint (``tok``: the training set's tokenizer, as
    ``serve_trained`` uses). Returns each phase's launches and shapes."""
    t0 = time.perf_counter()
    queries = [test_ds.pair(i)[0] for i in range(len(test_ds))]
    want = trained["streaming_speculative"]["tokens"]
    params = check_checkpoint(torch, trainer, build_dir)
    cfg = trainer.cfg
    runs = {"front_door": serve_front_door(torch, tok, cfg, params, queries,
                                           want)}
    n = len(queries)
    print(f"front door vs direct: "
          f"{runs['front_door']['wall_s'] / n * 1e3:.2f} ms per request "
          f"over the wire, "
          f"{trained['streaming_speculative']['wall_s'] / n * 1e3:.2f} ms "
          f"through the engine alone (the trained streaming pass)",
          flush=True)
    reuse = serve_encode_reuse(torch, tok, cfg, params, queries, want)
    for i, r in enumerate(reuse["passes"]):
        runs[f"encoder_reuse_{i + 1}"] = r
    runs["request_tree"] = check_request_tree(torch, tok, cfg, params,
                                              queries)
    runs["fleet"] = serve_fleet(torch, tok, cfg, params, queries, want)
    print(f"serving surface: {time.perf_counter() - t0:.1f} s, engine "
          f"construction and warm-ups included", flush=True)
    return runs


# -- decoder-only: SmolLM-135M at full width through StreamingEngine --------
# 16 random prompts (seed 1) of 64-448 tokens, so prefills take 2-14 chunks
# of 32 with ragged last chunks; random weights (seed 0) never favour EOS
LM = dict(arch="smollm-135m", n_prompts=16, len_lo=64, len_hi=448,
          max_src=512, max_new=64, eos_id=2, prefill_chunk=32, page_size=16,
          draft_len=10, n_drafts=25, n_beams=5)
LM_PLAN = {"greedy": (8, 16), "speculative": (8, 16), "beam": (2, 2),
           "speculative_beam": (2, 2)}
LM_ONESHOT = 4          # prompts held to the one-shot path
LM_LOGIT_PROMPTS = 2    # full-width prefill logits, card vs CPU
LM_LOGIT_TOL = 1e-4     # of the largest |logit|


def lm_prompts(vocab: int, n: int, lo: int, hi: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, vocab, size=int(L)).astype(np.int32)
            for L in rng.integers(lo, hi + 1, size=n)]


def lm_engine_kw(**kw) -> dict:
    base = {k: LM[k] for k in ("max_src", "max_new", "eos_id",
                               "prefill_chunk", "page_size", "draft_len",
                               "n_drafts", "n_beams")}
    base.update(kw)
    return base


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)


def run_lm(torch, cfg, params, prompts, plan: dict, *, paged: bool,
           device="cuda", **kw) -> dict:
    """Each mode through a decoder-only StreamingEngine (``plan``: mode ->
    (slots, prompts)), every prompt submitted at once, every stream
    subscribed; launch counts set to 0 just before each mode and read just
    after. Returns per mode the tokens, log-probs, calls, wall, scheduler
    iterations, chunks written, pages, time to the first delta per
    request (greedy family; beams deliver at the end) and counts."""
    from repro_torch.kernels import launch_counts
    from repro_torch.serving import EngineConfig, StreamingEngine

    out = {}
    for mode, (n_slots, n_p) in plan.items():
        eng = StreamingEngine(params, cfg, None, EngineConfig(
            mode=mode, n_slots=n_slots, paged=paged, **lm_engine_kw(**kw)),
            device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        handles = [eng.submit(p) for p in prompts[:n_p]]
        sinks = {int(h): eng.subscribe(int(h)) for h in handles}
        first: dict[int, float] = {}
        while eng._pump_once():
            now = time.perf_counter() - t0
            for rid, st in sinks.items():
                if rid not in first and (st["buf"] or st["done"]):
                    first[rid] = now
        wall = time.perf_counter() - t0
        launches, shapes = dict(launch_counts), verify_shapes()
        results = [h.result() for h in handles]
        for r in results:
            if not (np.all(np.isfinite(r.logprobs))
                    and r.tokens.shape[1] == eng.ecfg.max_new
                    and int(r.lengths[0]) >= 1):
                raise AssertionError(f"decoder-only {mode}: malformed "
                                     f"result {r}")
        out[mode] = dict(
            tokens=[np.asarray(r.tokens) for r in results],
            logprobs=[np.asarray(r.logprobs, np.float64) for r in results],
            n_calls=[r.n_calls for r in results],
            accepted=sum(r.accepted for r in results)
            / max(1, sum(int(r.lengths[0]) for r in results)),
            wall_s=wall, steps=eng.loop_stats()["n_iterations"],
            chunks=eng.prefill_chunks_written,
            first_s=[first.get(int(h), wall) for h in handles],
            footprint=eng.cache_footprint(), launches=launches,
            shapes=shapes, preemptions=eng.scheduler.n_preemptions)
        if paged:
            eng.allocator.check()
    return out


def same_lm_runs(a: dict, b: dict, label: str, *, calls: bool = True,
                 tol: float = 1e-4) -> None:
    for mode in a:
        x, y = a[mode], b[mode]
        for i, (s, t) in enumerate(zip(x["tokens"], y["tokens"])):
            if not np.array_equal(s, t):
                raise AssertionError(f"{label} {mode} prompt {i}: tokens "
                                     f"differ")
        if calls and x["n_calls"] != y["n_calls"]:
            raise AssertionError(f"{label} {mode}: calls {x['n_calls']} != "
                                 f"{y['n_calls']}")
        for i, (s, t) in enumerate(zip(x["logprobs"], y["logprobs"])):
            if mode.endswith("beam") and not np.allclose(s, t, atol=tol,
                                                         rtol=tol):
                raise AssertionError(f"{label} {mode} prompt {i}: log-probs "
                                     f"{s} != {t}")


def lm_one_shot(torch, cfg, params, prompt, mode: str, device="cuda",
                **kw):
    """The port's one-shot path: ``transformer.prefill`` of the prompt
    minus its last token into a 1-row cache (written in place, recurrent
    state too), then the core greedy or speculative decode. ``kw``
    overrides ``LM``'s max_new, draft_len and n_drafts."""
    from repro_torch.core import (greedy_decode, prompt_lookup_drafts,
                                  speculative_greedy_decode,
                                  transformer_handle)
    from repro_torch.models import transformer as tr

    c = {k: kw.get(k, LM[k]) for k in ("max_new", "draft_len", "n_drafts")}
    P, DL = len(prompt), c["draft_len"]
    handle = transformer_handle(params, cfg)
    cache = tr.init_cache(cfg, 1, P + c["max_new"] + DL + 4, device=device)
    tr.prefill(params, cfg, cache,
               torch.from_numpy(prompt[None, :-1]).to(device),
               logits_mode="last")
    last = torch.tensor([int(prompt[-1])], dtype=torch.int32, device=device)
    pos = torch.tensor([P - 1], dtype=torch.int32, device=device)
    if mode == "greedy":
        r = greedy_decode(handle, cache, last, pos, max_new=c["max_new"],
                          eos_id=LM["eos_id"])
    else:
        d, m = prompt_lookup_drafts(prompt, DL, c["n_drafts"])
        r = speculative_greedy_decode(
            handle, cache, last, pos, torch.from_numpy(d[None]).to(device),
            torch.from_numpy(m[None]).to(device), max_new=c["max_new"],
            eos_id=LM["eos_id"])
    return r.tokens[0].cpu().numpy()


def serve_decoder(torch, params) -> dict:
    """The decoder-only phase: SmolLM-135M at full width (30 layers,
    d_model 576, 9 heads over 3 KV heads, hd 64, d_ff 1536, vocab 49,152,
    tied embeddings), random weights, served through the port's
    StreamingEngine with chunked ragged prefill and prompt-lookup drafts.
    Asserts: speculative == greedy and SBS == beam (paged), the dense
    speculative pass == the paged one, streaming == the one-shot path on
    ``LM_ONESHOT`` prompts, card == CPU in every mode on the reduced
    config, and the full-width prefill's last logits on the card == the
    CPU's within ``LM_LOGIT_TOL`` of the largest |logit|. Returns each
    counted run's launches and draft_verify shapes."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr

    cfg = get_config(LM["arch"])
    t_phase = time.perf_counter()
    prompts = lm_prompts(cfg.vocab_size, LM["n_prompts"], LM["len_lo"],
                         LM["len_hi"])
    run_lm(torch, cfg, params, prompts[:1],                     # warm-up
           {"speculative": (8, 1)}, paged=True, max_new=4)
    paged = run_lm(torch, cfg, params, prompts, LM_PLAN, paged=True)
    dense = run_lm(torch, cfg, params, prompts,
                   {"speculative": LM_PLAN["speculative"]}, paged=False)
    for mode, ref in (("speculative", "greedy"),
                      ("speculative_beam", "beam")):
        same_lm_runs({mode: paged[mode]}, {mode: paged[ref]},
                     f"decoder-only {mode} vs {ref}", calls=False)
    same_lm_runs(dense, {"speculative": paged["speculative"]},
                 "decoder-only dense vs paged")
    for label, runs, read in (("paged", paged, "paged_decode_gqa"),
                              ("dense", dense, "decode_gqa")):
        for mode, r in runs.items():
            other = ("decode_gqa" if read == "paged_decode_gqa"
                     else "paged_decode_gqa")
            lc = r["launches"]
            if lc[read] == 0 or lc[other] != 0 or (
                    mode in ("greedy", "speculative")
                    and lc["draft_verify"] == 0):
                raise AssertionError(f"decoder-only {label} {mode}: "
                                     f"launches {lc}")
            fp = r["footprint"]
            pages = (f"peak pages {fp['peak_pages']} of {fp['n_pages'] - 1}"
                     if label == "paged" else "dense rows")
            n_p = len(r["tokens"])
            fs = r["first_s"]
            print(f"decoder-only [smollm-135m full width, {label} {mode}] "
                  f"{LM_PLAN[mode][0]} slots, {n_p} prompts: wall "
                  f"{r['wall_s']:.3f} s, {r['wall_s'] / n_p * 1e3:.2f} ms "
                  f"per request; scheduler iterations {r['steps']}, prefill "
                  f"chunks written {r['chunks']}, {pages}, preemptions "
                  f"{r['preemptions']}; time to first delta p50 "
                  f"{percentile(fs, 50) * 1e3:.2f} ms, p95 "
                  f"{percentile(fs, 95) * 1e3:.2f} ms; acceptance "
                  f"{r['accepted']:.4f} (random weights: means nothing); "
                  f"launches {lc}", flush=True)
    print("decoder-only check: speculative == greedy, SBS == beam, dense "
          "== paged", flush=True)
    # the one-shot path on a few prompts
    t0 = time.perf_counter()
    for i, p in enumerate(prompts[:LM_ONESHOT]):
        for mode in ("greedy", "speculative"):
            want = paged[mode]["tokens"][i][0]
            got = lm_one_shot(torch, cfg, params, p, mode)
            if not np.array_equal(got, want):
                raise AssertionError(f"decoder-only one-shot {mode} prompt "
                                     f"{i}: {got} != streaming {want}")
    print(f"decoder-only check: streaming == one-shot prefill + decode on "
          f"{LM_ONESHOT} prompts, greedy and speculative "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    # full-width prefill logits: the card against the CPU
    cpu_params = tree_to(params, "cpu")
    short = lm_prompts(cfg.vocab_size, LM_LOGIT_PROMPTS, 64, 128, seed=2)
    for i, p in enumerate(short):
        logits = {}
        for dev, prm in (("cuda", params), ("cpu", cpu_params)):
            cache = tr.init_cache(cfg, 1, len(p), device=dev)
            lg, _ = tr.prefill(prm, cfg, cache,
                               torch.from_numpy(p[None]).to(dev),
                               logits_mode="last")
            logits[dev] = lg.cpu()
        scale = logits["cpu"].abs().max().item()
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        if not err <= LM_LOGIT_TOL * scale:
            raise AssertionError(f"decoder-only prefill logits, prompt {i} "
                                 f"({len(p)} tokens): card vs CPU max err "
                                 f"{err} > {LM_LOGIT_TOL} x {scale}")
        print(f"decoder-only check: full-width prefill of {len(p)} tokens, "
              f"last logits card vs CPU max err {err:.3e} (largest |logit| "
              f"{scale:.3f})", flush=True)
    del cpu_params
    # the reduced config on the card and on the CPU, every mode
    rcfg = get_config(LM["arch"], reduced=True)
    rparams = tr.init(torch.Generator().manual_seed(SEED), rcfg,
                      device="cpu")
    rprompts = lm_prompts(rcfg.vocab_size, 4, 16, 120, seed=3)
    rplan = {"greedy": (2, 4), "speculative": (2, 4), "beam": (2, 2),
             "speculative_beam": (2, 2)}
    rkw = dict(max_src=128, max_new=24)
    for paged_ in (True, False):
        card = run_lm(torch, rcfg, rparams, rprompts, rplan, paged=paged_,
                      **rkw)
        cpu = run_lm(torch, rcfg, rparams, rprompts, rplan, paged=paged_,
                     device="cpu", **rkw)
        same_lm_runs(card, cpu, f"decoder-only reduced card vs CPU "
                                f"({'paged' if paged_ else 'dense'})")
    print("decoder-only check: smollm-135m reduced, card == CPU in all "
          "four modes, paged and dense", flush=True)
    print(f"decoder-only phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {f"{k} {m}": r for k, runs in (("paged", paged), ("dense", dense))
            for m, r in runs.items()}


# -- prefix sharing: the radix page cache at SmolLM-135M's full width ------
# a 384-token prefix (seed 4) served alone, then 16 children that extend it
# by 16-96 tokens each (seed 5), at 8 slots, greedy and speculative, cold
# (prefix_cache=False) and shared; a pool too small to retain every prefix;
# a request tree; two replicas behind the fleet router
# pool of the pressure pass: three slots' worst case (35 pages a greedy
# slot at max_src 512) and the trash page, short of 8 residents plus the
# retained prefixes
PREFIX = dict(prefix_len=384, n_children=16, child_lo=16, child_hi=96,
              slots=8, max_new=32, fleet_children=8,
              pressure_pages=1 + 3 * 35)


def prefix_prompts(vocab: int, seed_prefix: int, seed_children: int,
                   n: int):
    """A shared prefix and ``n`` child suffixes of 16-96 tokens."""
    prefix = np.random.default_rng(seed_prefix).integers(
        4, vocab, PREFIX["prefix_len"]).astype(np.int32)
    rng = np.random.default_rng(seed_children)
    suffixes = [rng.integers(4, vocab, int(L)).astype(np.int32)
                for L in rng.integers(PREFIX["child_lo"],
                                      PREFIX["child_hi"] + 1, n)]
    return prefix, suffixes


def prefix_engine(torch, cfg, params, mode: str, share: bool, **kw):
    from repro_torch.serving import EngineConfig, StreamingEngine

    return StreamingEngine(params, cfg, None, EngineConfig(
        mode=mode, n_slots=PREFIX["slots"], paged=True, prefix_cache=share,
        **lm_engine_kw(max_new=PREFIX["max_new"], **kw)))


def run_children(torch, eng, prefix, suffixes) -> dict:
    """Serve ``prefix`` alone (its pages enter the radix tree when sharing
    is on), then its children, every one submitted at once with its stream
    subscribed; launch counts set to 0 just before the children and read
    just after. Returns the children's tokens, wall, time to the first
    delta, chunks written, stats, pages and counts."""
    from repro_torch.kernels import launch_counts

    parent = eng.submit(prefix)
    parent.result()
    chunks0 = eng.prefill_chunks_written
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    handles = [parent.submit_child(s) for s in suffixes]
    sinks = {int(h): eng.subscribe(int(h)) for h in handles}
    first: dict[int, float] = {}
    while eng._pump_once():
        now = time.perf_counter() - t0
        for rid, st in sinks.items():
            if rid not in first and (st["buf"] or st["done"]):
                first[rid] = now
    wall = time.perf_counter() - t0
    launches, shapes = dict(launch_counts), verify_shapes()
    results = [h.result() for h in handles]
    for r in results:
        if not (r.tokens.shape[1] == PREFIX["max_new"]
                and int(r.lengths[0]) >= 1):
            raise AssertionError(f"prefix sharing: malformed result {r}")
    eng.allocator.check()
    if eng.radix is not None:
        eng.radix.check()
    return dict(tokens=[np.asarray(r.tokens) for r in results],
                wall_s=wall, first_s=[first.get(int(h), wall)
                                      for h in handles],
                chunks=eng.prefill_chunks_written - chunks0,
                stats=eng.prefix_stats(), footprint=eng.cache_footprint(),
                preemptions=eng.scheduler.n_preemptions,
                steps=eng.loop_stats()["n_iterations"], launches=launches,
                shapes=shapes)


def print_children(label: str, r: dict) -> None:
    st, fp, n = r["stats"], r["footprint"], len(r["tokens"])
    fs = r["first_s"]
    print(f"prefix sharing [smollm-135m full width, {label}] "
          f"{PREFIX['slots']} slots, {n} children of a "
          f"{PREFIX['prefix_len']}-token prefix: wall {r['wall_s']:.3f} s, "
          f"{r['wall_s'] / n * 1e3:.2f} ms per request; time to first delta "
          f"p50 {percentile(fs, 50) * 1e3:.2f} ms, p95 "
          f"{percentile(fs, 95) * 1e3:.2f} ms; prefill chunks written "
          f"{r['chunks']} ({r['chunks'] / n:.2f} a child); prefix_stats "
          f"lookups {st['lookups']}, hit tokens {st['hit_tokens']} of "
          f"{st['lookup_tokens']}, inserted {st['inserted']}, evicted "
          f"{st['evicted']}, nodes {st['nodes']}; peak pages "
          f"{fp['peak_pages']} of {fp['n_pages'] - 1} (retained "
          f"{fp['retained_pages']}); preemptions {r['preemptions']}; "
          f"launches {r['launches']}", flush=True)


def check_prefix_launches(label: str, mode: str, lc: dict) -> None:
    if lc["paged_decode_gqa"] == 0 or lc["decode_gqa"] != 0 or (
            lc["draft_verify"] == 0):
        raise AssertionError(f"prefix sharing {label} {mode}: launches {lc}")


def prefix_tree(torch, cfg, params, prefix, suffixes) -> dict:
    """``submit_child`` / ``cancel_subtree`` on a running parent whose two
    children wait in the queue behind 7 fillers: all three are cancelled,
    the fillers finish, and after ``clear_prefix_cache()`` every page of
    the pool is free again."""
    from repro_torch.core.session import device_free_pages
    from repro_torch.kernels import launch_counts

    eng = prefix_engine(torch, cfg, params, "greedy", True)
    torch.cuda.synchronize()
    reset_counts()
    root = eng.submit(prefix)
    root.result()
    parent = root.submit_child(suffixes[0])
    fillers = [root.submit_child(s)
               for s in suffixes[1:PREFIX["slots"]]]
    while str(parent.status) != "running":
        eng._pump_once()
    kids = [parent.submit_child(s[:8]) for s in suffixes[-2:]]
    statuses = [str(h.status) for h in (parent, *kids)]
    if statuses != ["running", "queued", "queued"]:
        raise AssertionError(f"prefix tree: before the cancel {statuses}")
    n = eng.cancel_subtree(int(parent))
    statuses = [str(h.status) for h in (parent, *kids)]
    eng.serve()
    launches, shapes = dict(launch_counts), verify_shapes()
    nodes = len(eng.radix)
    dropped = eng.clear_prefix_cache()
    n_pages, _ = eng._paged_geometry()
    free = int(device_free_pages(eng.scheduler.state.cache, n_pages))
    eng.allocator.check()
    if n != 3 or statuses != ["cancelled"] * 3 or free != n_pages - 1 or \
            any(str(f.status) != "finished" for f in fillers) or \
            len(eng.radix) != 0:
        raise AssertionError(f"prefix tree: {n} cancelled, {statuses}, "
                             f"free pages {free} of {n_pages - 1}")
    print(f"prefix tree: cancel_subtree cancelled a running child and its 2 "
          f"queued children; {nodes} radix nodes, clear_prefix_cache "
          f"dropped {dropped}; every page free ({free}); launches "
          f"{launches}", flush=True)
    return dict(launches=launches, shapes=shapes)


def prefix_fleet(torch, cfg, params, suffixes) -> dict:
    """Two in-process decoder-only replicas (``FrontDoorServer`` over a
    ``prefix_cache=True`` engine each, as ``serving.fleet.replica
    --model arch --arch smollm-135m --paged --prefix-cache`` builds them)
    behind a ``FleetRouter``: two prefixes sent together, then 8 children
    of each from concurrent clients. Tokens equal one direct engine's;
    prints the placements by reason and each replica's hit rate."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import launch_counts
    from repro_torch.serving import (FleetConfig, FleetRouter,
                                     FrontDoorServer, ServerConfig)

    k = PREFIX["fleet_children"]
    prefixes = [prefix_prompts(cfg.vocab_size, seed, seed, 0)[0]
                for seed in (4, 6)]
    roots = [p.tolist() for p in prefixes]
    queries = [np.concatenate([prefixes[i % 2], s]).tolist()
               for i, s in enumerate(suffixes[:2 * k])]
    direct = prefix_engine(torch, cfg, params, "greedy", True)
    handles = [direct.submit(np.asarray(q, np.int32))
               for q in roots + queries]
    want = {}
    for q, h in zip(roots + queries, handles):
        r = h.result()
        want[tuple(q)] = r.tokens[0][:int(r.lengths[0])].tolist()

    def replica():
        eng = prefix_engine(torch, cfg, params, "greedy", True)
        eng.submit(prefixes[0][:40])
        eng.serve()
        eng.reset()
        return FrontDoorServer(eng, ServerConfig(realtime=True)).start()

    srvs = [replica() for _ in range(2)]
    router = None
    try:
        router = FleetRouter([("127.0.0.1", s.port) for s in srvs],
                             FleetConfig(probe_interval_s=0.05)).start()
        time.sleep(0.2)   # one probe round
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(queries)) as pool:
            futs = []
            for q in roots:   # together, so least-loaded splits them
                futs.append(pool.submit(wire_request, router.port, q, True))
                time.sleep(FLEET_STAGGER_S)
            done = [f.result() for f in futs]
            futs = []
            for i, q in enumerate(queries):
                futs.append(pool.submit(wire_request, router.port, q,
                                        i % 2 == 0))
                time.sleep(FLEET_STAGGER_S)
            done += [f.result() for f in futs]
        wall = time.perf_counter() - t0
        launches, shapes = dict(launch_counts), verify_shapes()
        stats = router.stats(fresh=True)
    finally:
        if router is not None:
            router.shutdown()
        for s in srvs:
            s.shutdown(drain=False)
    for i, (q, r) in enumerate(zip(roots + queries, done)):
        check_wire_events("prefix fleet", i, r["events"], want[tuple(q)])
    check_prefix_launches("fleet", "greedy", launches)
    placed = {i: v["submitted"] for i, v in stats["replicas"].items()}
    hit = {i: round(v["prefix_hit_rate"], 4)
           for i, v in stats["replicas"].items()}
    n_aff = stats["affinity_hits"]
    print(f"prefix fleet [2 replicas on one card, 2 prefixes then "
          f"{len(queries)} children through the router]: wall {wall:.3f} s, "
          f"{wall / len(done) * 1e3:.2f} ms per request; placements "
          f"{stats['placements']}: {n_aff} by prefix affinity, "
          f"{stats['placements'] - n_aff} least-loaded; by replica {placed}; "
          f"replica radix hit rates {hit}; reroutes {stats['reroutes']}; "
          f"launches {launches}; tokens == the direct engine's", flush=True)
    return dict(wall_s=wall, launches=launches, shapes=shapes)


def serve_prefix_sharing(torch, params) -> dict:
    """The prefix-sharing phase: SmolLM-135M at full width, random weights,
    the radix page cache of the paged decoder-only StreamingEngine.
    Asserts: shared tokens == cold tokens in greedy and speculative, and
    under pool pressure (with radix evictions); paged_decode_gqa and
    draft_verify launch and decode_gqa does not; the request tree frees
    every page; the fleet's tokens == the direct engine's. Returns each
    counted run's launches and draft_verify shapes."""
    from repro_torch.configs import get_config

    cfg = get_config(LM["arch"])
    t_phase = time.perf_counter()
    prefix, suffixes = prefix_prompts(cfg.vocab_size, 4, 5,
                                      PREFIX["n_children"])
    warm = prefix_engine(torch, cfg, params, "speculative", True)
    warm.submit(prefix[:40])
    warm.serve()
    del warm
    out = {}
    for mode in ("greedy", "speculative"):
        runs = {}
        for label, share in (("cold", False), ("shared", True)):
            eng = prefix_engine(torch, cfg, params, mode, share)
            runs[label] = run_children(torch, eng, prefix, suffixes)
            check_prefix_launches(label, mode, runs[label]["launches"])
            print_children(f"{label} {mode}", runs[label])
            out[f"{label} {mode}"] = runs[label]
        for i, (a, b) in enumerate(zip(runs["shared"]["tokens"],
                                       runs["cold"]["tokens"])):
            if not np.array_equal(a, b):
                raise AssertionError(f"prefix sharing {mode} child {i}: "
                                     f"shared tokens differ from cold")
        st = runs["shared"]["stats"]
        if st["hit_tokens"] <= 0 or runs["shared"]["chunks"] >= \
                runs["cold"]["chunks"]:
            raise AssertionError(f"prefix sharing {mode}: no reuse {st}")
        print(f"prefix sharing check: {mode} shared tokens == cold tokens",
              flush=True)
    # pool pressure: room for a few slots' worst case, so retained
    # prefixes must go before residents are preempted
    eng = prefix_engine(torch, cfg, params, "greedy", True,
                        n_pages=PREFIX["pressure_pages"])
    r = run_children(torch, eng, prefix, suffixes)
    check_prefix_launches("pressure", "greedy", r["launches"])
    print_children(f"shared greedy, pool of {PREFIX['pressure_pages']} "
                   f"pages", r)
    same = all(np.array_equal(a, b) for a, b in
               zip(r["tokens"], out["cold greedy"]["tokens"]))
    if r["stats"]["evicted"] <= 0 or not same:
        raise AssertionError(f"prefix sharing under pool pressure: evicted "
                             f"{r['stats']['evicted']}, tokens == cold "
                             f"{same}")
    out["pressure greedy"] = r
    print("prefix sharing check: pool pressure evicted radix nodes, every "
          "child finished with the cold tokens", flush=True)
    out["tree"] = prefix_tree(torch, cfg, params, prefix, suffixes)
    out["fleet"] = prefix_fleet(torch, cfg, params, suffixes)
    print(f"prefix sharing phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# -- multi-draft: every draft verified in one row per sequence --------------
MULTIDRAFT = dict(n_prompts=4, max_new=32)


def serve_multidraft(torch, params) -> dict:
    """The multi-draft phase: SmolLM-135M at full width, random weights, on
    4 of the decoder-only phase's prompts at B 1 (one at a time) and at B 4
    (ragged, one batch), on a dense cache: ``multidraft_speculative_decode``
    (one row of T = 1 + 25 x 10 = 251 a sequence) against the
    expanded-batch speculative decode (25 rows of T 11) and greedy, with
    prompt-lookup drafts and with drafts cut from the greedy output (so
    drafts are accepted whole). Asserts multi-draft == expanded == greedy
    tokens and equal call counts, and acceptance on the cut drafts; prints
    the wall per query, the calls and one verify call's device time in
    each form."""
    from repro_torch.configs import get_config
    from repro_torch.core import (greedy_decode,
                                  multidraft_speculative_decode,
                                  prompt_lookup_drafts,
                                  speculative_greedy_decode,
                                  transformer_handle)
    from repro_torch.core.multidraft import build_local_mask
    from repro_torch.core.tree_batch import expand_batch
    from repro_torch.kernels import launch_counts
    from repro_torch.models import transformer as tr

    cfg = get_config(LM["arch"])
    t_phase = time.perf_counter()
    handle = transformer_handle(params, cfg)
    prompts = lm_prompts(cfg.vocab_size, LM["n_prompts"], LM["len_lo"],
                         LM["len_hi"])[:MULTIDRAFT["n_prompts"]]
    DL, N_d, max_new = LM["draft_len"], LM["n_drafts"], MULTIDRAFT["max_new"]

    def inputs(idx, drafts=None):
        """A dense cache with prompts ``idx`` minus their last token
        prefilled (ragged), and the decode's start tokens, positions and
        drafts: prompt-lookup drafts, or rows ``idx`` of ``drafts``."""
        batch = [prompts[i] for i in idx]
        P = np.array([len(p) for p in batch])
        toks = np.zeros((len(batch), P.max() - 1), np.int32)
        for b, p in enumerate(batch):
            toks[b, :len(p) - 1] = p[:-1]
        cache = tr.init_cache(cfg, len(batch), int(P.max()) + max_new + DL
                              + 4, device="cuda")
        tr.prefill(params, cfg, cache, torch.from_numpy(toks).cuda(),
                   lengths=torch.from_numpy(P - 1).cuda())
        if drafts is None:
            d, m = map(np.stack, zip(*(prompt_lookup_drafts(p, DL, N_d)
                                       for p in batch)))
        else:
            d, m = drafts[0][idx], drafts[1][idx]
        return (cache, torch.tensor([int(p[-1]) for p in batch],
                                    dtype=torch.int32, device="cuda"),
                torch.from_numpy((P - 1).astype(np.int32)).cuda(),
                torch.from_numpy(d).cuda(), torch.from_numpy(m).cuda())

    def greedy_drafts(tokens):
        """Drafts cut from the greedy output: draft j is the DL tokens at
        j·(DL + 1), where call j starts once every earlier call accepted a
        whole draft, so the winner's DL + 1 tokens are committed each call.
        Draft 2 of prompt 1 is masked off (one call of one token there)."""
        gt = np.concatenate([tokens, np.zeros((len(tokens), N_d * (DL + 1)),
                                              np.int32)], 1)
        d = np.stack([[gt[b, j * (DL + 1):j * (DL + 1) + DL]
                       for j in range(N_d)] for b in range(len(tokens))])
        m = np.ones((len(tokens), N_d), bool)
        m[1, 2] = False
        return d.astype(np.int32), m

    def run(fn, batches, drafts=None) -> dict:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        runs = [fn(*inputs(b, drafts)) for b in batches]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, shapes = dict(launch_counts), verify_shapes()
        tokens = np.concatenate([r.tokens.cpu().numpy() for r in runs])
        acc = [int(a) for r in runs if hasattr(r, "accepted_tokens")
               for a in r.accepted_tokens.cpu()]
        return dict(tokens=tokens, calls=[r.n_calls for r in runs],
                    wall_s=wall, accepted=acc, launches=launches,
                    shapes=shapes)

    forms = {
        "multidraft": lambda c, last, pos, d, m: multidraft_speculative_decode(
            params, cfg, c, last, pos, d, m, max_new=max_new,
            eos_id=LM["eos_id"]),
        "expanded": lambda c, last, pos, d, m: speculative_greedy_decode(
            handle, c, last, pos, d, m, max_new=max_new,
            eos_id=LM["eos_id"]),
        "greedy": lambda c, last, pos, d, m: greedy_decode(
            handle, c, last, pos, max_new=max_new, eos_id=LM["eos_id"])}
    forms["multidraft"](*inputs([0]))                           # warm-up
    out = {}
    n_q = len(prompts)
    for label, batches in (("B 1", [[i] for i in range(n_q)]),
                           ("B 4", [list(range(n_q))])):
        res = {form: run(fn, batches) for form, fn in forms.items()}
        # drafts cut from the greedy output: whole drafts accepted, so the
        # winner pick, the multi-token K/V commit and the bookkeeping past
        # one token run on the card
        cut = greedy_drafts(res["greedy"]["tokens"])
        for form in ("multidraft", "expanded"):
            res[f"{form} greedy-drafts"] = run(forms[form], batches, cut)
        for form, r in res.items():
            out[f"multidraft {label} {form}"] = r
        for md, ex in (("multidraft", "expanded"),
                       ("multidraft greedy-drafts", "expanded greedy-drafts")):
            for form in (ex, "greedy"):
                if not np.array_equal(res[md]["tokens"], res[form]["tokens"]):
                    raise AssertionError(f"multi-draft {label}: {md} tokens "
                                         f"differ from {form}")
            if res[md]["calls"] != res[ex]["calls"]:
                raise AssertionError(f"multi-draft {label}: {md} calls "
                                     f"{res[md]['calls']} != {ex} "
                                     f"{res[ex]['calls']}")
        cut_md = res["multidraft greedy-drafts"]
        if min(cut_md["accepted"]) <= 0 \
                or sum(cut_md["calls"]) >= sum(res["greedy"]["calls"]):
            raise AssertionError(f"multi-draft {label}: drafts cut from the "
                                 f"greedy output must be accepted: accepted "
                                 f"{cut_md['accepted']}, calls "
                                 f"{cut_md['calls']} against greedy's "
                                 f"{res['greedy']['calls']}")
        for form, r in res.items():
            note = ("drafts cut from the greedy output"
                    if form.endswith("greedy-drafts") else
                    "random weights: acceptance near 0 means nothing")
            print(f"multi-draft [smollm-135m full width, {label}, {form}] "
                  f"{n_q} prompts, DL {DL}, {N_d} drafts, max_new "
                  f"{max_new}: wall {r['wall_s']:.3f} s, "
                  f"{r['wall_s'] / n_q * 1e3:.2f} ms per query (the "
                  f"one-shot prefill included); calls "
                  f"{r['calls']}; accepted draft tokens {r['accepted']} "
                  f"({note}); launches {r['launches']}", flush=True)
    print("multi-draft check: multi-draft == expanded speculative == greedy "
          "tokens, calls == expanded, at B 1 and B 4, with prompt-lookup "
          "drafts and with drafts cut from the greedy output (every "
          "sequence accepted draft tokens, fewer calls than greedy)",
          flush=True)
    # one verify call's device time in each form, B 1, the first prompt
    cache, last, pos, d, m = inputs([0])
    T = 1 + N_d * DL
    toks = torch.cat([last[:, None], d.reshape(1, -1)], dim=1)
    rel = torch.arange(DL, dtype=torch.int32, device="cuda")
    positions = torch.cat([pos[:, None], (pos[:, None] + 1 + rel[None])
                           .repeat(1, N_d)], dim=1)
    mask = torch.from_numpy(build_local_mask(N_d, DL)).cuda()
    md_ms = device_busy_ms(torch, lambda: tr.multidraft_verify_step(
        params, cfg, cache, toks, positions, mask))
    wide = expand_batch(cache, N_d)
    etoks = torch.cat([last.repeat(N_d)[:, None], d[0]], dim=1)
    epos = (pos.repeat(N_d)[:, None]
            + torch.arange(DL + 1, dtype=torch.int32, device="cuda")[None])
    ex_ms = device_busy_ms(torch, lambda: tr.decode_step(params, cfg, wide,
                                                         etoks, epos))
    print(f"multi-draft verify call, device time (kernel times summed by "
          f"torch.profiler, mean of 5 calls): one row of T {T} {md_ms:.3f} "
          f"ms (joint softmax in plain torch einsums: no kernel); {N_d} rows "
          f"of T {DL + 1} {ex_ms:.3f} ms (decode_gqa; draft_verify "
          f"excluded)", flush=True)
    out["verify_ms"] = dict(multidraft=md_ms, expanded=ex_ms)
    print(f"multi-draft phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# -- the MoE and recurrent families ------------------------------------------
# Phi-3.5-MoE at its published widths (d_model 4096, 32 heads over 8 KV
# heads, hd 128, 16 experts top-2 of d_ff 6400, vocab 32,064), 4 of its 32
# layers, at the dropless capacity factor E / top_k = 8.0; 16 prompts of
# 64-448 tokens (seed 1), max_src 512, max_new 32, chunks of 32, page 16,
# DL 10 and 5 drafts; one MoE layer held card vs CPU at the default 1.25
MOE = dict(arch="phi3.5-moe-42b-a6.6b", n_layers=4, capacity_factor=8.0,
           n_prompts=16, len_lo=64, len_hi=448, max_new=32, n_drafts=5,
           check_capacity_factor=1.25, check_tol=1e-4)
MOE_PLAN = {"greedy": (8, 16), "speculative": (8, 16), "beam": (2, 2),
            "speculative_beam": (2, 2)}
# RWKV6-1.6B whole (24 layers, d_model 2048, 32 WKV heads of 64, d_ff
# 7168, vocab 65,536) on the dense cache: 4 prompts of 64-256 tokens (seed
# 6), one wave of 4 slots (cut from 8 prompts to make room in the script's
# time for the mesh phase), max_new 32, DL 10, 25 drafts
RWKV = dict(arch="rwkv6-1.6b", n_prompts=4, len_lo=64, len_hi=256, seed=6,
            max_new=32, n_drafts=25)
RWKV_PLAN = {"greedy": (4, 4), "speculative": (4, 4)}
REDUCED_FAMILIES = ("jamba-v0.1-52b", "llama4-maverick-400b-a17b")


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.nbytes


def check_lm_launches(label: str, runs: dict, read: str | None) -> None:
    """``read``: the attention kernel every pass must launch (None for an
    attention-free model, which launches neither read); the other read
    must not launch; greedy-family passes must launch draft_verify."""
    for mode, r in runs.items():
        lc = r["launches"]
        reads = ("decode_gqa", "paged_decode_gqa")
        ok = all((lc[k] > 0) == (k == read) for k in reads)
        if not ok or (mode in ("greedy", "speculative")
                      and lc["draft_verify"] == 0):
            raise AssertionError(f"{label} {mode}: launches {lc}")


def print_lm_runs(tag: str, label: str, runs: dict, plan: dict) -> None:
    for mode, r in runs.items():
        fp, n_p, fs = r["footprint"], len(r["tokens"]), r["first_s"]
        pages = (f"peak pages {fp['peak_pages']} of {fp['n_pages'] - 1}"
                 if label == "paged" else "dense rows")
        print(f"{tag} [{label} {mode}] {plan[mode][0]} slots, {n_p} prompts: "
              f"wall {r['wall_s']:.3f} s, {r['wall_s'] / n_p * 1e3:.2f} ms "
              f"per request; scheduler iterations {r['steps']}, prefill "
              f"chunks written {r['chunks']}, {pages}; time to first delta "
              f"p50 {percentile(fs, 50) * 1e3:.2f} ms, p95 "
              f"{percentile(fs, 95) * 1e3:.2f} ms; calls {sum(r['n_calls'])}"
              f"; launches {r['launches']}", flush=True)


def one_shot_check(torch, cfg, params, prompt, runs: dict, tag: str,
                   **kw) -> None:
    """Streaming == the one-shot prefill + decode, greedy and speculative,
    on ``prompt`` (the passes' first)."""
    for mode in ("greedy", "speculative"):
        got = lm_one_shot(torch, cfg, params, prompt, mode, **kw)
        if not np.array_equal(got, runs[mode]["tokens"][0][0]):
            raise AssertionError(f"{tag} one-shot {mode}: {got} != "
                                 f"streaming {runs[mode]['tokens'][0][0]}")


def serve_moe(torch) -> dict:
    """The MoE phase: Phi-3.5-MoE at full width (``MOE``; weights drawn on
    the card from a CUDA generator seeded 0, no host copy), through the
    decoder-only StreamingEngine. Paged greedy / speculative at 8 slots x
    16 prompts and beam / SBS at 2 x 2 (5 beams), the speculative pass
    again on the dense cache. Asserts speculative == greedy, SBS == beam,
    dense == paged and streaming == one-shot on the first prompt; then one
    MoE layer at capacity factor 1.25 on the first verify pass's layer-0
    input, card against CPU: equal experts and keep mask, outputs within
    ``check_tol`` x max(1, the largest |output|)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tr

    t_phase = time.perf_counter()
    full = get_config(MOE["arch"])
    cfg = dataclasses.replace(
        full, n_layers=MOE["n_layers"], moe=dataclasses.replace(
            full.moe, capacity_factor=MOE["capacity_factor"]))
    t0 = time.perf_counter()
    params = tr.init(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                     device="cuda")
    torch.cuda.synchronize()
    print(f"moe: {cfg.name}, {cfg.n_layers} of {full.n_layers} layers, "
          f"capacity factor {cfg.moe.capacity_factor} (E / top_k: "
          f"dropless); weights {tree_bytes(params) / 1e9:.2f} GB fp32 drawn "
          f"on the card in {time.perf_counter() - t0:.2f} s", flush=True)
    prompts = lm_prompts(cfg.vocab_size, MOE["n_prompts"], MOE["len_lo"],
                         MOE["len_hi"])
    kw = dict(max_new=MOE["max_new"], n_drafts=MOE["n_drafts"])
    run_lm(torch, cfg, params, prompts[:1], {"speculative": (8, 1)},
           paged=True, max_new=4, n_drafts=MOE["n_drafts"])    # warm-up
    # the first verify pass's layer-0 MoE input, for the capacity check
    n_rows = MOE_PLAN["speculative"][0] * MOE["n_drafts"]
    seen: dict = {}
    moe_ffn = moe_mod.moe_ffn

    def capture(p, c, x):
        if not seen and x.shape[:2] == (n_rows, LM["draft_len"] + 1):
            seen.update(x=x.detach().clone(), p=p)
        return moe_ffn(p, c, x)

    moe_mod.moe_ffn = capture
    try:
        paged = run_lm(torch, cfg, params, prompts, MOE_PLAN, paged=True,
                       **kw)
    finally:
        moe_mod.moe_ffn = moe_ffn
    dense = run_lm(torch, cfg, params, prompts,
                   {"speculative": MOE_PLAN["speculative"]}, paged=False,
                   **kw)
    for mode, ref in (("speculative", "greedy"),
                      ("speculative_beam", "beam")):
        same_lm_runs({mode: paged[mode]}, {mode: paged[ref]},
                     f"moe {mode} vs {ref}", calls=False)
    same_lm_runs(dense, {"speculative": paged["speculative"]},
                 "moe dense vs paged")
    check_lm_launches("moe paged", paged, "paged_decode_gqa")
    check_lm_launches("moe dense", dense, "decode_gqa")
    tag = "moe [phi3.5-moe full width, 4 layers]"
    print_lm_runs(tag, "paged", paged, MOE_PLAN)
    print_lm_runs(tag, "dense", dense, MOE_PLAN)
    one_shot_check(torch, cfg, params, prompts[0], paged, "moe", **kw)
    print("moe check: speculative == greedy, SBS == beam, dense == paged, "
          "streaming == one-shot (first prompt, greedy and speculative)",
          flush=True)
    # one MoE layer at the default capacity factor: drops, card vs CPU
    ccfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE["check_capacity_factor"]))
    x, p = seen["x"], seen["p"]
    res = {}
    for dev, prm, xx in (("cuda", p, x), ("cpu", tree_to(p, "cpu"),
                                          x.cpu())):
        out, aux = moe_mod.moe_ffn(prm, ccfg, xx)
        r = moe_mod.moe_route(prm, ccfg, xx.reshape(-1, cfg.d_model))
        res[dev] = (out.cpu(), r["gate_idx"].cpu(), r["keep"].cpu(),
                    float(aux["moe_dropped_frac"]), r["capacity"])
    (oc, gc, kc, dc, cap), (oh, gh, kh, dh, _) = res["cuda"], res["cpu"]
    scale = oh.abs().max().item()
    err = (oc - oh).abs().max().item()
    if not (torch.equal(gc, gh) and torch.equal(kc, kh)
            and err <= MOE["check_tol"] * max(1.0, scale) and dc == dh):
        raise AssertionError(f"moe layer at capacity factor "
                             f"{ccfg.moe.capacity_factor}: card vs CPU "
                             f"experts equal {torch.equal(gc, gh)}, keep "
                             f"equal {torch.equal(kc, kh)}, max err {err} "
                             f"(largest |out| {scale}), dropped {dc} / {dh}")
    print(f"moe check: one layer at capacity factor "
          f"{ccfg.moe.capacity_factor} on the first verify pass's "
          f"{x.shape[0]} x {x.shape[1]} tokens (capacity {cap} a expert): "
          f"card == CPU experts and keep mask, output max err {err:.3e} "
          f"(largest |out| {scale:.3f}), moe_dropped_frac {dc:.4f}",
          flush=True)
    print(f"moe phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {f"moe {k} {m}": r for k, runs in (("paged", paged),
                                               ("dense", dense))
            for m, r in runs.items()}


def rollback_bytes(cfg, n_rows: int, T: int) -> int:
    """Bytes of the per-step recurrent checkpoints a verify pass of
    ``n_rows`` rows x ``T`` fed tokens holds: (T + 1) states a row a
    recurrent layer (RWKV: the WKV state and two token-shift rows; Mamba:
    the conv window and the SSM state), fp32."""
    from repro_torch.models import mamba, rwkv

    per = 0
    for kind in cfg.layer_pattern:
        if kind == "rwkv":
            H, hd = rwkv._heads(cfg)
            per += H * hd * hd + 2 * cfg.d_model
        elif kind == "mamba":
            d_inner, d_state, d_conv, _ = mamba._dims(cfg)
            per += (d_conv - 1) * d_inner + d_inner * d_state
    return cfg.n_repeats * n_rows * (T + 1) * per * 4


def serve_rwkv(torch) -> dict:
    """The recurrent phase: RWKV6-1.6B whole (``RWKV``; weights drawn on
    the card from a CUDA generator seeded 0) on the dense cache; a paged
    engine is refused. Greedy and speculative at 4 slots x 4 prompts.
    Asserts speculative == greedy (the rollback keeps each row's accepted
    checkpoint) and streaming == one-shot on the first prompt; prints the
    walls, the checkpoint bytes a verify pass holds and each pass's peak
    card memory above what was allocated when it began."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    from repro_torch.serving import EngineConfig, StreamingEngine

    t_phase = time.perf_counter()
    cfg = get_config(RWKV["arch"])
    t0 = time.perf_counter()
    params = tr.init(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                     device="cuda")
    torch.cuda.synchronize()
    print(f"recurrent: {cfg.name} whole ({cfg.n_layers} layers); weights "
          f"{tree_bytes(params) / 1e9:.2f} GB fp32 drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    kw = dict(max_new=RWKV["max_new"], n_drafts=RWKV["n_drafts"])
    try:
        StreamingEngine(params, cfg, None, EngineConfig(
            paged=True, **lm_engine_kw(**kw)))
    except ValueError as e:
        print(f"recurrent check: paged refused ({e})", flush=True)
    else:
        raise AssertionError("recurrent: a paged engine was not refused")
    prompts = lm_prompts(cfg.vocab_size, RWKV["n_prompts"], RWKV["len_lo"],
                         RWKV["len_hi"], seed=RWKV["seed"])
    run_lm(torch, cfg, params, prompts[:1], {"speculative": (4, 1)},
           paged=False, max_new=4, n_drafts=RWKV["n_drafts"])  # warm-up
    runs, peak = {}, {}
    for mode in RWKV_PLAN:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        runs.update(run_lm(torch, cfg, params, prompts,
                           {mode: RWKV_PLAN[mode]}, paged=False, **kw))
        peak[mode] = torch.cuda.max_memory_allocated() - base
    same_lm_runs({"speculative": runs["speculative"]},
                 {"speculative": runs["greedy"]},
                 "recurrent speculative vs greedy", calls=False)
    check_lm_launches("recurrent", runs, None)
    print_lm_runs("recurrent [rwkv6-1.6b whole]", "dense", runs, RWKV_PLAN)
    one_shot_check(torch, cfg, params, prompts[0], runs, "recurrent", **kw)
    rows = RWKV_PLAN["speculative"][0] * RWKV["n_drafts"]
    ck = rollback_bytes(cfg, rows, LM["draft_len"] + 1)
    shapes = runs["speculative"]["shapes"]
    print(f"recurrent check: speculative == greedy, streaming == one-shot "
          f"(first prompt); a verify pass of {rows} rows x "
          f"{LM['draft_len'] + 1} tokens holds {ck / 1e9:.2f} GB of "
          f"checkpoints (12 states a row a layer); peak card memory "
          f"above the pass's start (the weights, "
          f"{tree_bytes(params) / 1e9:.2f} GB, held before it): greedy "
          f"{peak['greedy'] / 1e9:.2f} GB, speculative "
          f"{peak['speculative'] / 1e9:.2f} GB; draft_verify launches "
          f"{shapes}", flush=True)
    print(f"recurrent phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {f"recurrent {m}": r for m, r in runs.items()}


# the mesh phase: (data 2, model 2) on 4 ranks of the one card, gloo
MESH = dict(
    shape=(2, 2), lm_arch="smollm-135m", reduced=False,
    # the CLI: 8 requests of 128 tokens, max_new 48, all 8 resident (4
    # slots a shard: a model-axis collective costs ~4-8 ms with 4 ranks on
    # one card, so fewer iterations of more rows cost least)
    cli=["--requests", "8", "--prompt-len", "128", "--max-new", "48",
         "--slots", "8", "--prefill-chunk", "32"],
    lm_prompts=8, lm_len=(24, 64), lm_kw=dict(
        max_new=12, max_src=64, draft_len=4, n_drafts=4, n_beams=2,
        prefill_chunk=32, page_size=16, eos_id=2),
    mt_queries=16, mt_kw=dict(max_new=32, max_src=128, draft_len=4,
                              n_drafts=8, n_beams=2, page_size=16),
    # tests/test_sharded.py's shard-local exhaustion pool
    exhaust=dict(mode="speculative", draft_len=4, n_drafts=6, max_new=24,
                 max_src=96, n_slots=4),
    exhaust_pool=dict(paged=True, page_size=8, n_pages=52),
    # every decoder-only family on the mesh: Phi-3.5-MoE at full width cut
    # to 2 of 32 layers at capacity factor 8.0 (dropless, as serve_moe
    # runs it; weights drawn on the card, the ranks one at a time), four
    # modes at 2 slots a mode; the reduced Llama-4, Jamba, RWKV6 (dense:
    # no attention to page) and VLM greedy and speculative; 8 prompts of
    # 24-64 tokens, max_new 12
    families=(
        ("Phi-3.5-MoE full width paged", "phi3.5-moe-42b-a6.6b",
         dict(n_layers=2, capacity_factor=8.0), 4, True),
        ("Llama-4 reduced paged", "llama4-maverick-400b-a17b", None, 2,
         True),
        ("Jamba reduced paged", "jamba-v0.1-52b", None, 2, True),
        ("RWKV6 reduced dense", "rwkv6-1.6b", None, 2, False),
        ("VLM reduced paged", "llama-3.2-vision-11b", None, 2, True)),
    fam_prompts=8, fam_len=(24, 64),
    # the CLI once more: Jamba alone has Mamba, attention and MoE; 4
    # requests resident at once
    cli_families=["--arch", "jamba-v0.1-52b", "--reduced", "--requests",
                  "4", "--prompt-len", "32", "--max-new", "16", "--slots",
                  "4", "--draft-len", "4", "--n-drafts", "4",
                  "--page-size", "8"])
MESH_TAG = "4 ranks share one card"
MESH_KERNELS = ("decode_gqa", "paged_decode_gqa", "draft_verify",
                "flash_attention")


def mesh_cli(torch, device: str, args: list) -> dict:
    """``repro_torch.launch.serve --mesh 2 2 --paged`` with ``args`` under
    torchrun: 4 ranks, the continuous pass sharded, every check of the
    script."""
    src = Path(__file__).resolve().parent / "src"
    data, model = MESH["shape"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(data * model), "-m",
           "repro_torch.launch.serve", "--device", device, "--paged",
           "--mesh", str(data), str(model), *args]
    env = dict(os.environ, PYTHONPATH=str(src),
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0 or \
            "continuous == one-shot speculative: True" not in res.stdout:
        raise AssertionError(f"mesh CLI failed ({res.returncode}):\n"
                             f"{res.stdout}\n{res.stderr[-4000:]}")
    for line in res.stdout.splitlines():
        print(f"  mesh CLI | {line}", flush=True)
    print(f"mesh CLI: {' '.join(cmd[1:])}: {wall:.1f} s with the world's "
          f"start ({MESH_TAG})", flush=True)
    return {"wall_s": wall}


def mesh_compare(label: str, ref: dict, got: list, n_req: int) -> dict:
    """Every rank's tokens == the unsharded engine's on the card; the
    largest |d logprob|; walls, shard_stats, collectives and launches a
    rank printed. A rank with no launch of a kernel on its path fails."""
    worst = 0.0
    for r in got:
        for a, b in zip(ref["results"], r["results"]):
            if "smiles" in a:
                if a["smiles"] != b["smiles"]:
                    raise AssertionError(f"mesh {label} rank {r['rank']}: "
                                         f"{b['smiles']} != {a['smiles']}")
                continue
            if not np.array_equal(a["tokens"], b["tokens"]):
                raise AssertionError(f"mesh {label} rank {r['rank']}: tokens "
                                     f"{b['tokens']} != {a['tokens']}")
            d = float(np.max(np.abs(np.asarray(a["logprobs"], np.float64)
                                    - np.asarray(b["logprobs"]))))
            worst = max(worst, d)
        if r["shard_stats"] != got[0]["shard_stats"]:
            raise AssertionError(f"mesh {label}: ranks disagree on "
                                 f"shard_stats")
    if worst > 1e-4:
        raise AssertionError(f"mesh {label}: |d logprob| {worst} > 1e-4")
    ls = got[0]["loop_stats"]
    it = max(1, ls["n_iterations"])
    print(f"mesh [{label}]: wall {got[0]['wall_s'] / n_req * 1e3:.2f} ms a "
          f"request sharded, {ref['wall_s'] / n_req * 1e3:.2f} unsharded "
          f"({MESH_TAG}); {n_req} requests, {ls['n_iterations']} "
          f"iterations, tokens == unsharded on every rank, largest |d "
          f"logprob| {worst:.3e}", flush=True)
    print(f"  shard_stats {got[0]['shard_stats']}; collectives an "
          f"iteration: {ls['model_collectives'] / it:.1f} model-axis, "
          f"{ls['data_collectives'] / it:.1f} data-axis, "
          f"{ls['host_collectives'] / it:.2f} host ({ls['bundle_gathers']} "
          f"bundle gathers); dispatches an iteration "
          f"{ls['dispatches_per_iteration']:.2f} (unsharded "
          f"{ref['loop_stats']['dispatches_per_iteration']:.2f}); "
          f"preemptions {got[0]['preemptions']} shards "
          f"{got[0]['preempt_shards']}", flush=True)
    if ref["dropped_frac"] is not None:
        if any(r["dropped_frac"] != got[0]["dropped_frac"] for r in got):
            raise AssertionError(f"mesh {label}: ranks disagree on the "
                                 f"dropped fraction")
        print(f"  MoE dropped fraction {got[0]['dropped_frac']:.4f} "
              f"sharded, {ref['dropped_frac']:.4f} unsharded", flush=True)
    for r in got:
        print(f"  rank {r['rank']} launches "
              f"{ {k: r['launches'][k] for k in MESH_KERNELS} }; local "
              f"widths {r['widths']} (unsharded {ref['widths']})",
              flush=True)
    return {"worst": worst, "launches": [r["launches"] for r in got]}


def check_mesh_groups(label: str, ref: dict, got: list, seen: dict,
                      verify: dict) -> None:
    """Every launch group of a mesh run, each rank's and the unsharded
    engine's: its first live launch (``mesh_runs.LaunchGroups``) agreed
    with the kernel's plain version on the same inputs, and the groups
    cover every launch the run counted. ``seen`` gathers the ranks'
    (kernel, shape) -> [launches, largest |kernel - plain|, rank runs
    that held it on a live launch, rank runs that launched it];
    ``verify`` their draft_verify launches by (N, T, V)."""
    import math

    for r in (ref, *got):
        who = "unsharded" if r is ref else f"rank {r['rank']}"
        covered = dict.fromkeys(MESH_KERNELS, 0)
        for g in r["groups"]:
            if not math.isfinite(g["err"]):
                raise AssertionError(f"mesh {label} {who}: {g['kernel']} at "
                                     f"{g['shape']} disagrees with its "
                                     f"plain version on the same inputs")
            covered[g["kernel"]] += g["launches"]
        if any(covered[k] != r["launches"][k] for k in MESH_KERNELS):
            raise AssertionError(f"mesh {label} {who}: launch groups cover "
                                 f"{covered} of {r['launches']}")
    for r in got:
        for g in r["groups"]:
            key = (g["kernel"], tuple(g["shape"]))
            acc = seen.setdefault(key, [0, 0.0, 0, 0])
            acc[0] += g["launches"]
            acc[1] = max(acc[1], g["err"])
            acc[2] += int(g["live"])
            acc[3] += 1
            if g["kernel"] == "draft_verify":
                verify[key[1]] = verify.get(key[1], 0) + g["launches"]


MESH_GROUP_DIMS = {"decode_gqa": "B T H Kv S hd",
                   "paged_decode_gqa": "B T H Kv P ps nb hd",
                   "flash_attention": "B S H Kv hd",
                   "draft_verify": "N T V"}


def family_runs() -> list:
    """The mesh phase's runs of the decoder-only families (``MESH
    ["families"]``): (label, model, engine kw, jobs, extra, pool)."""
    import dataclasses

    from repro_torch.configs import get_config

    modes = ("greedy", "speculative", "beam", "speculative_beam")
    runs = []
    for label, arch, cut, n_modes, paged in MESH["families"]:
        cfg = get_config(arch, reduced=cut is None)
        model = dict(family="lm", cfg=cfg, seed=SEED)
        if cut is not None:
            model.update(draw="card", capacity_factor=cut["capacity_factor"],
                         cfg=dataclasses.replace(cfg,
                                                 n_layers=cut["n_layers"]))
        prompts = lm_prompts(cfg.vocab_size, MESH["fam_prompts"],
                             *MESH["fam_len"], seed=2)
        jobs = [(p.tolist(), modes[i % n_modes])
                for i, p in enumerate(prompts)]
        kw = dict(MESH["lm_kw"], paged=paged,
                  mode_groups={m: 2 for m in modes[:n_modes]})
        runs.append((label, model, kw, jobs, {}, None))
    return runs


def check_family_launches(label: str, model: dict, paged: bool,
                          got: list) -> None:
    """Every rank of a family run launched draft_verify and, on an
    attention family, its cache's decode read."""
    need = ["draft_verify"]
    if "attn" in model["cfg"].layer_pattern:
        need.append("paged_decode_gqa" if paged else "decode_gqa")
    for r in got:
        if any(r["launches"][k] == 0 for k in need):
            raise AssertionError(f"mesh {label}: rank {r['rank']} launched "
                                 f"{r['launches']}, none of {need}")


def time_mesh_groups(torch, seen: dict) -> None:
    """Kernel, plain and bound times of the decode reads at the family
    runs' launch groups (a rank's local heads and rows), each on the
    seeded inputs of ``kernels.cases`` at its shape, timed here alone
    (``timed_ms``); draft_verify's groups are timed in the main path's
    shape accounting."""
    from repro_torch.kernels import (decode_gqa_attention,
                                     paged_decode_gqa_attention)
    from repro_torch.kernels.cases import decode_inputs, paged_inputs
    from repro_torch.kernels.decode_gqa.ref import (decode_gqa_ref,
                                                    paged_decode_gqa_ref)

    print("mesh family launch groups, timed alone on this card "
          f"({card_line()}):", flush=True)
    for (k, shape), (n, err, live, runs) in sorted(seen.items()):
        if k == "decode_gqa":
            x = decode_inputs(*shape)
            work = decode_work(x[0], x[1], x[3], x[4])
            fn, ref = decode_gqa_attention, decode_gqa_ref
        elif k == "paged_decode_gqa":
            x = paged_inputs(*shape)
            work = paged_work(x[0], x[1], x[3], x[4], x[5])
            fn, ref = paged_decode_gqa_attention, paged_decode_gqa_ref
        else:
            continue
        xs = on_card(torch, x)
        ms = timed_ms(torch, lambda: fn(*xs))
        plain = timed_ms(torch, lambda: ref(*xs))
        b_ms, by = bound(*work)
        dims = dict(zip(MESH_GROUP_DIMS[k].split(), shape))
        print(f"  {k} {dims}: {n} launches over the ranks, kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.5f} ms "
              f"({by})", flush=True)


def serve_mesh(torch, device: str = "cuda") -> dict:
    """The mesh phase: the CLI under torchrun, then a world of 4 ranks on
    the card serving SmolLM-135M (mixed modes, paged and dense),
    mt-product (four modes, paged; the shard-local exhaustion pool) and
    every decoder-only family (``family_runs``), each against the same
    engine unsharded in this process; then the CLI on Jamba."""
    from repro_torch.configs import get_config
    from repro_torch.configs.mt import product_config, with_vocab
    from repro_torch.data import SyntheticReactionDataset
    from repro_torch.launch import mesh_runs
    from repro_torch.launch.world import World

    t0 = time.perf_counter()
    on_card = device == "cuda"
    out = {"cli": mesh_cli(torch, device, [
        "--arch", MESH["lm_arch"], *(["--reduced"] if MESH["reduced"]
                                     else []), *MESH["cli"]])}
    modes = ("greedy", "speculative", "beam", "speculative_beam")
    groups = {m: 2 for m in modes}
    cfg = get_config(MESH["lm_arch"], reduced=MESH["reduced"])
    lm = dict(family="lm", cfg=cfg, seed=SEED)
    prompts = lm_prompts(cfg.vocab_size, MESH["lm_prompts"],
                         *MESH["lm_len"], seed=2)
    lm_jobs = [(p.tolist(), modes[i % 4]) for i, p in enumerate(prompts)]
    ds = SyntheticReactionDataset(16, seed=SEED + 1)
    mt = dict(family="mt", cfg=with_vocab(product_config(),
                                          ds.tokenizer.vocab_size),
              seed=SEED, tokenizer=ds.tokenizer.to_dict())
    mt_jobs = [(ds.pair(i % 16)[0], modes[i % 4])
               for i in range(MESH["mt_queries"])]
    ex_jobs = [(ds.pair(i % 8)[0], "speculative") for i in range(8)]
    runs = [
        ("SmolLM paged", lm, dict(MESH["lm_kw"], paged=True,
                                  mode_groups=groups), lm_jobs, {}, None),
        ("SmolLM dense", lm, dict(MESH["lm_kw"], mode_groups=groups,
                                  page_size=16), lm_jobs, {}, None),
        ("mt-product paged", mt, dict(MESH["mt_kw"], paged=True,
                                      mode_groups=groups), mt_jobs, {},
         None),
        ("mt-product exhaustion", mt, MESH["exhaust"], ex_jobs,
         {"predict": True}, MESH["exhaust_pool"])]
    families = family_runs()
    per_rank = [dict.fromkeys(MESH_KERNELS, 0) for _ in range(4)]
    seen: dict = {}
    fam_keys: set = set()
    verify: dict = {}
    with World(4, device=device) as world:
        print(f"mesh world: 4 ranks, backend {world.backend} ({MESH_TAG})",
              flush=True)
        for label, model, kw, jobs, extra, pool in runs + families:
            t_run = time.perf_counter()
            ref = mesh_runs.serve(model, kw, jobs, mesh=None, on_card=on_card,
                                  **extra)
            gc.collect()       # the unsharded engine's weights, before
            if on_card:        # the ranks draw theirs
                torch.cuda.empty_cache()
            got = world.run("repro_torch.launch.mesh_runs:serve",
                            model=model, engine=dict(kw, **(pool or {})),
                            jobs=jobs, mesh=MESH["shape"], on_card=on_card,
                            **extra)
            out[label] = mesh_compare(label, ref, got, len(jobs))
            check_mesh_groups(label, ref, got, seen, verify)
            if any(label == f[0] for f in families):
                fam_keys |= {(g["kernel"], tuple(g["shape"]))
                             for r in got for g in r["groups"]}
                check_family_launches(label, model, kw.get("paged", False),
                                      got)
                print(f"  mesh {label}: {time.perf_counter() - t_run:.1f} s "
                      f"with its unsharded run", flush=True)
            if pool is not None:
                r0 = got[0]
                if r0["preemptions"] == 0 or None in r0["preempt_shards"]:
                    raise AssertionError(
                        f"mesh {label}: preemptions {r0['preemptions']}, "
                        f"shards named {r0['preempt_shards']}")
                print(f"  peak pages by shard "
                      f"{r0['shard_stats']['peak_pages_by_shard']} of "
                      f"{r0['shard_stats']['shard_capacity']}", flush=True)
            for acc, r in zip(per_rank, got):
                for k in MESH_KERNELS:
                    acc[k] += r["launches"][k]
    out["cli families"] = mesh_cli(torch, device, MESH["cli_families"])
    for rank, acc in enumerate(per_rank):
        if any(n == 0 for n in acc.values()):
            raise AssertionError(f"mesh phase: rank {rank} launched no "
                                 f"kernel of its path: {acc}")
    print("mesh launch groups over the 4 ranks (on every rank the first "
          "launch of each with a live query row, held against the plain "
          "version on the same inputs):", flush=True)
    for (k, shape), (n, err, live, runs) in sorted(seen.items()):
        dims = dict(zip(MESH_GROUP_DIMS[k].split(), shape))
        print(f"  {k} {dims}: {n} launches, largest |kernel - plain| "
              f"{err:.3e}, held on a live launch in {live} of the {runs} "
              f"rank runs that launched it", flush=True)
    if on_card:
        time_mesh_groups(torch, {k: seen[k] for k in fam_keys})
    print(f"mesh phase: every rank launched {list(MESH_KERNELS)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out["per_rank"] = per_rank
    out["verify_shapes"] = verify
    return out


def serve_reduced_families(torch) -> dict:
    """Jamba (Mamba + attention + MoE) and Llama-4 (dense and MoE FFNs,
    shared expert) reduced, weights from a CPU generator seeded 0: greedy
    and speculative on the paged cache, card == CPU tokens and calls, and
    speculative == greedy; Jamba's multi-draft and ``prefix_cache``
    refusals."""
    from repro_torch.configs import get_config
    from repro_torch.core import multidraft_speculative_decode
    from repro_torch.models import transformer as tr
    from repro_torch.serving import EngineConfig, StreamingEngine

    t_phase = time.perf_counter()
    plan = {"greedy": (2, 4), "speculative": (2, 4)}
    kw = dict(max_src=128, max_new=24)
    out = {}
    for arch in REDUCED_FAMILIES:
        cfg = get_config(arch, reduced=True)
        params = tr.init(torch.Generator().manual_seed(SEED), cfg,
                         device="cpu")
        prompts = lm_prompts(cfg.vocab_size, 4, 16, 120, seed=3)
        card = run_lm(torch, cfg, params, prompts, plan, paged=True, **kw)
        cpu = run_lm(torch, cfg, params, prompts, plan, paged=True,
                     device="cpu", **kw)
        same_lm_runs(card, cpu, f"{arch} reduced card vs CPU")
        same_lm_runs({"speculative": card["speculative"]},
                     {"speculative": card["greedy"]},
                     f"{arch} reduced speculative vs greedy", calls=False)
        check_lm_launches(f"{arch} reduced", card, "paged_decode_gqa")
        print_lm_runs(f"reduced [{arch}]", "paged", card, plan)
        out.update({f"{arch} {m}": r for m, r in card.items()})
        if not tr.recurrent(cfg):
            continue
        for what, fn, err in (
                ("prefix_cache", lambda: StreamingEngine(
                    params, cfg, None, EngineConfig(
                        paged=True, prefix_cache=True, **lm_engine_kw(**kw)),
                    device="cpu"), ValueError),
                ("multi-draft", lambda: multidraft_speculative_decode(
                    params, cfg, tr.init_cache(cfg, 1, 32, device="cpu"),
                    torch.tensor([5]), torch.tensor([0]),
                    torch.zeros((1, 2, 3), dtype=torch.int32),
                    torch.ones((1, 2), dtype=torch.bool), max_new=4,
                    eos_id=LM["eos_id"]), NotImplementedError)):
            try:
                fn()
            except err as e:
                if "recurrent" not in str(e):
                    raise
            else:
                raise AssertionError(f"{arch}: {what} was not refused")
        print(f"reduced check: {arch} prefix_cache and multi-draft refused "
              f"by name", flush=True)
    print("reduced check: jamba and llama4 reduced, card == CPU (tokens, "
          "calls), speculative == greedy, paged", flush=True)
    print(f"reduced families phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# -- decoder-only training: SmolLM-135M whole, HuBERT-xlarge, the VLM -------


def lm_prompt(tok, src: str) -> np.ndarray:
    """``lm_batch``'s prompt: [bos] + src + [sep] (sep = eos)."""
    return np.asarray([tok.bos_id] + tok.encode(src) + [tok.eos_id],
                      np.int32)


def train_lm(torch, train_ds, test_ds) -> dict:
    """SmolLM-135M whole (``LM_TRAIN``; weights from a CUDA generator
    seeded 0) trained by the port's ``Trainer`` with ``make_lm_train_step``'s
    defaults on ``train_ds`` in ``lm_batch`` layout; launch counts set to 0
    just before and read just after. Asserts a finite loss, the last
    logged loss < 0.7x the first, and flash_attention forward and backward
    launches. Then serves the trained weights on held-out reactions
    through the decoder-only StreamingEngine (paged, prompt-lookup drafts),
    greedy and speculative: speculative tokens must equal greedy's; prints
    exact-match top-1, acceptance and wall per request (a check of the
    path, not a claim)."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.kernels import launch_counts
    from repro_torch.models import transformer as tr
    from repro_torch.serving import EngineConfig, StreamingEngine
    from repro_torch.training import Trainer, make_lm_train_step

    t_phase = time.perf_counter()
    c = LM_TRAIN
    cfg = get_config(c["arch"])
    tok = train_ds.tokenizer
    params = tr.init(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                     device="cuda")
    trainer = Trainer(cfg, params, make_lm_train_step(cfg))
    del params
    pairs = list(train_ds.pairs())[:c["n_train"]]

    def batches():
        for _ in range(c["epochs"]):
            for i in range(0, len(pairs) - c["batch"] + 1, c["batch"]):
                yield lm_batch(tok, pairs[i:i + c["batch"]], c["max_len"])

    n_steps = c["epochs"] * (len(pairs) // c["batch"])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    hist = trainer.fit(batches(), log_every=c["log_every"], verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch_counts)
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"lm train: loss not finite {losses}")
    if launches["flash_attention"] == 0 or launches["flash_attention_bwd"] == 0:
        raise AssertionError(f"lm train: flash_attention launches {launches}")
    if not losses[-1] < 0.7 * losses[0]:
        raise AssertionError(f"lm train: last loss {losses[-1]} is not < 0.7 "
                             f"x the first {losses[0]}")
    print(f"lm train [{cfg.name} whole, {len(pairs)} reactions in lm_batch "
          f"layout, batch {c['batch']}, max_len {c['max_len']}, "
          f"{c['epochs']} epochs]: {n_steps} steps in {wall:.2f} s, "
          f"{n_steps / wall:.3f} steps/s, launches {launches}", flush=True)
    print("lm train loss curve (step, loss, token accuracy, grad norm): "
          + ", ".join(f"({h['step']}, {h['loss']:.4f}, "
                      f"{h['token_accuracy']:.4f}, {h['grad_norm']:.3f})"
                      for h in hist), flush=True)
    out = {"train": dict(steps=n_steps, wall_s=wall, losses=losses,
                         launches=launches, shapes={})}

    # serve the trained weights on held-out reactions
    tests = list(test_ds.pairs())[:c["n_test"]]
    prompts = [lm_prompt(tok, s) for s, _ in tests]
    kw = dict(n_slots=c["n_slots"], paged=True, page_size=c["page_size"],
              prefill_chunk=c["prefill_chunk"], draft_len=c["draft_len"],
              n_drafts=c["n_drafts"], max_new=c["max_new"],
              max_src=max(len(p) for p in prompts), eos_id=tok.eos_id)
    params = trainer.params
    runs = {}
    for mode in ("greedy", "speculative"):
        eng = StreamingEngine(params, cfg, None, EngineConfig(mode=mode,
                                                              **kw))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        handles = [eng.submit(p) for p in prompts]
        eng.serve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = [h.result() for h in handles]
        toks = [np.asarray(r.tokens[0, :int(r.lengths[0])]) for r in res]
        hits = sum(tok.decode([int(t) for t in x if t != tok.eos_id])
                   == tgt for x, (_, tgt) in zip(toks, tests))
        n_out = sum(int(r.lengths[0]) for r in res)
        runs[mode] = dict(tokens=toks, wall_s=wall,
                          n_calls=[r.n_calls for r in res],
                          accepted=sum(r.accepted for r in res) / max(1,
                                                                      n_out),
                          top1=hits / len(tests), launches=dict(launch_counts),
                          shapes=verify_shapes())
        print(f"lm trained serving [{mode}, {c['n_slots']} slots, paged, "
              f"{len(tests)} held-out reactions, DL {c['draft_len']}, "
              f"{c['n_drafts']} drafts]: wall {wall:.3f} s, "
              f"{wall / len(tests) * 1e3:.2f} ms/request, exact-match top-1 "
              f"{hits}/{len(tests)}, calls {sum(runs[mode]['n_calls'])}, "
              f"acceptance {runs[mode]['accepted']:.4f}, launches "
              f"{runs[mode]['launches']}", flush=True)
    g, s = runs["greedy"]["tokens"], runs["speculative"]["tokens"]
    if not all(np.array_equal(a, b) for a, b in zip(g, s)):
        raise AssertionError("lm trained serving: speculative tokens differ "
                             "from greedy")
    for mode in runs:
        if runs[mode]["launches"]["paged_decode_gqa"] == 0:
            raise AssertionError(f"lm trained serving {mode}: launches "
                                 f"{runs[mode]['launches']}")
    out.update({f"serve {m}": r for m, r in runs.items()})
    print(f"lm train phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


def train_hubert(torch) -> dict:
    """HuBERT-xlarge at full width (48 layers, d_model 1280, 16 heads of 80,
    weights from a CUDA generator seeded 0): ``HUBERT['steps']`` steps of
    ``make_lm_train_step`` on frame embeddings and codebook labels drawn on
    the card from a seed, through the bidirectional flash_attention
    kernels (hd 80 in the 128 bucket). Asserts finite losses and flash
    forward and backward launches; prints steps/s (the steps after the
    first) and the peak memory above the phase's start."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models import transformer as tr
    from repro_torch.training import Trainer, make_lm_train_step
    from repro_torch.training.optimizer import tree_leaves

    t_phase = time.perf_counter()
    c = HUBERT
    cfg = get_config(c["arch"])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = tr.init(gen, cfg, device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(params))
    trainer = Trainer(cfg, params, make_lm_train_step(cfg))
    del params
    batches = [{"embeddings": torch.randn(
                    (c["batch"], c["frames"], cfg.d_model), generator=gen,
                    device="cuda"),
                "labels": torch.randint(0, cfg.vocab_size,
                                        (c["batch"], c["frames"]),
                                        generator=gen, device="cuda")}
               for _ in range(c["steps"])]
    torch.cuda.synchronize()
    reset_counts()
    times = []
    for b in batches:
        t0 = time.perf_counter()
        trainer.fit([b], log_every=1, verbose=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated() - base
    losses = [h["loss"] for h in trainer.history]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"hubert: loss not finite {losses}")
    if launches["flash_attention"] == 0 or launches["flash_attention_bwd"] == 0:
        raise AssertionError(f"hubert: flash_attention launches {launches}")
    rate = (len(times) - 1) / sum(times[1:])
    print(f"hubert train [{cfg.name} full width, {n_params / 1e9:.3f} B "
          f"params, B {c['batch']} x T {c['frames']}, bidirectional]: "
          f"{len(times)} steps, step times {[round(t, 3) for t in times]} s, "
          f"{rate:.3f} steps/s after the first, losses "
          f"{[round(x, 4) for x in losses]}, peak memory above the phase's "
          f"start {peak / 1e9:.2f} GB, launches {launches}", flush=True)
    del trainer, batches
    print(f"hubert phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"train": dict(launches=launches, shapes={}, steps_per_s=rate,
                          peak_bytes=peak, losses=losses)}


def vlm_main_shapes(cfg) -> tuple[dict, dict]:
    """The VLM phase's decode_gqa and flash_attention launch groups at the
    config's heads (full width: H 32 over Kv 8, hd 128), from ``VLM`` and
    its prompts' lengths (``lm_prompts`` draws them before the tokens):
    the ragged prefill of the 4 prompts (T = the longest less 1, nothing
    cached before it), the expanded verify pass (4 x N_d rows, T DL + 1)
    and the greedy step, all over rows of the longest + max_new + DL + 2
    slots; the apply check's prefill of the first prompt less its last
    ``apply_tail`` tokens and its decode step over those, in a row of the
    prompt's length; and apply's forward over the first prompt (causal, no
    key mask). draft_verify's groups are ``cases.VERIFY_LM``'s ``vlm_*``."""
    c = VLM
    L = [len(p) for p in lm_prompts(cfg.vocab_size, c["n_prompts"],
                                    c["len_lo"], c["len_hi"], seed=c["seed"])]
    n, tail, T = L[0], c["apply_tail"], max(L)
    size = T + c["max_new"] + c["draft_len"] + 2
    head = dict(H=cfg.n_heads, Kv=cfg.n_kv_heads, hd=cfg.head_dim, window=0)
    B = c["n_prompts"]
    decode = {"vlm_prefill": dict(B=B, T=T - 1, S=size, prefix=0, **head),
              "vlm_verify": dict(B=B * c["n_drafts"], T=c["draft_len"] + 1,
                                 S=size, **head),
              "vlm_greedy": dict(B=B, T=1, S=size, **head),
              "vlm_apply_prefill": dict(B=1, T=n - tail, S=n, prefix=0,
                                        **head),
              "vlm_apply_decode": dict(B=1, T=tail, S=n, prefix=n - tail,
                                       **head)}
    flash = {"vlm_apply": dict(B=1, S=n, H=head["H"], Kv=head["Kv"],
                               hd=head["hd"], causal=True, backward=False,
                               lengths=None)}
    return decode, flash


def serve_vlm(torch) -> dict:
    """Llama-3.2-Vision-11B at full width, cut to its first 5-layer block
    (``VLM``: 4 self-attention layers, then 1 gated cross-attention layer
    over 1,601 memory tokens of 4,096; weights from a CUDA generator seeded
    0, the cross-attention gates set to ``VLM['gate']``, since init leaves
    them 0 and tanh(0) would hide the memory). 4 prompts of 64-256 tokens
    with a seeded memory and a ragged memory mask, prefilled together
    (ragged lengths), then greedy, the expanded speculative decode and
    ``multidraft_speculative_decode`` with prompt-lookup drafts: tokens
    and the speculative calls must agree. ``apply``'s logits over the first
    prompt must equal ``prefill`` + ``decode_step``'s within
    ``LM_LOGIT_TOL`` of the largest |logit|."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import (greedy_decode,
                                  multidraft_speculative_decode,
                                  prompt_lookup_drafts,
                                  speculative_greedy_decode,
                                  transformer_handle)
    from repro_torch.kernels import launch_counts
    from repro_torch.models import transformer as tr

    t_phase = time.perf_counter()
    c = VLM
    full = get_config(c["arch"])
    cfg = dataclasses.replace(full, n_layers=len(full.layer_pattern))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = tr.init(gen, cfg, device="cuda")
    for i, kind in enumerate(cfg.layer_pattern):
        if kind == "xattn":
            for p in params["blocks"][i]:
                p["xattn_gate"].fill_(c["gate"])
    torch.cuda.synchronize()
    print(f"vlm: {cfg.name}, {cfg.n_layers} of {full.n_layers} layers "
          f"({cfg.layer_pattern}), memory {cfg.memory_tokens} x "
          f"{cfg.memory_dim}; weights {tree_bytes(params) / 1e9:.2f} GB fp32 "
          f"drawn on the card in {time.perf_counter() - t0:.2f} s; each more "
          f"5-layer block adds {tree_bytes(params['blocks']) / 1e9:.2f} GB",
          flush=True)
    prompts = lm_prompts(cfg.vocab_size, c["n_prompts"], c["len_lo"],
                         c["len_hi"], seed=c["seed"])
    B, M = len(prompts), cfg.memory_tokens
    memory = 0.1 * torch.randn((B, M, cfg.memory_dim), generator=gen,
                               device="cuda")
    mm = (torch.arange(M, device="cuda")[None]
          < torch.tensor(c["memory_lengths"], device="cuda")[:, None])
    L = np.array([len(p) for p in prompts], np.int32)
    T = int(L.max())
    toks = np.zeros((B, T), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    DL, N_d, max_new = c["draft_len"], c["n_drafts"], c["max_new"]
    size = T + max_new + DL + 2
    last = torch.from_numpy(toks[np.arange(B), L - 1]).cuda()
    pos = torch.from_numpy(L - 1).cuda()
    drafts, dmask = zip(*(prompt_lookup_drafts(p, DL, N_d) for p in prompts))
    drafts = torch.from_numpy(np.stack(drafts)).cuda()
    dmask = torch.from_numpy(np.stack(dmask)).cuda()
    handle = transformer_handle(params, cfg, memory_mask=mm)
    kw = dict(max_new=max_new, eos_id=c["eos_id"])

    def fresh():
        cache = tr.init_cache(cfg, B, size, device="cuda")
        _, cache = tr.prefill(params, cfg, cache,
                              torch.from_numpy(toks[:, :T - 1]).cuda(),
                              lengths=torch.from_numpy(L - 1).cuda(),
                              memory=memory, memory_mask=mm)
        return cache

    runs = {}
    for name, run in (
            ("greedy", lambda cache: greedy_decode(handle, cache, last, pos,
                                                   **kw)),
            ("speculative", lambda cache: speculative_greedy_decode(
                handle, cache, last, pos, drafts, dmask, **kw)),
            ("multidraft", lambda cache: multidraft_speculative_decode(
                params, cfg, cache, last, pos, drafts, dmask,
                memory_mask=mm, **kw))):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        r = run(fresh())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = dict(tokens=r.tokens.cpu().numpy(),
                          lengths=r.lengths.cpu().numpy(),
                          n_calls=int(r.n_calls), wall_s=wall,
                          launches=dict(launch_counts), shapes=verify_shapes())
        print(f"vlm [{name}, B {B}, prompts {L.tolist()}, memory lengths "
              f"{c['memory_lengths']}, DL {DL}, {N_d} drafts]: prefill + "
              f"decode wall {wall:.3f} s, {wall / B * 1e3:.1f} ms/prompt, "
              f"calls {int(r.n_calls)}, lengths {runs[name]['lengths']}, "
              f"launches {runs[name]['launches']}", flush=True)
    for name in ("speculative", "multidraft"):
        if not np.array_equal(runs[name]["tokens"], runs["greedy"]["tokens"]):
            raise AssertionError(f"vlm {name}: tokens differ from greedy")
    if runs["multidraft"]["n_calls"] != runs["speculative"]["n_calls"]:
        raise AssertionError(f"vlm: multidraft calls "
                             f"{runs['multidraft']['n_calls']} != expanded "
                             f"{runs['speculative']['n_calls']}")

    # apply == prefill + decode_step on the first prompt, on the card
    n, tail = int(L[0]), c["apply_tail"]
    x = torch.from_numpy(prompts[0][None]).cuda()
    kw1 = dict(memory=memory[:1], memory_mask=mm[:1])
    reset_counts()
    with torch.no_grad():
        full_logits, _ = tr.apply(params, cfg, x, **kw1)
        cache = tr.init_cache(cfg, 1, n, device="cuda")
        pre, cache = tr.prefill(params, cfg, cache, x[:, :n - tail], **kw1)
        dec, _ = tr.decode_step(params, cfg, cache, x[:, n - tail:],
                                torch.arange(n - tail, n, device="cuda",
                                             dtype=torch.int32)[None],
                                memory_mask=mm[:1])
    torch.cuda.synchronize()
    apply_launches = dict(launch_counts)
    if apply_launches["flash_attention"] == 0:
        raise AssertionError(f"vlm apply: launches {apply_launches}")
    got = torch.cat([pre, dec], 1)
    scale = full_logits.abs().max().item()
    err = (got - full_logits).abs().max().item()
    if not err <= LM_LOGIT_TOL * scale:
        raise AssertionError(f"vlm: apply logits differ from prefill + "
                             f"decode_step by {err} (largest |logit| "
                             f"{scale})")
    print(f"vlm check: greedy == speculative == multidraft tokens, "
          f"multidraft calls == expanded; apply == prefill + decode_step "
          f"over {n} tokens, max err {err:.3g} of largest |logit| "
          f"{scale:.3g}", flush=True)
    runs["apply"] = dict(launches=apply_launches, shapes={})
    print(f"vlm phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return runs


def check_lm_train_steps(torch) -> None:
    """One ``make_lm_train_step`` step of every reduced decoder-only arch,
    the reduced VLM and the reduced HuBERT on the card against the CPU's
    plain path with the same weights (a CPU generator) and batch: the
    loss, every metric and every gradient leaf within 1e-4 (TF32 off)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticReactionDataset, lm_batch
    from repro_torch.models import transformer as tr
    from repro_torch.training import lm_loss_and_grads, make_lm_train_step
    from repro_torch.training.optimizer import (adam_init, tree_leaves,
                                                tree_unflatten)

    t_phase = time.perf_counter()
    ds = SyntheticReactionDataset(4, seed=3)
    worst = {}
    for arch in LM_ARCHS:
        cfg = get_config(arch, reduced=True)
        cpu_params = tr.init(torch.Generator().manual_seed(SEED + 3), cfg,
                             device="cpu")
        for i, kind in enumerate(cfg.layer_pattern):
            if kind == "xattn":
                for p in cpu_params["blocks"][i]:
                    p["xattn_gate"].fill_(VLM["gate"])
        rng = np.random.default_rng(4)
        if cfg.family == "audio":
            batch = {"embeddings": (0.1 * rng.standard_normal(
                         (4, 24, cfg.d_model))).astype(np.float32),
                     "labels": rng.integers(0, cfg.vocab_size, (4, 24))}
        else:
            batch = lm_batch(ds.tokenizer, list(ds.pairs()), 24)
            if cfg.family == "vlm":
                batch["memory"] = (0.1 * rng.standard_normal(
                    (4, cfg.memory_tokens, cfg.memory_dim))).astype(
                        np.float32)
        out = {}
        for dev in ("cuda", "cpu"):
            p = tree_unflatten(cpu_params, [t.detach().to(dev, copy=True)
                                            for t in tree_leaves(cpu_params)])
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            loss, metrics, grads = lm_loss_and_grads(p, cfg, b)
            _, _, m1 = make_lm_train_step(cfg)(p, adam_init(p), b)
            out[dev] = (loss, metrics, grads, m1)
        (lg, mg, gg, sg), (lc, mc, gc, sc) = out["cuda"], out["cpu"]
        pairs = [(lg, lc)] + [(mg[k], mc[k]) for k in mc] + [
            (sg[k], sc[k]) for k in sc] + list(zip(tree_leaves(gg),
                                                    tree_leaves(gc)))
        for a, b in pairs:
            if not np.allclose(a.detach().cpu().numpy(), b.detach().numpy(),
                               atol=1e-4, rtol=1e-4):
                raise AssertionError(f"lm train step {arch}: card {a} != "
                                     f"cpu {b}")
        worst[arch] = max((a.detach().cpu() - b.detach()).abs().max().item()
                          for a, b in pairs)
    print(f"reference check: one make_lm_train_step step of every reduced "
          f"decoder-only arch, the VLM and HuBERT on the card == the CPU "
          f"plain path (loss, metrics, every gradient leaf within 1e-4; max "
          f"abs err {worst}) in {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def check_train_step(torch, ds, tcfg, cpu_params) -> None:
    """One train step of the tiny model on the card against the CPU's plain
    path, same weights and batch: loss, metrics and every gradient leaf
    within 1e-4, then the whole step's metrics (clip + Adam)."""
    from repro_torch.data import padded_batch
    from repro_torch.training import (make_seq2seq_train_step,
                                      seq2seq_loss_and_grads)
    from repro_torch.training.optimizer import (adam_init, tree_leaves,
                                                tree_unflatten)

    batch = padded_batch(ds.tokenizer, [ds.pair(i)
                                              for i in range(8)], 48, 48)
    step = make_seq2seq_train_step(tcfg, lr=TRAIN["lr"], label_smoothing=0.1)
    out = {}
    for dev in ("cuda", "cpu"):
        p = tree_unflatten(cpu_params, [t.detach().to(dev, copy=True)
                                        for t in tree_leaves(cpu_params)])
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        loss, metrics, grads = seq2seq_loss_and_grads(p, tcfg, b,
                                                      label_smoothing=0.1)
        _, _, m1 = step(p, adam_init(p), b)
        out[dev] = (loss, metrics, grads, m1)
    (lg, mg, gg, sg), (lc, mc, gc, sc) = out["cuda"], out["cpu"]
    pairs = [(lg, lc)] + [(mg[k], mc[k]) for k in mc] + [
        (sg[k], sc[k]) for k in sc] + list(zip(tree_leaves(gg),
                                                tree_leaves(gc)))
    err = max((a.detach().cpu() - b.detach()).abs().max().item()
              for a, b in pairs)
    for a, b in pairs:
        if not np.allclose(a.detach().cpu().numpy(), b.detach().numpy(),
                           atol=1e-4, rtol=1e-4):
            raise AssertionError(f"train step: card {a} != cpu {b}")
    print(f"reference check: tiny model, one train step on the card == the "
          f"CPU plain path (loss {float(lc):.6f}, grad norm "
          f"{float(sc['grad_norm']):.6f}, {len(tree_leaves(gc))} gradient "
          f"leaves, max abs err {err:.3g})", flush=True)


def check_train_drift(torch, ds, tcfg, cpu_params, n_steps: int = 50):
    """``n_steps`` whole train steps (clip + Adam) of the tiny model on the
    card and on the CPU from the same weights, over the same batches (8
    queries each, in turn): prints the first step whose losses part by
    more than 1e-4, or that none did. A measurement, not a check: fp32
    sums taken in another order may part after enough steps."""
    from repro_torch.data import padded_batch
    from repro_torch.training import make_seq2seq_train_step
    from repro_torch.training.optimizer import (adam_init, tree_leaves,
                                                tree_unflatten)

    batches = [padded_batch(ds.tokenizer, [ds.pair((8 * i + j) % len(ds))
                                           for j in range(8)], 48, 48)
               for i in range(2)]
    step = make_seq2seq_train_step(tcfg, lr=TRAIN["lr"], label_smoothing=0.1)

    def losses(dev):
        p = tree_unflatten(cpu_params, [t.detach().to(dev, copy=True)
                                        for t in tree_leaves(cpu_params)])
        opt = adam_init(p)
        bs = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
              for b in batches]
        out = []
        for i in range(n_steps):
            p, opt, m = step(p, opt, bs[i % len(bs)])
            out.append(float(m["loss"]))
        return np.asarray(out)

    card, cpu = losses("cuda"), losses("cpu")
    diff = np.abs(card - cpu)
    parted = np.flatnonzero(diff > 1e-4)
    first = (f"first at step {int(parted[0])} (card {card[parted[0]]:.6f}, "
             f"CPU {cpu[parted[0]]:.6f})" if parted.size else "never")
    print(f"train drift: tiny model, {n_steps} steps on the card and the "
          f"CPU from the same weights: losses part by > 1e-4 {first}; "
          f"max |diff| {diff.max():.3g}; last loss card {card[-1]:.6f}, CPU "
          f"{cpu[-1]:.6f}", flush=True)


def decode_times(torch, dense: dict, paged: dict, verify: dict) -> dict:
    """Kernel time (``timed_ms``) of the public decode and verify wrappers
    at each shape, on the seeded inputs of ``kernels.cases``: the part of
    the kernel checks that two trees of the port share, so their kernels
    can be compared in one call."""
    from repro_torch.kernels import (decode_gqa_attention, draft_verify,
                                     paged_decode_gqa_attention)
    from repro_torch.kernels.cases import (decode_inputs, paged_inputs,
                                           verify_inputs)

    out = {}
    for name, c in dense.items():
        x = on_card(torch, decode_inputs(*(c[k] for k in DECODE_KEYS)))
        out[f"decode_gqa/{name}"] = timed_ms(
            torch, lambda: decode_gqa_attention(*x))
    for name, c in paged.items():
        x = on_card(torch, paged_inputs(*(c[k] for k in PAGED_KEYS),
                                        n_mapped=c["n_mapped"]))
        out[f"paged_decode_gqa/{name}"] = timed_ms(
            torch, lambda: paged_decode_gqa_attention(*x))
    for name, (N, T, V) in verify.items():
        x = on_card(torch, verify_inputs(N, T, V))
        out[f"draft_verify/{name}"] = timed_ms(torch,
                                               lambda: draft_verify(*x))
    return out


def kernel_ms(torch, fn, names, iters: int = 50) -> dict:
    """Device time per call of the kernels whose names hold each of
    ``names`` (their times summed under torch.profiler), the L2 flushed
    before each call as in ``timed_ms``: one time for each kernel of a
    wrapper that launches several."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 * 2**20 // 4, device="cuda")
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    events = kernel_events(prof)
    return {n: sum(t for k, t, _ in events if n in k) / iters / 1e3
            for n in names}


def flash_ab(torch, flash: dict) -> tuple[dict, dict]:
    """flash_attention's forward and backward kernels at ``flash``'s shapes
    (name -> B, S, H, hd, causal, backward, lengths: one query head a kv
    head and no positions, the calls every tree of the port takes) on
    ``cases.flash_inputs``: their times (``timed_ms``; the backward's two
    kernels also each by ``kernel_ms``), and a SHA-256 of each output's
    bytes (out, and lse, dq, dk, dv where ``backward``), so two trees'
    kernels can be held to each other bitwise across processes."""
    import hashlib

    from repro_torch.kernels.cases import flash_inputs
    from repro_torch.kernels.flash_attention.ops import _backward, _forward

    times, bits = {}, {}
    for name, m in flash.items():
        q, k, v, do, km = flash_inputs(m["B"], m["S"], m["H"], m["hd"],
                                       lengths=m["lengths"])
        q, k, v, do = on_card(torch, (q, k, v, do))
        km = None if km is None else torch.from_numpy(km).cuda()
        causal, bw = m["causal"], m["backward"]
        out, lse = _forward(q, k, v, km, causal, 0, with_lse=bw)
        outs = dict(out=out)
        times[f"flash_attention/{name}"] = timed_ms(
            torch, lambda: _forward(q, k, v, km, causal, 0, with_lse=bw))
        if bw:
            dq, dk, dv = _backward(q, k, v, out, lse, do, km, causal, 0)
            outs.update(lse=lse, dq=dq, dk=dk, dv=dv)
            times[f"flash_attention_bwd/{name}"] = timed_ms(
                torch, lambda: _backward(q, k, v, out, lse, do, km, causal,
                                         0))
            times.update({f"{kern}/{name}": ms for kern, ms in kernel_ms(
                torch, lambda: _backward(q, k, v, out, lse, do, km, causal,
                                         0),
                ("flash_bwd_dq", "flash_bwd_dkdv")).items()})
        torch.cuda.synchronize()
        bits.update({f"{name}/{o}": hashlib.sha256(
            t.cpu().numpy().tobytes()).hexdigest() for o, t in outs.items()})
    return times, bits


def compare_decode(baseline: Path, dense: dict, paged: dict,
                   verify: dict, flash: dict) -> tuple[dict, list]:
    """The decode, verify and flash kernels of another tree of the port
    (``baseline``, e.g. a ``git archive`` of the parent commit) against
    this tree's, in turns: baseline, this, this, baseline, each run in a
    process of its own that imports that tree's ``repro_torch`` and builds
    its kernels (both sides alike: one tree's times moved by up to 5%
    between this process, after the kernel checks, and a fresh one).
    ``verify``: (N, T, V) by name, each T within what both trees' kernels
    take; ``flash``: see ``flash_ab``. Returns the times by kernel and
    shape, and the flash outputs whose bytes differ between any two of
    the four runs (none: the trees compute bitwise alike there)."""

    def run(tree: Path) -> dict:
        spec = json.dumps(dict(src=str(tree.resolve() / "src"), dense=dense,
                               paged=paged, verify=verify, flash=flash))
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--decode-times", spec], capture_output=True,
                             text=True, timeout=600)
        if out.returncode != 0:
            raise RuntimeError(f"decode timing of {tree} failed:\n"
                               f"{out.stdout}\n{out.stderr}")
        return json.loads(out.stdout.strip().splitlines()[-1])

    this = Path(__file__).resolve().parent
    runs = [run(baseline), run(this), run(this), run(baseline)]
    differ = sorted(o for o in runs[0]["bits"]
                    if len({r["bits"][o] for r in runs}) != 1)
    t = [r["times"] for r in runs]
    return {name: dict(baseline_ms=(t[0][name], t[3][name]),
                       ms=(t[1][name], t[2][name]))
            for name in t[0]}, differ


def train_plain_flash(torch, train_ds, which: str) -> None:
    """The train phase with flash_attention's plain versions in place of
    its kernels on CUDA tensors: the backward's (``flash_attention_bwd_ref``)
    for ``which`` "bwd", the forward's too for "all". The loss curve is
    held against the kernels' (ROADMAP Queue 3, the training drift). The
    launch counts then count the plain calls."""
    import importlib

    ops = importlib.import_module("repro_torch.kernels.flash_attention.ops")

    def plain_bwd(q, k, v, o, lse, do, key_mask, *, causal, window):
        return ops.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                           window=window, key_mask=key_mask)

    def plain_fwd(q, k, v, key_mask, *, causal, window, with_lse):
        out, lse = ops.flash_attention_ref(q, k, v, causal=causal,
                                           window=window, key_mask=key_mask)
        return out, (lse if with_lse else None)

    ops.flash_attention_bwd_kernel = plain_bwd
    if which == "all":
        ops.flash_attention_fwd_kernel = plain_fwd
    swapped = "forward and backward" if which == "all" else "backward"
    print(f"train: flash_attention's plain versions on the card in place of "
          f"its kernels: {swapped}", flush=True)
    run_training(torch, train_ds)


def print_verify_gaps(torch, timed: dict, seen: dict, floor_ms: float,
                      ab: dict | None) -> None:
    """draft_verify where the main path launched it: each (N, T, V) of this
    run (``seen``: launches by shape) with its kernel, bound, plain and
    ``torch.argmax`` times (``timed``, by name; a shape not checked and
    timed yet is held to its plain version, bitwise, and timed now) and
    its launch-weighted gap, launches x (time - max(bound, floor)),
    ``floor_ms`` being a one-element fill's time; with
    ``--baseline`` (``ab``) also the gap of each tree's mean time in the
    turns."""
    by_shape = {tuple(m["shape"].values()): (name, m)
                for name, m in timed.items()}
    total = {"this run": 0.0, "A/B baseline": 0.0, "A/B this": 0.0}
    for shape, n in sorted(seen.items(), key=lambda kv: -kv[1]):
        if shape not in by_shape:   # held to its plain version here
            verify_agrees(torch, *shape, torch.float32)
        name, m = by_shape.get(shape) or (None, verify_timing(torch, *shape))
        floor = max(m["bound_ms"], floor_ms)
        gap = n * (m["ms"] - floor)
        total["this run"] += gap
        line = (f"  draft_verify {list(shape)} ({name or 'not a group'}): "
                f"{n} launches, kernel {m['ms']:.4f} ms ({m['path']}), "
                f"bound {m['bound_ms']:.5f}, plain {m['plain_ms']:.4f}, "
                f"argmax {m['library_ms']:.4f}; gap {gap:.2f} ms")
        r = (ab or {}).get(f"draft_verify/{name}")
        if r is not None:
            b, t = float(np.mean(r["baseline_ms"])), float(np.mean(r["ms"]))
            total["A/B baseline"] += n * (b - floor)
            total["A/B this"] += n * (t - floor)
            line += (f" [A/B: baseline {b:.4f} ms, gap {n * (b - floor):.2f};"
                     f" this {t:.4f} ms, gap {n * (t - floor):.2f}]")
        print(line, flush=True)
    print(f"  draft_verify launch-weighted gap total (floor "
          f"{floor_ms:.4f} ms): " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in total.items()
              if ab or k == "this run"), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only")
    ap.add_argument("--baseline", metavar="DIR", type=Path,
                    help="also time the decode, verify and MT flash "
                         "kernels of another tree of the port (DIR: its "
                         "root) against this one's, in turns, and hold the "
                         "flash outputs bitwise equal")
    ap.add_argument("--decode-times", metavar="JSON",
                    help=argparse.SUPPRESS)   # compare_decode's child
    ap.add_argument("--plain-flash", choices=("bwd", "all"),
                    help="train mt-product only, with flash_attention's "
                         "plain version in place of its backward kernel "
                         "(bwd) or of both kernels (all), and print the "
                         "loss curve")
    ap.add_argument("--profile", metavar="DIR", type=Path,
                    help="also trace each mode with torch.profiler (device "
                         "time by kernel, the device's busy share) and "
                         "write the tables to DIR")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.decode_times:   # time one tree's decode and verify kernels, only
        spec = json.loads(args.decode_times)
        sys.path.insert(0, spec["src"])
        times = decode_times(torch, spec["dense"], spec["paged"],
                             spec["verify"])
        flash_times, bits = flash_ab(torch, spec["flash"])
        print(json.dumps(dict(times=dict(times, **flash_times), bits=bits)))
        return 0
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.mt import product_config, tiny_config, with_vocab
    from repro_torch.data import SyntheticReactionDataset, padded_batch
    from repro_torch.kernels import _build
    from repro_torch.models import seq2seq as s2s
    from repro_torch.serving import EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    build_s = _build.build_all()
    print(f"build: {build_s:.1f} s", flush=True)
    for name, log in _build.build_log.items():
        report_ptxas(name, log)

    ds = SyntheticReactionDataset(16, seed=SEED + 1)
    queries = [ds.pair(i)[0] for i in range(16)]
    ecfg = EngineConfig()
    vocab = ds.tokenizer.vocab_size
    # benchmarks/common.py's corpus: train on 512 forward reactions, serve
    # 64 held out, all through the training set's tokenizer
    train_ds = SyntheticReactionDataset(TRAIN["n_train"], seed=SEED)
    test_ds = SyntheticReactionDataset(TRAIN["n_test"], seed=10_000)
    if args.plain_flash:
        train_plain_flash(torch, train_ds, args.plain_flash)
        return 0
    global _verify_shapes
    _verify_shapes = VerifyShapes()
    src = np.stack([ds.tokenizer.encode_padded(q, ecfg.max_src, add_eos=True)
                    for q in queries])
    batch0 = padded_batch(train_ds.tokenizer, [train_ds.pair(i) for i in
                                               range(TRAIN["batch"])],
                          TRAIN["max_len"], TRAIN["max_len"])
    B_t, S_t = TRAIN["batch"], TRAIN["max_len"]
    flash_main = {   # H 8, hd 32: mt-product's heads
        "serving_encoder": dict(B=16, S=ecfg.max_src, H=8, hd=32,
                                causal=False, backward=False,
                                lengths=(src != 0).sum(1)),
        "train_encoder": dict(B=B_t, S=S_t, H=8, hd=32, causal=False,
                              backward=True,
                              lengths=(batch0["src"] != 0).sum(1)),
        "train_decoder": dict(B=B_t, S=S_t, H=8, hd=32, causal=True,
                              backward=True, lengths=None),
        # the decoder-only training phases' shapes: SmolLM-135M (9 query
        # heads over 3 kv heads, hd 64) at its train batch, causal; and
        # HuBERT-xlarge (16 heads of 80, the 128 bucket) at B 4 x T 500,
        # bidirectional
        "smollm_train": dict(B=LM_TRAIN["batch"], S=LM_TRAIN["max_len"] - 1,
                             H=9, Kv=3, hd=64, causal=True, backward=True,
                             lengths=None),
        "hubert_train": dict(B=HUBERT["batch"], S=HUBERT["frames"], H=16,
                             hd=80, causal=False, backward=True,
                             lengths=None)}
    # the VLM phase's decode and apply shapes (Llama-3.2-Vision's heads)
    from repro_torch.configs import get_config
    decode_vlm, flash_vlm = vlm_main_shapes(get_config(VLM["arch"]))
    flash_main.update(flash_vlm)
    t0 = time.perf_counter()
    # the timed shapes are those of 8 slots (speculative: 8 x N_d rows)
    n_slots = STREAM_PLAN["speculative"][0]
    verify_main = verify_main_shapes(ecfg, n_slots, len(queries), vocab,
                                     train_ds.tokenizer.vocab_size)
    kern = check_kernels(torch, ecfg, n_slots, verify_main, flash_main,
                         decode_vlm)
    print(f"kernel checks passed ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    for name, r in kern.items():
        for shape, m in r["shapes"].items():
            splits = "" if "n_split" not in m else (
                f", {m['n_split']} split(s)" + ("" if "split_ms" not in m else
                " (forced: " + ", ".join(f"{n} {t:.4f} ms" for n, t in
                                         m["split_ms"].items()) + ")"))
            print(f"  {name} [{shape}] {m['shape']}: kernel {m['ms']:.4f} ms"
                  f"{splits}{', ' + m['path'] if 'path' in m else ''}, "
                  f"plain {m['plain_ms']:.4f} ms, library "
                  f"{m['library_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
                  f"({m['bound_by']}: {m['bytes']} B, {m['flops']} flop)")
    one = torch.zeros(1, device="cuda")
    floor_ms = timed_ms(torch, one.zero_)
    print(f"  timing floor: a 1-element fill, {floor_ms:.4f} ms (launch and "
          f"event overhead in every kernel time)", flush=True)
    ab = None
    if args.baseline:
        # the MT's flash shapes (no positions, one head a kv head)
        mt_flash = {name: dict(m, lengths=None if m["lengths"] is None else
                               [int(n) for n in m["lengths"]])
                    for name, m in flash_main.items()
                    if name in ("serving_encoder", "train_encoder",
                                "train_decoder")}
        ab, differ = compare_decode(
            args.baseline, decode_main_shapes(ecfg, n_slots),
            paged_main_shapes(ecfg, n_slots),
            dict(verify_main, **VERIFY_TIMED_CARD_ONLY), mt_flash)
        for name, r in ab.items():
            print(f"  A/B {name}: baseline {r['baseline_ms'][0]:.4f} / "
                  f"{r['baseline_ms'][1]:.4f} ms, this tree {r['ms'][0]:.4f} "
                  f"/ {r['ms'][1]:.4f} ms (baseline, this, this, baseline)",
                  flush=True)
        if differ:
            raise AssertionError(f"A/B: flash outputs whose bytes differ "
                                 f"between the trees or runs: {differ}")
        print(f"  A/B flash_attention forward and backward outputs at "
              f"{sorted(mt_flash)}: bitwise equal in all four runs",
              flush=True)
    if args.quick:
        print(json.dumps({"kernels_checked": sorted(kern)}))
        return 0
    names = tuple(_build.launch_counts)
    main_launches = dict.fromkeys(names, 0)
    main_shapes: dict[tuple, int] = {}

    def add_shapes(r: dict) -> None:
        for k, n in r["shapes"].items():
            main_shapes[k] = main_shapes.get(k, 0) + n

    # -- one-shot: ReactionEngine at mt-product width, seeded weights ----------
    cfg = with_vocab(product_config(), vocab)
    params = s2s.init(torch.Generator().manual_seed(SEED), cfg, device="cuda")
    modes = ("greedy", "speculative", "beam", "speculative_beam")
    n_topn = STREAM_PLAN["beam"][1]
    ekw = dict(draft_len=ecfg.draft_len, n_drafts=ecfg.n_drafts,
               n_beams=ecfg.n_beams, max_new=ecfg.max_new,
               max_src=ecfg.max_src)
    run_engine(torch, ds, cfg, params, ekw, queries[:1], modes)   # warm-up
    res = run_engine(torch, ds, cfg, params, ekw, queries, modes[:2])
    res.update(run_engine(torch, ds, cfg, params, ekw, queries[:n_topn],
                          modes[2:]))
    g, s = res["greedy"]["preds"], res["speculative"]["preds"]
    if [p.smiles for p in g] != [p.smiles for p in s]:
        raise AssertionError("speculative tokens differ from greedy")
    for mode in modes:
        launches = res[mode]["launches"]
        if launches["decode_gqa"] == 0:
            raise AssertionError(f"{mode}: decode_gqa was never launched")
        if mode in ("greedy", "speculative") and launches["draft_verify"] == 0:
            raise AssertionError(f"{mode}: draft_verify was never launched")
        check_encoder_launches(launches, f"one-shot {mode}")
        preds = res[mode]["preds"]
        for p in preds:
            if not (np.all(np.isfinite(p.logprobs)) and p.smiles
                    and all(isinstance(x, str) for x in p.smiles)):
                raise AssertionError(f"{mode}: malformed prediction {p}")
        for k in names:
            main_launches[k] += launches[k]
        add_shapes(res[mode])
        print(f"main path [one-shot {mode}] mt-product random weights, "
              f"{len(preds)} queries: wall {res[mode]['wall_s']:.3f} s, "
              f"{res[mode]['wall_s'] / len(preds) * 1e3:.2f} ms/query, "
              f"n_calls {[p.n_calls for p in preds]}, acceptance "
              f"{np.mean([p.acceptance_rate for p in preds]):.4f}, "
              f"launches {launches}", flush=True)

    # -- streaming: StreamingEngine on the paged cache, then one dense pass ----
    skw = dict(ekw, page_size=16)
    run_streaming(torch, ds, cfg, params, skw, queries,            # warm-up
                  {m: (n, 1) for m, (n, _) in STREAM_PLAN.items()},
                  paged=True)
    stream = run_streaming(torch, ds, cfg, params, skw, queries, STREAM_PLAN,
                           paged=True)
    stream_dense = run_streaming(
        torch, ds, cfg, params, skw, queries,
        {"speculative": STREAM_PLAN["speculative"]}, paged=False)
    for label, runs, paged in (("paged", stream, True),
                               ("dense", stream_dense, False)):
        for mode, r in runs.items():
            launches = r["launches"]
            read = "paged_decode_gqa" if paged else "decode_gqa"
            other = "decode_gqa" if paged else "paged_decode_gqa"
            if launches[read] == 0 or launches[other] != 0:
                raise AssertionError(f"streaming {label} {mode}: launches "
                                     f"{launches}")
            if mode in ("greedy", "speculative") and \
                    launches["draft_verify"] == 0:
                raise AssertionError(f"streaming {mode}: draft_verify was "
                                     f"never launched")
            check_encoder_launches(launches, f"streaming {label} {mode}")
            ref = res[mode]["preds"]
            for i, (smi, lp) in enumerate(zip(r["smiles"], r["logprobs"])):
                if smi != ref[i].smiles or not np.all(np.isfinite(lp)):
                    raise AssertionError(
                        f"streaming {label} {mode} query {i}: {smi} != "
                        f"one-shot {ref[i].smiles}")
                if mode in ("beam", "speculative_beam") and not np.allclose(
                        lp, ref[i].logprobs, atol=1e-4, rtol=1e-4):
                    raise AssertionError(f"streaming {mode} query {i}: "
                                         f"log-probs {lp} != {ref[i].logprobs}")
            for k in names:
                main_launches[k] += launches[k]
            add_shapes(r)
            fp = r["footprint"]
            pages = (f"peak pages {fp['peak_pages']} of {fp['n_pages'] - 1}"
                     if paged else "dense rows")
            n_q = len(r["smiles"])
            print(f"main path [streaming {label} {mode}] "
                  f"{STREAM_PLAN[mode][0]} slots, {n_q} queries: wall "
                  f"{r['wall_s']:.3f} s, {r['wall_s'] / n_q * 1e3:.2f} "
                  f"ms/request, steps {r['steps']}, {pages}, preemptions "
                  f"{r['preemptions']}, n_calls {r['n_calls']}, acceptance "
                  f"{r['accepted']:.4f}, launches {launches}", flush=True)
    print("streaming check: paged and dense StreamingEngine tokens == "
          "ReactionEngine tokens", flush=True)
    if args.profile:
        profile_modes(torch, ds, cfg, params, ekw, queries[:8], modes,
                      args.profile)
        profile_streaming(torch, ds, cfg, params, skw, queries, args.profile)

    # -- train: mt-product on synthetic reactions, then serve it --------------
    del params
    trainer, train = run_training(torch, train_ds)
    for k in names:
        main_launches[k] += train["launches"][k]
    if args.profile:
        profile_training(torch, trainer, train_ds, args.profile)
    trained = serve_trained(torch, train_ds.tokenizer, trainer.cfg,
                            trainer.params, test_ds)
    for r in trained.values():
        for k in names:
            main_launches[k] += r["launches"][k]
        add_shapes(r)
    # -- the serving surface: checkpoint, front door, reuse, tree, fleet -----
    surface = serve_surface(torch, trainer, train_ds.tokenizer, test_ds,
                            trained, Path(__file__).resolve().parent / "build")
    for r in surface.values():
        for k in names:
            main_launches[k] += r["launches"][k]
        add_shapes(r)
    # -- decoder-only: SmolLM-135M at full width ------------------------------
    from repro_torch.models import transformer as tr

    lm_params = tr.init(torch.Generator().manual_seed(SEED),
                        get_config(LM["arch"]), device="cuda")
    lm = serve_decoder(torch, lm_params)
    lm_launches = dict.fromkeys(names, 0)
    for r in lm.values():
        for k in names:
            main_launches[k] += r["launches"][k]
            lm_launches[k] += r["launches"][k]
        add_shapes(r)
    for k in ("decode_gqa", "paged_decode_gqa", "draft_verify"):
        if lm_launches[k] == 0:
            raise AssertionError(f"decoder-only phase: {k} was never "
                                 f"launched ({lm_launches})")
    print(f"decoder-only phase launches: {lm_launches}", flush=True)
    # -- prefix sharing and multi-draft, SmolLM-135M at full width -----------
    for phase, runs, needed in (
            ("prefix sharing", serve_prefix_sharing(torch, lm_params),
             ("paged_decode_gqa", "draft_verify")),
            ("multi-draft", serve_multidraft(torch, lm_params),
             ("decode_gqa", "draft_verify"))):
        counts = dict.fromkeys(names, 0)
        for r in runs.values():
            if "launches" not in r:
                continue
            for k in names:
                main_launches[k] += r["launches"][k]
                counts[k] += r["launches"][k]
            add_shapes(r)
        if any(counts[k] == 0 for k in needed):
            raise AssertionError(f"{phase} phase: launches {counts}")
        print(f"{phase} phase launches: {counts}", flush=True)
    # -- the MoE and recurrent families ---------------------------------------
    # an engine's scheduler hooks close over it (a reference cycle), so a
    # phase's weights are freed by the cycle collector, not on return
    del lm_params
    gc.collect()
    torch.cuda.empty_cache()
    for phase, serve, needed in (
            ("MoE", serve_moe,
             ("decode_gqa", "paged_decode_gqa", "draft_verify")),
            ("recurrent", serve_rwkv, ("draft_verify",)),
            ("reduced families", serve_reduced_families,
             ("paged_decode_gqa", "draft_verify"))):
        runs = serve(torch)
        gc.collect()
        torch.cuda.empty_cache()
        counts = dict.fromkeys(names, 0)
        for r in runs.values():
            for k in names:
                main_launches[k] += r["launches"][k]
                counts[k] += r["launches"][k]
            add_shapes(r)
        if any(counts[k] == 0 for k in needed):
            raise AssertionError(f"{phase} phase: launches {counts}")
        print(f"{phase} phase launches: {counts}", flush=True)
    # -- decoder-only training, the audio encoder and the VLM ----------------
    for phase, serve, needed in (
            ("lm train", lambda t: train_lm(t, train_ds, test_ds),
             ("flash_attention", "flash_attention_bwd", "paged_decode_gqa",
              "draft_verify")),
            ("hubert", train_hubert,
             ("flash_attention", "flash_attention_bwd")),
            ("vlm", serve_vlm,
             ("flash_attention", "decode_gqa", "draft_verify"))):
        runs = serve(torch)
        gc.collect()
        torch.cuda.empty_cache()
        counts = dict.fromkeys(names, 0)
        for r in runs.values():
            for k in names:
                main_launches[k] += r["launches"][k]
                counts[k] += r["launches"][k]
            add_shapes(r)
        if any(counts[k] == 0 for k in needed):
            raise AssertionError(f"{phase} phase: launches {counts}")
        print(f"{phase} phase launches: {counts}", flush=True)
    # -- reference: the card against the CPU's plain path, tiny model ----------
    tcfg = tiny_config(vocab, depth=2, d_model=64)
    cpu_params = s2s.init(torch.Generator().manual_seed(SEED + 2), tcfg,
                          device="cpu")
    tkw = dict(draft_len=6, n_drafts=8, n_beams=3, max_new=24, max_src=64)
    on_gpu = run_engine(torch, ds, tcfg, cpu_params, tkw, queries[:4], modes)
    on_cpu = run_engine(torch, ds, tcfg, cpu_params, tkw, queries[:4], modes,
                        device="cpu")
    for mode in modes:
        for pg, pc in zip(on_gpu[mode]["preds"], on_cpu[mode]["preds"]):
            same = (pg.smiles == pc.smiles and pg.n_calls == pc.n_calls
                    and np.allclose(pg.logprobs, pc.logprobs, atol=1e-4,
                                    rtol=1e-4))
            if not same:
                raise AssertionError(f"{mode}: card {pg} != cpu {pc}")
    tplan = {"greedy": (2, 4), "speculative": (2, 4), "beam": (2, 2),
             "speculative_beam": (2, 2)}
    tskw = dict(tkw, page_size=8)
    st_gpu = run_streaming(torch, ds, tcfg, cpu_params, tskw, queries, tplan,
                           paged=True)
    st_cpu = run_streaming(torch, ds, tcfg, cpu_params, tskw, queries, tplan,
                           paged=True, device="cpu")
    for mode in modes:
        a, b = st_gpu[mode], st_cpu[mode]
        if a["smiles"] != b["smiles"] or a["n_calls"] != b["n_calls"] or \
                not all(np.allclose(x, y, atol=1e-4, rtol=1e-4)
                        for x, y in zip(a["logprobs"], b["logprobs"])):
            raise AssertionError(f"streaming {mode}: card {a['smiles']} != "
                                 f"cpu {b['smiles']}")
    print("reference check: tiny model, card == CPU plain path in all four "
          "modes, one-shot and paged streaming", flush=True)
    # draft_len 32: T 33 fed positions, past one warp's 32 lanes
    dkw = dict(tskw, draft_len=32, max_new=40)
    dl32 = {dev: run_streaming(torch, ds, tcfg, cpu_params, dkw, queries,
                               {"speculative": (2, 4)}, paged=True,
                               device=dev)["speculative"]
            for dev in ("cuda", "cpu")}
    a, b = dl32["cuda"], dl32["cpu"]
    if a["smiles"] != b["smiles"] or a["n_calls"] != b["n_calls"] or \
            not all(np.allclose(x, y, atol=1e-4, rtol=1e-4)
                    for x, y in zip(a["logprobs"], b["logprobs"])):
        raise AssertionError(f"streaming draft_len 32: card {a['smiles']} "
                             f"!= cpu {b['smiles']}")
    if not any(k[1] == 33 for k in a["shapes"]):
        raise AssertionError(f"streaming draft_len 32: draft_verify shapes "
                             f"{a['shapes']}")
    print(f"reference check: tiny model, streaming speculative draft_len 32 "
          f"on the card == the CPU (draft_verify launches {a['shapes']}, "
          f"n_calls {a['n_calls']})", flush=True)
    check_train_step(torch, ds, tcfg, cpu_params)
    check_train_drift(torch, ds, tcfg, cpu_params)
    check_lm_train_steps(torch)

    # -- the mesh: 4 ranks of a (data 2, model 2) world on the one card -----
    mesh = serve_mesh(torch)
    for acc in mesh["per_rank"]:
        for k, n in acc.items():
            main_launches[k] += n
    add_shapes({"shapes": mesh["verify_shapes"]})
    if sum(main_shapes.values()) != main_launches["draft_verify"]:
        raise AssertionError(f"draft_verify shapes {main_shapes} do not add "
                             f"up to its {main_launches['draft_verify']} "
                             f"launches")
    print_verify_gaps(torch, kern["draft_verify"]["shapes"], main_shapes,
                      floor_ms, ab)


    sources = {"decode_gqa": ("src/repro_torch/csrc/decode_gqa.cu",
                              "src/repro/kernels/decode_gqa/kernel.py:72"),
               "draft_verify": ("src/repro_torch/csrc/draft_verify.cu",
                                "src/repro/kernels/draft_verify/kernel.py:61"),
               "paged_decode_gqa": (
                   "src/repro_torch/csrc/paged_decode_gqa.cu",
                   "src/repro/kernels/decode_gqa/kernel.py:160"),
               # the backward extends the same TPU kernel (JAX has none)
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention/"
                                   "kernel.py:69"),
               "flash_attention_bwd": (
                   "src/repro_torch/csrc/flash_attention_bwd.cu",
                   "src/repro/kernels/flash_attention/kernel.py:69")}
    entries = []
    for name, (src, replaces) in sources.items():
        shapes = kern[name]["shapes"]
        main_shape = ("train_encoder" if name.startswith("flash")
                      else "speculative")
        m = shapes[main_shape]
        entries.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            check="passed", launches=main_launches[name],
            max_abs_err=kern[name]["max_abs_err"], ms=m["ms"],
            plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=m["library_ms"],
            shape=m["shape"],
            other_shapes={k: {f: v[f] for f in ("shape", "ms", "plain_ms",
                                                "library_ms", "bound_ms",
                                                "bound_by")}
                          for k, v in shapes.items() if k != main_shape}))
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
