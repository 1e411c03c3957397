"""Multi-pod dry run: plan every (architecture x input shape) on the
production mesh with meta tensors (nothing allocated) and record memory,
cost and collectives per card: the port of ``repro.launch.dryrun``.

The JAX package lowers and compiles each pair on 512 placeholder devices.
The port has no compiler to ask: it runs rank 0's step on meta tensors at
full size (the proof that every op takes the full shapes), then counts the
step at 1 and 2 pattern repeats (``launch.hlo_analysis.count_cost``, the
collectives from a recording ``TensorParallel`` and the FSDP specs) and
extrapolates to full depth, as JAX's dry run extrapolates its unrolled
compiles. Runs on the CPU; needs no card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod
  ... [--seq-shard] [--no-fsdp] [--verify-tokens 11 [--multidraft 5]]
      [--out results.jsonl]

``--seq-shard`` plans every run under ``sharding.ctx.activation_rules(
mesh, batch=("data",), seq=("model",))``, as JAX's ``_lower_compile``
wraps its lowering: the decoder-only residual stream is split along T over
the model axis where the axis divides T (train_4k, prefill_32k), the
remat-saved carries a rank keeps are its T / 16 positions, and the
recorder counts the gathers and reduce-scatters along T.

A record holds JAX's keys. Exact for the step the port runs: the
parameter counts, ``model_flops_total`` and the memory of the arguments
and outputs (the per-card shard sizes of the specs). Counted on the meta
run: the aten ops' flops (``torch.utils.flop_counter``) and bytes, and the
layers' collectives. Upper bounds: the kernels' work (every cache slot
visible), and where a head does not divide the model axis the rank runs
it whole, as a serving rank does. An estimate: ``temp_bytes``, the peak
of the intermediates alive at once by tensor lifetimes. An undercount:
the token loop of a recurrent mixer (Mamba's scan, RWKV's WKV) runs two
steps in a dry run (``short_recurrences``), so a recurrent family's
prefill and train terms count the loop's work for 2 of T tokens, as XLA's
cost analysis counts a rolled loop's body once.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback

@contextlib.contextmanager
def short_recurrences(steps: int = 2):
    """For as long as it is open, each recurrent mixer's loop over time
    (``models.mamba._recurrence``, ``models.rwkv._wkv_recurrence``) runs
    its first ``steps`` tokens only, the last output standing for the
    rest: every step has the same shapes, so a meta run keeps every
    output's shape without a Python loop over 32,768 tokens. Two steps,
    so the decay reaches an output and a backward reaches every weight."""
    import torch

    from repro_torch.models import mamba, rwkv

    def pad(y, T):
        n = y.shape[1]
        if n == T:
            return y
        return torch.cat([y, y[:, -1:].expand(-1, T - n, *y.shape[2:])], 1)

    scan, wkv = mamba._recurrence, rwkv._wkv_recurrence

    def short_scan(a, b, C):
        y, h = scan(a[:, :steps], b[:, :steps], C[:, :steps])
        return pad(y, a.shape[1]), h

    def short_wkv(r, k, v, decay, u, S, states_out=None):
        o, S = wkv(r[:, :steps], k[:, :steps], v[:, :steps],
                   decay[:, :steps], u, S,
                   None if states_out is None else states_out[:, :steps])
        return pad(o, r.shape[1]), S

    mamba._recurrence, rwkv._wkv_recurrence = short_scan, short_wkv
    try:
        yield
    finally:
        mamba._recurrence, rwkv._wkv_recurrence = scan, wkv


def run_one(arch: str, shape: str, *, multi_pod: bool,
            seq_shard: bool = False, fsdp_inference: bool = True,
            verify_tokens: int = 0, multidraft: int = 0,
            verbose: bool = True) -> dict:
    """Plan one (arch x shape x mesh) pair and derive its roofline terms.

    1. The full model at rank 0's local widths runs once on meta: the
       proof that the step takes the full shapes (``compile_s``).
    2. Flops, bytes accessed, collective bytes and the live intermediates'
       peak come from counted meta runs at 1 and 2 pattern repeats,
       extrapolated: term(R) = t1 + (R-1)·(t2-t1). Everything outside the
       layers (embedding, logits, loss, optimizer) does not depend on
       depth, so the extrapolation is exact for these repeated blocks.
    """
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.hlo_analysis import (
        HBM_BW, NVLINK_BW, collective_bytes, count_cost, model_flops,
        peak_flops)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import ctx, rules

    rec: dict = {"arch": arch, "shape": shape,
                 "mesh": "2x16x16" if multi_pod else "16x16",
                 "seq_shard": seq_shard, "fsdp_inference": fsdp_inference,
                 "verify_tokens": verify_tokens, "multidraft": multidraft}
    reason = steps_mod.skip_reason(arch, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    dtype = torch.bfloat16
    cfg = (get_config(arch) if shape in steps_mod.MT_SHAPES
           else steps_mod._dryrun_cfg(arch, shape))
    kw = dict(fsdp_inference=fsdp_inference, verify_tokens=verify_tokens,
              multidraft=multidraft)

    def ruled():
        """JAX's activation rules, the sequence split with ``seq_shard``."""
        return ctx.activation_rules(mesh, batch=("data",),
                                    seq=("model",) if seq_shard else None)

    def measure(repeats: int) -> dict:
        """Counted run at ``repeats`` pattern repeats."""
        if cfg.family == "seq2seq":
            cfg_r = dataclasses.replace(cfg, n_layers=repeats,
                                        n_encoder_layers=repeats)
        else:
            cfg_r = dataclasses.replace(
                cfg, n_layers=repeats * len(cfg.layer_pattern))
        with ruled():
            b = steps_mod.build_step(arch, shape, mesh, dtype=dtype,
                                     cfg_override=cfg_r, **kw)
            cost, _ = count_cost(b.fn, *b.local_inputs)
        records = list(b.fsdp_records) + (b.tp.records if b.tp else [])
        return {"flops": cost["flops"], "bytes": cost["bytes accessed"],
                "coll": collective_bytes(records)["total"],
                "temp": cost["temp_bytes"]}

    t0 = time.time()
    try:
        with short_recurrences():
            # -- 1. the full model on meta: the proof -----------------------
            with ruled():
                built = steps_mod.build_step(arch, shape, mesh, dtype=dtype,
                                             **kw)
                rec["note"] = built.note
                built.fn(*built.local_inputs)
            t_full = time.time() - t0
            # -- 2. counted runs at 1 and 2 repeats, extrapolated -----------
            m1 = measure(1)
            m2 = measure(2)
        R = cfg.n_repeats
        extrap = {k: m1[k] + (R - 1) * (m2[k] - m1[k]) for k in m1}
    except Exception as e:  # a failure here is a fault of the port
        rec["status"] = "FAILED"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        return rec

    terms = {
        "flops_per_device": extrap["flops"],
        "bytes_per_device": extrap["bytes"],
        "collective_bytes_per_device": extrap["coll"],
        "compute_s": extrap["flops"] / peak_flops(dtype),
        "memory_s": extrap["bytes"] / HBM_BW,
        "collective_s": extrap["coll"] / NVLINK_BW,
    }
    terms["bottleneck"] = max(
        ("compute_s", "memory_s", "collective_s"),
        key=lambda k: terms[k]).replace("_s", "")

    # MODEL_FLOPS = 6·N·D / 2·N·D with MoE discount, from the param specs
    sizes = []
    rules.tree_map_with_path(lambda path, t: sizes.append(
        (t.numel(), "experts" in rules.path_names(path))), built.inputs[0])
    total = sum(n for n, _ in sizes)
    expert = sum(n for n, e in sizes if e)
    meta = steps_mod.SHAPES.get(shape) or steps_mod.MT_SHAPES[shape]
    per_row = (meta["seq"] if meta["kind"] in ("train", "prefill", "mt_train")
               else meta.get("verify", 1))
    tokens = meta["batch"] * per_row
    mf = model_flops(cfg, total, expert, tokens=tokens,
                     train=meta["kind"] == "train",
                     top_k=cfg.moe.top_k if cfg.moe else 0,
                     n_experts=cfg.moe.n_experts if cfg.moe else 0)
    chips = 1
    for n in rules.axis_sizes(mesh).values():
        chips *= n
    hlo_total_flops = terms["flops_per_device"] * chips
    args_b = steps_mod.shard_bytes(built.inputs, built.in_shardings, mesh)
    out_b = steps_mod.shard_bytes(built.outputs, built.out_shardings, mesh)
    temp_b = int(extrap["temp"])
    rec.update({
        "status": "ok",
        "compile_s": round(t_full, 2),
        "params_total": total,
        "params_expert": expert,
        "memory": {
            "argument_bytes": args_b,
            "output_bytes": out_b,
            "temp_bytes": temp_b,
            "peak_est_bytes": args_b + out_b + temp_b,
        },
        "roofline": terms,
        "model_flops_total": mf,
        "hlo_flops_total": hlo_total_flops,
        "useful_flops_ratio": (mf / hlo_total_flops) if hlo_total_flops
        else 0.0,
    })
    if verbose:
        print(f"[{arch} × {shape} × {rec['mesh']}"
              f"{' × seq_shard' if seq_shard else ''}] ok "
              f"compile={t_full:.1f}s "
              f"compute={terms['compute_s']:.3e}s "
              f"memory={terms['memory_s']:.3e}s "
              f"collective={terms['collective_s']:.3e}s "
              f"bottleneck={terms['bottleneck']} "
              f"useful={rec['useful_flops_ratio']:.2f}", flush=True)
        print("  memory_analysis:", rec["memory"], flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="architecture id or 'all'")
    ap.add_argument("--shape", required=True,
                    help="input-shape id or 'all'")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2×16×16 (512 cards) instead of 16×16 (256)")
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-parallel residual stream: split along T "
                         "over the model axis where it divides T")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="tensor-parallel-only params for prefill/decode "
                         "(no per-step FSDP gather)")
    ap.add_argument("--verify-tokens", type=int, default=0,
                    help="plan the speculative verify step with this many "
                         "fed tokens (DL+1) instead of the 1-token serve "
                         "step")
    ap.add_argument("--multidraft", type=int, default=0,
                    help="with --verify-tokens: single-pass N_d-draft "
                         "verification instead of the expanded-batch form")
    ap.add_argument("--out", default="",
                    help="append JSONL records to this file")
    args = ap.parse_args(argv)

    from repro_torch.configs import list_archs
    from repro_torch.launch.steps import SHAPES

    archs = ([a for a in list_archs() if not a.startswith("mt-")]
             if args.arch == "all" else [args.arch])
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]

    failures = 0
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            rec = run_one(arch, shape, multi_pod=args.multi_pod,
                          seq_shard=args.seq_shard,
                          fsdp_inference=not args.no_fsdp,
                          verify_tokens=args.verify_tokens,
                          multidraft=args.multidraft)
            if rec["status"] == "FAILED":
                failures += 1
                print(f"[{arch} × {shape}] FAILED: {rec['error']}\n"
                      f"{rec['traceback']}", flush=True)
            elif rec["status"] == "skipped":
                print(f"[{arch} × {shape}] skipped: {rec['reason']}",
                      flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    print(f"dry run: {len(archs) * len(shapes)} pairs in "
          f"{time.time() - t0:.1f} s, {failures} failed", flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run failures")


if __name__ == "__main__":
    main()
