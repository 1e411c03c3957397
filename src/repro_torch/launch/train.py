"""Training launcher for the decoder-only architectures and the audio
encoder: the port of ``repro.launch.train``. It trains any arch on
synthetic batches through ``make_lm_train_step`` (the flash_attention
kernels forward and backward on the card), on the card unless ``--device
cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --reduced --steps 20 --batch 8 --seq 64 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.training.optimizer import adam_init, tree_leaves
from repro_torch.training.trainer import make_lm_train_step


def synthetic_batch(cfg, rng, batch: int, seq: int, *,
                    device=None) -> dict:
    """The JAX launcher's batch, drawn from the numpy ``rng`` in its order
    (the same numbers for the same ``rng``): frames and codebook labels for
    the audio encoder; tokens in [4, vocab) and a loss mask of ones
    otherwise, plus the VLM's memory. On the card unless ``device`` says
    otherwise."""
    device = resolve_device(device)
    if cfg.family == "audio":
        emb = rng.normal(size=(batch, seq, cfg.d_model)).astype(np.float32)
        labels = rng.integers(0, cfg.vocab_size, (batch, seq))
        return {"embeddings": torch.from_numpy(emb).to(device),
                "labels": torch.from_numpy(labels.astype(np.int32)).to(
                    device)}
    tokens = rng.integers(4, cfg.vocab_size, (batch, seq + 1))
    out = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(device),
           "loss_mask": torch.ones((batch, seq + 1), dtype=torch.float32,
                                   device=device)}
    if cfg.family == "vlm":
        mem = rng.normal(size=(batch, cfg.memory_tokens, cfg.memory_dim))
        out["memory"] = torch.from_numpy(mem.astype(np.float32)).to(device)
    return out


def train_loop(params, cfg, *, steps: int, batch: int, seq: int,
               lr: float = 3e-4, remat: bool = False, device=None) -> dict:
    """``steps`` steps of ``make_lm_train_step`` on ``synthetic_batch``es
    of ``np.random.default_rng(0)`` (the JAX launcher's), in place on
    ``params`` (leaves on ``device``). Prints the JAX launcher's line every
    tenth of the run. Returns each step's metrics (read to the host once,
    at the end), the params and optimizer state, the wall seconds and
    steps/s."""
    dev = resolve_device(device)
    opt = adam_init(params)
    step = make_lm_train_step(cfg, lr=lr, remat=remat)
    rng = np.random.default_rng(0)
    history = []
    t0 = time.time()
    for i in range(steps):
        b = synthetic_batch(cfg, rng, batch, seq, device=dev)
        params, opt, metrics = step(params, opt, b)
        history.append({k: v.detach() for k, v in metrics.items()})
        if i % max(1, steps // 10) == 0:
            print(f"step {i:4d} loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['token_accuracy']):.3f} "
                  f"({time.time() - t0:.1f}s)")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    return dict(history=[{k: float(v) for k, v in m.items()}
                         for m in history],
                params=params, opt=opt, wall_s=wall,
                steps_per_s=steps / wall if wall > 0 else float("inf"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"vocab={cfg.vocab_size}")
    # weights drawn on the device itself: a CUDA generator leaves no host
    # copy of a full-width model
    params = tr.init(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"params: {n_params/1e6:.2f}M")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = train_loop(params, cfg, steps=args.steps, batch=args.batch,
                     seq=args.seq, lr=args.lr, remat=args.remat, device=dev)
    print(f"done: {args.steps} steps in {out['wall_s']:.1f}s")
    print(f"steps/s: {out['steps_per_s']:.3f}")
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        print(f"peak memory: {out['peak_bytes'] / 1e9:.2f} GB")
    else:
        print("peak memory: not measured on the CPU")
    return out


if __name__ == "__main__":
    main()
