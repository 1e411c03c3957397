"""The plain trainer that makes each configuration's weights: teacher-forced
cross-entropy over a synthetic corpus, Adam with a linear warm-up, on the
card with deterministic algorithms, so one recipe gives the same weights
every time. Imports nothing of the program.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch
import torch.nn.functional as F

from . import model, synthetic


def corpus_tensors(tok, pairs, device):
    """(src, tgt_in, tgt_out) int64 on ``device``, padded to the corpus's
    longest: src [tok.. eos], tgt_in [bos tok..], tgt_out [tok.. eos]; and
    each row's source and target lengths on the host."""
    srcs = [tok.encode(s, add_eos=True) for s, _ in pairs]
    tgts = [tok.encode(t) for _, t in pairs]
    src = model.pad_rows(srcs, "cpu")
    tgt_in = model.pad_rows([[tok.bos_id] + t for t in tgts], "cpu")
    tgt_out = model.pad_rows([t + [tok.eos_id] for t in tgts], "cpu")
    lens = (np.array([len(s) for s in srcs]),
            np.array([len(t) + 1 for t in tgts]))
    return src.to(device), tgt_in.to(device), tgt_out.to(device), lens


def train(cfg: dict, recipe: dict, task: str, device, log=print) -> dict:
    """Weights trained by ``recipe`` (corpus size and seed, init seed, batch
    seed, batch, steps, learning rate, warm-up, Adam's betas and eps, TF32)
    on ``task``. Batches are drawn on the host, so no step waits for the
    card. Returns ``{"weights", "losses", "seconds", "train_sources"}``."""
    tok = synthetic.tokenizer()
    pairs = synthetic.pairs(recipe["corpus"], recipe["corpus_seed"], task)
    src, tgt_in, tgt_out, (src_len, tgt_len) = corpus_tensors(tok, pairs,
                                                              device)
    w = model.init(cfg, recipe["init_seed"], device)
    params = [w[k].requires_grad_() for k in w]
    opt = torch.optim.Adam(params, lr=recipe["lr"],
                           betas=tuple(recipe["betas"]), eps=recipe["eps"])
    warm = recipe["warmup"]
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda s: min(1.0, (s + 1) / warm))
    rng = np.random.default_rng(recipe["batch_seed"])
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    losses = []
    t0 = time.perf_counter()
    try:
        with model.precision(bool(recipe["tf32"])):
            for step in range(recipe["steps"]):
                idx = rng.integers(0, len(pairs), recipe["batch"])
                n_s, n_t = int(src_len[idx].max()), int(tgt_len[idx].max())
                rows = torch.from_numpy(idx).to(device)
                s = src[rows, :n_s]
                ti, to = tgt_in[rows, :n_t], tgt_out[rows, :n_t]
                logits = model.forward(w, cfg, s, ti)
                loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                       to.reshape(-1), ignore_index=0)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                sched.step()
                if step % recipe["log_every"] == 0 or step == recipe["steps"] - 1:
                    losses.append((step, float(loss.detach())))
                    log(f"train step {step} loss {losses[-1][1]:.4f}")
    finally:
        torch.use_deterministic_algorithms(deterministic)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return {"weights": {k: v.detach() for k, v in w.items()},
            "losses": losses, "seconds": time.perf_counter() - t0,
            "train_sources": sorted({s for s, _ in pairs})}


def weights_hash(w: dict) -> str:
    """sha256 over every weight's name, shape and float32 bytes."""
    h = hashlib.sha256()
    for k in sorted(w):
        t = w[k].detach().to("cpu", torch.float32).contiguous()
        h.update(k.encode() + str(tuple(t.shape)).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()
