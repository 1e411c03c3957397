"""The paper's technique on a decoder-only LM with the PyTorch port:
prompt-lookup speculative decoding (the decoder-only analogue of
source-copy drafting) on the SmolLM-family reduced config, with
recurrent-state rollback shown on RWKV6 as well. The counterpart of
``examples/speculative_lm.py``; runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/speculative_lm_torch.py [arch] [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (greedy_decode, prompt_lookup_drafts,
                              speculative_greedy_decode, transformer_handle)
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr

B, P, MAX_NEW, DL, ND = 2, 24, 48, 6, 12


def run(arch: str = "smollm-135m", *, device=None, params=None,
        prompt=None) -> dict:
    """Greedy and speculative decoding of ``prompt`` ((B, P) int32; default
    from ``np.random.default_rng(0)``) on ``arch``'s reduced config with
    ``params`` (default: ``init`` from a CPU generator seeded 0)."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=True)
    if params is None:
        params = tr.init(torch.Generator().manual_seed(0), cfg, device=dev)
    if prompt is None:
        prompt = np.random.default_rng(0).integers(
            4, cfg.vocab_size, (B, P)).astype(np.int32)
    handle = transformer_handle(params, cfg)
    prompt_t = torch.as_tensor(prompt, device=dev)

    def fresh_cache():
        c = tr.init_cache(cfg, B, max_len=P + MAX_NEW + DL + 4, device=dev)
        _, c = tr.prefill(params, cfg, c, prompt_t[:, : P - 1])
        return c

    last = prompt_t[:, P - 1]
    pos = torch.full((B,), P - 1, dtype=torch.int32, device=dev)
    g = greedy_decode(handle, fresh_cache(), last, pos, max_new=MAX_NEW,
                      eos_id=2)
    ds, ms = zip(*(prompt_lookup_drafts(np.asarray(r), DL, ND)
                   for r in prompt))
    s = speculative_greedy_decode(
        handle, fresh_cache(), last, pos,
        torch.as_tensor(np.stack(ds), device=dev),
        torch.as_tensor(np.stack(ms), device=dev),
        max_new=MAX_NEW, eos_id=2)
    return dict(cfg=cfg, greedy=g, speculative=s,
                identical=bool((g.tokens == s.tokens).all()))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="smollm-135m")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, reduced=True)
    print(f"arch={cfg.name} family={cfg.family} "
          f"pattern={cfg.layer_pattern}")
    out = run(args.arch, device=args.device)
    g, s = out["greedy"], out["speculative"]
    print(f"greedy calls      : {int(g.n_calls)}")
    print(f"speculative calls : {int(s.n_calls)} "
          f"(acceptance={float(s.acceptance_rate.mean()):.2f})")
    print(f"outputs identical : {out['identical']}")
    if cfg.family in ("ssm", "hybrid"):
        print("note: recurrent architecture — verification used per-step "
              "state checkpoints and rollback (DESIGN.md §4)")
    return out


if __name__ == "__main__":
    main()
