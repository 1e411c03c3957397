"""Quickstart with the PyTorch port: train a toy Molecular Transformer on
synthetic reactions and accelerate its inference with the paper's
speculative decoding. The counterpart of ``examples/quickstart.py``; runs
on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--epochs 18] [--queries 8]
"""

import argparse
import time

import torch

from repro_torch.configs.mt import tiny_config
from repro_torch.data import SyntheticReactionDataset, batched_dataset
from repro_torch.device import resolve_device
from repro_torch.models import seq2seq as s2s
from repro_torch.serving import EngineConfig, ReactionEngine
from repro_torch.training import Trainer, make_seq2seq_train_step

N_REACTIONS, BATCH, MAX_LEN = 384, 24, 96


def engine_configs() -> dict:
    """The two engines' configs: standard greedy and the paper's
    speculative greedy."""
    return {"greedy": EngineConfig(mode="greedy", max_new=72),
            "speculative": EngineConfig(mode="speculative", draft_len=10,
                                        n_drafts=24, max_new=72)}


def run(*, device=None, params=None, epochs: int = 18, n_queries: int = 8,
        verbose: bool = False) -> dict:
    """Train the tiny MT for ``epochs`` (from ``params``, default
    ``seq2seq.init`` from a CPU generator seeded 0), then predict the
    first ``n_queries`` sources one at a time with the greedy and the
    speculative engine, after one warm-up call each."""
    dev = resolve_device(device)
    # 1. data: synthetic reactions whose products share long substrings
    #    with the reactants, the property the paper's drafting exploits
    ds = SyntheticReactionDataset(N_REACTIONS, seed=0)
    cfg = tiny_config(ds.tokenizer.vocab_size, depth=2, d_model=128,
                      max_len=192)
    if params is None:
        params = s2s.init(torch.Generator().manual_seed(0), cfg, device=dev)
    # 2. train the Molecular Transformer
    trainer = Trainer(cfg, params, make_seq2seq_train_step(
        cfg, lr=1e-3, label_smoothing=0.0), device=dev)

    def batches():
        for _ in range(epochs):
            yield from batched_dataset(ds.tokenizer, ds.pairs(), BATCH,
                                       MAX_LEN, MAX_LEN)

    trainer.fit(batches(), log_every=96, verbose=verbose)
    # 3. serve: standard greedy vs the paper's speculative greedy
    queries = [ds.pair(i)[0] for i in range(n_queries)]
    engines = {mode: ReactionEngine(trainer.params, cfg, ds.tokenizer, ecfg,
                                    device=dev)
               for mode, ecfg in engine_configs().items()}
    for eng in engines.values():   # warm-up
        eng.predict(queries[:1])
    preds, walls = {}, {}
    for mode, eng in engines.items():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        preds[mode] = [eng.predict([q])[0] for q in queries]
        walls[mode] = time.perf_counter() - t0
    p_g, p_s = preds["greedy"], preds["speculative"]
    return dict(
        dataset=ds, cfg=cfg, params=trainer.params, history=trainer.history,
        queries=queries, greedy=p_g, speculative=p_s, walls=walls,
        calls={m: sum(p.n_calls for p in ps) for m, ps in preds.items()},
        acceptance=sum(p.acceptance_rate for p in p_s) / len(p_s),
        identical=all(a.smiles[0] == b.smiles[0] for a, b in zip(p_g, p_s)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    ap.add_argument("--epochs", type=int, default=18)
    ap.add_argument("--queries", type=int, default=8)
    args = ap.parse_args(argv)
    ds = SyntheticReactionDataset(N_REACTIONS, seed=0)
    print(f"dataset: {len(ds)} reactions, vocab={ds.tokenizer.vocab_size}")
    src, tgt = ds.pair(0)
    print(f"example:  {src}  >>  {tgt}\n")
    print("training ...")
    out = run(device=args.device, epochs=args.epochs,
              n_queries=args.queries, verbose=True)
    t_g, t_s = out["walls"]["greedy"], out["walls"]["speculative"]
    calls_g, calls_s = out["calls"]["greedy"], out["calls"]["speculative"]
    print(f"\ngreedy      : {t_g:.2f}s, {calls_g} decoder calls")
    print(f"speculative : {t_s:.2f}s, {calls_s} decoder calls "
          f"({calls_g / calls_s:.2f}x fewer), "
          f"acceptance={out['acceptance']:.2f}")
    print(f"outputs identical: {out['identical']}   <- the paper's "
          f"accuracy-neutrality")
    print(f"\nprediction for query 0: {out['speculative'][0].smiles[0]}")
    print(f"ground truth          : {ds.pair(0)[1]}")
    return out


if __name__ == "__main__":
    main()
