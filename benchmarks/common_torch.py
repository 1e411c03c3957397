"""Shared benchmark substrate for the PyTorch port: one trained toy
Molecular Transformer on the synthetic reaction corpus, cached on disk, as
``benchmarks/common.py`` keeps it for the JAX package (same corpus, config,
optimiser and schedule), trained through ``repro_torch``'s ``Trainer``.

The cache is written by ``repro_torch.checkpoint`` in the JAX package's
file layout, so either package reads the other's weights. Runs on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os

import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.mt import tiny_config
from repro_torch.data import SyntheticReactionDataset, batched_dataset
from repro_torch.device import resolve_device
from repro_torch.models import seq2seq as s2s
from repro_torch.training import Trainer, make_seq2seq_train_step

CACHE = os.path.join(os.path.dirname(__file__), ".bench_mt_torch_{}.msgpack")
MAX_LEN = 96
N_TRAIN = 512
N_TEST = 64
BATCH = 24
LR = 1e-3


def datasets(direction: str = "forward"):
    train = SyntheticReactionDataset(N_TRAIN, seed=0, direction=direction)
    test = SyntheticReactionDataset(N_TEST, seed=10_000, direction=direction)
    return train, test


def model_config(vocab_size: int):
    return tiny_config(vocab_size, depth=2, d_model=128, max_len=2 * MAX_LEN)


def trained_model(epochs: int = 20, verbose: bool = False,
                  direction: str = "forward", *, device=None, params=None,
                  cache: str | None = None):
    """(cfg, params, train_ds, test_ds), cached across runs at ``cache``
    (default ``benchmarks/.bench_mt_torch_{direction}.msgpack``).

    direction='forward' = product prediction (paper Tables 1/2);
    direction='retro'   = single-step retrosynthesis (paper Tables 3/4).
    ``params``: the initial weights (default: ``seq2seq.init`` from a CPU
    generator seeded 0). A cache that does not fit the config is removed
    and the model trained again."""
    dev = resolve_device(device)
    train_ds, test_ds = datasets(direction)
    cfg = model_config(train_ds.tokenizer.vocab_size)
    path = cache or CACHE.format(direction)
    if params is None:
        params = s2s.init(torch.Generator().manual_seed(0), cfg, device=dev)
    if os.path.exists(path):
        try:
            loaded = load_checkpoint(path, params_like=params, device=dev)
            return cfg, loaded["params"], train_ds, test_ds
        except ValueError:
            os.remove(path)   # stale cache from an older config
    step = make_seq2seq_train_step(cfg, lr=LR, label_smoothing=0.0)
    trainer = Trainer(cfg, params, step, device=dev)

    def batches():
        for _ in range(epochs):
            yield from batched_dataset(train_ds.tokenizer, train_ds.pairs(),
                                       BATCH, MAX_LEN, MAX_LEN)

    trainer.fit(batches(), log_every=100, verbose=verbose)
    save_checkpoint(path, params=trainer.params)
    return cfg, trainer.params, train_ds, test_ds


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"
