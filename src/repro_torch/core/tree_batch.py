"""Batch-row helpers for draft-expanded dense caches (the dense half of
``repro.core.tree_batch``).

Cache leaves store batch on axis 1 (axis 0 is the layer axis), so the
paper's effective-batch inflation (B -> B*N_d), the post-verification winner
sync and the beam reorder are maps over axis 1 of every leaf. Each returns
new tensors; the inputs are left as they were.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.attention import KVCache


def _map(fn, cache):
    if isinstance(cache, dict):
        return {k: _map(fn, v) for k, v in cache.items()}
    if isinstance(cache, KVCache):
        return KVCache(**{f.name: fn(getattr(cache, f.name))
                          for f in dataclasses.fields(cache)})
    return fn(cache)


def expand_batch(cache, n: int):
    """Tile batch axis 1: (R, B, ...) -> (R, B*n, ...), row b repeated n
    times with the copies adjacent (``jnp.repeat``, not ``Tensor.repeat``)."""
    return _map(lambda a: torch.repeat_interleave(a, n, dim=1), cache)


def sync_winner(cache, best_idx: torch.Tensor, n: int):
    """After verification: copy the winning draft row of each sequence to all
    its n rows. best_idx: (B,) winner draft index per sequence."""
    if n == 1:
        return cache

    def one(a):
        R, Bn = a.shape[:2]
        B = Bn // n
        src = (torch.arange(B, device=a.device) * n
               + best_idx.to(a.device).long())
        return torch.repeat_interleave(a[:, src], n, dim=1)

    return _map(one, cache)


def gather_rows(cache, src_rows: torch.Tensor):
    """Reorder batch rows: new_row[i] = old_row[src_rows[i]] (axis 1)."""
    return _map(lambda a: a.index_select(1, src_rows.to(a.device).long()),
                cache)
