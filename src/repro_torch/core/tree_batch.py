"""Batch-row helpers for draft-expanded caches, dense and paged (the port of
``repro.core.tree_batch``).

Cache leaves store batch on axis 1 (axis 0 is the layer axis) in dicts
(the seq2seq cache, and a recurrent position's state or per-step
checkpoints, (R, B, ...) or (R, B, T+1, ...)) or tuples (the decoder-only
cache), so the
paper's effective-batch inflation (B -> B*N_d), the post-verification winner
sync and the beam reorder are maps over axis 1 of every leaf. Each returns
new tensors; the inputs are left as they were.

``PagedKVCache`` nodes are special-cased: the page pool carries no batch
axis, so batch-row ops touch only the per-row block tables. The beam
reorder (``gather_rows``) and the speculative winner sync (``sync_winner``)
then become int32 table gathers instead of K/V copies; page contents are
shared by aliasing, and the page planner restores private ownership of the
write-window pages before the next step (``repro_torch.core.session``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.attention import KVCache, PagedKVCache


def _paged_map(fn, cache):
    """Apply ``fn`` to every tensor leaf; paged nodes apply it to their
    block tables only (the pool has no batch axis to operate on)."""
    if isinstance(cache, dict):
        return {k: _paged_map(fn, v) for k, v in cache.items()}
    if isinstance(cache, tuple):
        return tuple(_paged_map(fn, v) for v in cache)
    if isinstance(cache, PagedKVCache):
        return dataclasses.replace(cache, block_tables=fn(cache.block_tables))
    if isinstance(cache, KVCache):
        return KVCache(**{f.name: fn(getattr(cache, f.name))
                          for f in dataclasses.fields(cache)})
    return fn(cache)


def _zip_map(fn, full, part):
    """``fn(full_leaf, part_leaf)`` over two caches of the same structure,
    paged nodes passed whole."""
    if isinstance(full, dict):
        return {k: _zip_map(fn, full[k], part[k]) for k in full}
    if isinstance(full, tuple):
        return tuple(_zip_map(fn, f, p) for f, p in zip(full, part))
    if isinstance(full, KVCache):
        return KVCache(**{f.name: fn(getattr(full, f.name),
                                     getattr(part, f.name))
                          for f in dataclasses.fields(full)})
    return fn(full, part)


def expand_batch(cache, n: int):
    """Tile batch axis 1: (R, B, ...) -> (R, B*n, ...), row b repeated n
    times with the copies adjacent (``jnp.repeat``, not ``Tensor.repeat``)."""
    return _paged_map(lambda a: torch.repeat_interleave(a, n, dim=1), cache)


def sync_winner(cache, best_idx: torch.Tensor, n: int):
    """After verification: copy the winning draft row of each sequence to all
    its n rows. best_idx: (B,) winner draft index per sequence. Paged nodes
    alias the winner's pages by copying its block table."""
    if n == 1:
        return cache

    def one(a):
        R, Bn = a.shape[:2]
        B = Bn // n
        src = (torch.arange(B, device=a.device) * n
               + best_idx.to(a.device).long())
        return torch.repeat_interleave(a[:, src], n, dim=1)

    return _paged_map(one, cache)


def gather_rows(cache, src_rows: torch.Tensor):
    """Reorder batch rows: new_row[i] = old_row[src_rows[i]] (axis 1)."""
    return _paged_map(lambda a: a.index_select(1, src_rows.to(a.device).long()),
                      cache)


def slice_rows(cache, lo: int, hi: int):
    """Batch-row slice ``[lo, hi)`` on axis 1: the per-group view a grouped
    session step operates on. Dense leaves are views (the step's in-place
    cache writes land in the full cache); paged nodes slice only their block
    tables and share the one pool."""
    return _paged_map(lambda a: a[:, lo:hi], cache)


def _put(full, rows, sub):
    """``full[:, rows] = sub`` unless ``sub`` is already that very view."""
    dst = full[:, rows]
    if not (dst.data_ptr() == sub.data_ptr() and dst.stride() == sub.stride()
            and dst.shape == sub.shape):
        dst.copy_(sub)


def merge_rows(cache, part, lo: int, hi: int):
    """Write a group's stepped sub-cache (``slice_rows(cache, lo, hi)`` after
    a session step) back into the full cache, in place. Dense leaves copy
    their row slice (nothing when the step left the view in place); paged
    nodes write their block-table rows (the step's pool writes already went
    to the shared pool, onto pages only the group's rows own)."""

    def one(full, sub):
        if isinstance(full, PagedKVCache):
            _put(full.block_tables, slice(lo, hi), sub.block_tables)
        else:
            _put(full, slice(lo, hi), sub)
        return full

    return _zip_map(one, cache, part)


def take_rows(cache, rows):
    """Gather a list of batch rows (axis 1) into a compact sub-cache; paged
    nodes gather only their block-table rows."""
    idx = torch.as_tensor(rows, dtype=torch.long)
    return _paged_map(lambda a: a.index_select(1, idx.to(a.device)), cache)


def put_rows(cache, sub, rows):
    """Write a ``take_rows`` sub-cache back after a model step, in place.
    Dense leaves scatter their rows; paged nodes keep the full block tables
    (a decode step writes pages, never tables)."""
    idx = torch.as_tensor(rows, dtype=torch.long)

    def one(full, s):
        if not isinstance(full, PagedKVCache):
            full[:, idx.to(full.device)] = s.to(full.dtype)
        return full

    return _zip_map(one, cache, sub)


def strided_rows(cache, start: int, step: int, n: int):
    """Batch rows ``start, start + step, ...`` (``n`` of them) on axis 1 as
    views: a decode step's in-place cache writes through them land in the
    full cache. Paged nodes take only their block-table rows."""
    return _paged_map(lambda a: a[:, start:start + step * (n - 1) + 1:step],
                      cache)


def dynamic_slice_rows(cache, start, n: int):
    """Batch-row slice ``[start, start + n)`` on axis 1 with a tensor or int
    ``start``; paged nodes slice only their block tables."""
    s = int(start)
    return slice_rows(cache, s, s + n)


def dynamic_merge_rows(cache, sub, start):
    """Write a ``dynamic_slice_rows`` sub-cache back after a model step, in
    place: dense leaves copy their row slice at ``start``; paged nodes keep
    the full block tables (a decode step writes pages, never tables)."""
    s = int(start)

    def one(full, part):
        if not isinstance(full, PagedKVCache):
            _put(full, slice(s, s + part.shape[1]), part.to(full.dtype))
        return full

    return _zip_map(one, cache, sub)


def set_rows(cache, rows: torch.Tensor, values):
    """Scatter ``values`` into batch rows ``rows`` (axis 1), in place: the
    continuous-batching admission path. ``rows`` is an index of any shape
    (admission's is (queries, rows a slot)); ``values`` leaves broadcast
    against (R, *rows.shape, ...), so (R, 1 or len(rows), ...) for a flat
    ``rows`` and (R, queries, 1, ...) to give each query's row to all of
    its slot's rows."""
    idx = rows.long()

    def one(a, b):
        a[:, idx.to(a.device)] = b.to(device=a.device, dtype=a.dtype).expand(
            a.shape[0], *idx.shape, *a.shape[2:])
        return a

    return _zip_map(one, cache, values)
