"""Launches of the hand-written CUDA kernels ``csrc/decode_gqa.cu`` (the
port of ``repro.kernels.decode_gqa.kernel.decode_gqa_kernel``) and
``csrc/paged_decode_gqa.cu`` (of ``paged_decode_gqa_kernel``), both on the
body of ``csrc/decode_attention.cuh``. They take tensors the wrappers in
``ops.py`` have already checked.

The Python around the launches decides three things from what it is
given, so the CPU tests can reach them: how many blocks share one (row, kv
head)'s keys (``plan_splits``), how many share its query rows
(``plan_groups``), and whether the kernel copies K/V by 16-byte
``cp.async`` or by plain loads (``vector_loads``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HD = 256       # the largest head_dim bucket of decode_attention.cuh
KEY_TILE = 32      # keys a warp takes per step; a split holds whole tiles
N_SMS = 132        # streaming multiprocessors of an H100 SXM
MIN_SPLIT_TILES = 4   # a split's least tiles: one step for each of 4 warps

_tickets: dict[torch.device, torch.Tensor] = {}


def plan_splits(B: int, Kv: int, n_keys: int, TG: int, hd: int) -> int:
    """Blocks per (row, kv head). One where the B*Kv blocks already cover
    the card's SMs, or where the row is short: a block's four warps take
    up to MIN_SPLIT_TILES key tiles at once, and a split adds the partial's
    write and the combine's read to the block's chain of round trips (at
    B 1, S 74 three splits were slower than one on the H100). Else enough
    splits to cover the SMs, each of at least MIN_SPLIT_TILES whole tiles,
    none empty. ``TG`` (query rows a block) and ``hd`` do not change the
    count at the port's sizes, where a block's time is its round trips."""
    del TG, hd
    tiles = max(1, -(-n_keys // KEY_TILE))
    blocks = B * Kv
    if blocks >= N_SMS or tiles < 2 * MIN_SPLIT_TILES:
        return 1
    n = min(tiles // MIN_SPLIT_TILES, -(-N_SMS // blocks))
    per = -(-tiles // n)          # tiles per split; no split left empty
    return -(-tiles // per)


ROW_PASS = 16            # query rows a tensor-core pass takes
Q_ROW_BYTES = 96 << 10   # shared memory one block's query rows may take
_HD_BUCKETS = (16, 32, 64, 128, 256)


def plan_groups(B: int, Kv: int, n_split: int, TG: int, hd: int,
                itemsize: int) -> tuple[int, int]:
    """(q_groups, group_rows): blocks that share one (row, kv head, split)'s
    T*G query rows, each taking ``group_rows`` of them in whole passes.
    One group of all TG rows where the grid already gives every SM two
    blocks or there is at most one pass; else enough groups for two
    blocks an SM, each at least one pass. Either way a group's rows, at
    the head-dim bucket's shared-memory pitch, fit ``Q_ROW_BYTES``."""
    bucket = next(b for b in _HD_BUCKETS if hd <= b)
    cap = max(ROW_PASS, Q_ROW_BYTES // ((bucket + 16 // itemsize) * itemsize)
              // ROW_PASS * ROW_PASS)
    passes = -(-TG // ROW_PASS)
    blocks = B * Kv * n_split
    n = 1 if blocks >= 2 * N_SMS else min(passes, -(-2 * N_SMS // blocks))
    n = max(n, -(-TG // cap))
    if n <= 1:
        return 1, TG
    rows = -(-passes // n) * ROW_PASS
    return -(-TG // rows), rows


def split_chunk(n_keys: int, n_split: int) -> int:
    """Keys per split block: whole tiles, the last split ragged."""
    tiles = max(1, -(-n_keys // KEY_TILE))
    return -(-tiles // n_split) * KEY_TILE


def vector_loads(hd: int, itemsize: int, ptrs, strides) -> bool:
    """True when the kernel may copy K/V rows in 16-byte chunks: a row of
    ``hd`` elements is whole chunks, and every base pointer and every
    stride (in elements) of the K and V tensors is a multiple of 16
    bytes. Else it takes plain loads."""
    if hd * itemsize % 16:
        return False
    return (all(p % 16 == 0 for p in ptrs)
            and all(s * itemsize % 16 == 0 for s in strides))


def _vec(k, v) -> int:
    return int(vector_loads(k.shape[-1], k.element_size(),
                            (k.data_ptr(), v.data_ptr()),
                            (*k.stride()[:3], *v.stride()[:3])))


def _scratch(device, B, Kv, TG, hd, n_split, q_groups):
    """Split partials (accumulators, then (max, sum) pairs) and the ticket
    counters (``_build.tickets``, one a (row, kv head, query group)), or
    NULLs when one block takes each (row, kv head)'s keys."""
    if n_split == 1:
        return None, 0, 0, 0
    rows = B * Kv * n_split * TG
    part = torch.empty(rows * (hd + 2), dtype=torch.float32, device=device)
    t = _build.tickets(_tickets, device, B * Kv * q_groups,
                       lambda n: torch.zeros(n, dtype=torch.int32,
                                             device=device))
    return (part, part.data_ptr(), part.data_ptr() + rows * hd * 4,
            t.data_ptr())


def decode_gqa_kernel(q, k_cache, v_cache, k_pos, q_pos, *, window: int = 0,
                      n_split: int | None = None) -> torch.Tensor:
    """q: (B, T, H, hd) contiguous; k/v_cache: (B, S, Kv, hd) with a
    contiguous last axis, read through their strides; k_pos: (B, S) and
    q_pos: (B, T) contiguous int32. ``n_split`` overrides ``plan_splits``
    (for measurements). Returns (B, T, H, hd) in q's dtype."""
    B, T, H, hd = q.shape
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    TG = T * (H // Kv)
    n = n_split or plan_splits(B, Kv, S, TG, hd)
    groups = plan_groups(B, Kv, n, TG, hd, q.element_size())
    out = torch.empty_like(q)
    keep, part, part_ml, tickets = _scratch(q.device, B, Kv, TG, hd, n,
                                            groups[0])
    fn = _build.load("decode_gqa")
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             k_pos.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
             part, part_ml, tickets, B, T, H, Kv, S, hd,
             *k_cache.stride()[:3], *v_cache.stride()[:3],
             window, 1.0 / math.sqrt(hd), n, split_chunk(S, n), *groups,
             _vec(k_cache, v_cache), _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_gqa", err)
    del keep   # reused by the caching allocator only for later work on this stream
    return out


def paged_decode_gqa_kernel(q, k_pool, v_pool, pos_pool, block_tables, q_pos,
                            *, window: int = 0,
                            n_split: int | None = None) -> torch.Tensor:
    """q: (B, T, H, hd) contiguous; k/v_pool: (P, ps, Kv, hd) with a
    contiguous last axis, read through their strides; pos_pool: (P, ps),
    block_tables: (B, n_blocks) and q_pos: (B, T) contiguous int32. The
    launch of ``csrc/paged_decode_gqa.cu`` (the port of
    ``repro.kernels.decode_gqa.kernel.paged_decode_gqa_kernel``);
    ``n_split`` as for ``decode_gqa_kernel``. Returns (B, T, H, hd) in q's
    dtype."""
    B, T, H, hd = q.shape
    ps, Kv = k_pool.shape[1], k_pool.shape[2]
    nb = block_tables.shape[1]
    TG = T * (H // Kv)
    n = n_split or plan_splits(B, Kv, nb * ps, TG, hd)
    groups = plan_groups(B, Kv, n, TG, hd, q.element_size())
    out = torch.empty_like(q)
    keep, part, part_ml, tickets = _scratch(q.device, B, Kv, TG, hd, n,
                                            groups[0])
    fn = _build.load("paged_decode_gqa")
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             pos_pool.data_ptr(), block_tables.data_ptr(), q_pos.data_ptr(),
             out.data_ptr(), part, part_ml, tickets, B, T, H, Kv, ps, nb, hd,
             *k_pool.stride()[:3], *v_pool.stride()[:3],
             window, 1.0 / math.sqrt(hd), n, split_chunk(nb * ps, n),
             *groups, _vec(k_pool, v_pool), _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("paged_decode_gqa", err)
    del keep
    return out
