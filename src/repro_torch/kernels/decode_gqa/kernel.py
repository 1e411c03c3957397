"""Launches of the hand-written CUDA kernels ``csrc/decode_gqa.cu`` (the
port of ``repro.kernels.decode_gqa.kernel.decode_gqa_kernel``) and
``csrc/paged_decode_gqa.cu`` (of ``paged_decode_gqa_kernel``). They take
tensors the wrappers in ``ops.py`` have already checked."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_gqa_kernel(q, k_cache, v_cache, k_pos, q_pos, *,
                      window: int = 0) -> torch.Tensor:
    """q: (B, T, H, hd) contiguous; k/v_cache: (B, S, Kv, hd) with a
    contiguous last axis, read through their strides; k_pos: (B, S) and
    q_pos: (B, T) contiguous int32. Returns (B, T, H, hd) in q's dtype."""
    B, T, H, hd = q.shape
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    fn = _build.load("decode_gqa")
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             k_pos.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
             B, T, H, Kv, S, hd,
             *k_cache.stride()[:3], *v_cache.stride()[:3],
             window, 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_gqa", err)
    return out


def paged_decode_gqa_kernel(q, k_pool, v_pool, pos_pool, block_tables, q_pos,
                            *, window: int = 0) -> torch.Tensor:
    """q: (B, T, H, hd) contiguous; k/v_pool: (P, ps, Kv, hd) with a
    contiguous last axis, read through their strides; pos_pool: (P, ps),
    block_tables: (B, n_blocks) and q_pos: (B, T) contiguous int32. The
    launch of ``csrc/paged_decode_gqa.cu`` (the port of
    ``repro.kernels.decode_gqa.kernel.paged_decode_gqa_kernel``). Returns
    (B, T, H, hd) in q's dtype."""
    B, T, H, hd = q.shape
    ps, Kv = k_pool.shape[1], k_pool.shape[2]
    nb = block_tables.shape[1]
    out = torch.empty_like(q)
    fn = _build.load("paged_decode_gqa")
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             pos_pool.data_ptr(), block_tables.data_ptr(), q_pos.data_ptr(),
             out.data_ptr(), B, T, H, Kv, ps, nb, hd,
             *k_pool.stride()[:3], *v_pool.stride()[:3],
             window, 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("paged_decode_gqa", err)
    return out
