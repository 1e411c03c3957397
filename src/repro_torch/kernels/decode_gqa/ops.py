"""The port's GQA decode attention over a dense and over a paged cache: the
plain version for CPU tensors, the CUDA kernel for CUDA tensors (no
fall-back between them)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_gqa.kernel import (_DTYPES, MAX_HD,
                                                   decode_gqa_kernel,
                                                   paged_decode_gqa_kernel)
from repro_torch.kernels.decode_gqa.ref import (decode_gqa_ref,
                                                paged_decode_gqa_ref)


def _check(q, k_cache, v_cache, k_pos, q_pos) -> None:
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_gqa: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    B, T, H, hd = q.shape
    Bk, S, Kv, hdk = k_cache.shape
    if Bk != B or hdk != hd or Kv == 0 or H % Kv:
        raise ValueError(f"decode_gqa: q {tuple(q.shape)} does not match "
                         f"cache {tuple(k_cache.shape)}")
    if tuple(k_pos.shape) != (B, S) or tuple(q_pos.shape) != (B, T):
        raise ValueError(f"decode_gqa: k_pos {tuple(k_pos.shape)}, q_pos "
                         f"{tuple(q_pos.shape)} for B={B} S={S} T={T}")
    devs = {t.device for t in (q, k_cache, v_cache, k_pos, q_pos)}
    if len(devs) != 1:
        raise ValueError(f"decode_gqa: tensors on several devices {devs}")


def decode_gqa_attention(q, k_cache, v_cache, k_pos, q_pos, *,
                         window: int = 0) -> torch.Tensor:
    """q: (B, T, H, hd); k/v_cache: (B, S, Kv, hd); k_pos: (B, S) stored
    positions (-1 empty); q_pos: (B, T). Returns (B, T, H, hd).

    The counterpart of ``repro.kernels.decode_gqa.ops.decode_gqa_attention``.
    """
    _check(q, k_cache, v_cache, k_pos, q_pos)
    if q.device.type == "cpu":
        return decode_gqa_ref(q, k_cache, v_cache, k_pos, q_pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_gqa: unsupported device {q.device}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_gqa: dtypes {q.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}; the kernel takes float32 or "
                        f"bfloat16, all alike")
    if k_pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("decode_gqa: positions must be int32")
    if not (q.is_contiguous() and k_pos.is_contiguous()
            and q_pos.is_contiguous()):
        raise ValueError("decode_gqa: q and positions must be contiguous")
    if k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("decode_gqa: the cache's head_dim axis must be "
                         "contiguous")
    if q.shape[-1] > MAX_HD:
        raise ValueError(f"decode_gqa: head_dim {q.shape[-1]} > {MAX_HD}, "
                         f"the kernel's largest bucket")
    if q.numel() == 0:
        return torch.empty_like(q)
    out = decode_gqa_kernel(q, k_cache, v_cache, k_pos, q_pos, window=window)
    _build.count_launch("decode_gqa")
    return out


def _check_paged(q, k_pool, v_pool, pos_pool, block_tables, q_pos) -> None:
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_decode_gqa: q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool {tuple(v_pool.shape)}")
    B, T, H, hd = q.shape
    P, ps, Kv, hdk = k_pool.shape
    if hdk != hd or Kv == 0 or H % Kv:
        raise ValueError(f"paged_decode_gqa: q {tuple(q.shape)} does not "
                         f"match pool {tuple(k_pool.shape)}")
    if (tuple(pos_pool.shape) != (P, ps) or block_tables.dim() != 2
            or block_tables.shape[0] != B or tuple(q_pos.shape) != (B, T)):
        raise ValueError(f"paged_decode_gqa: pos_pool {tuple(pos_pool.shape)},"
                         f" block_tables {tuple(block_tables.shape)}, q_pos "
                         f"{tuple(q_pos.shape)} for B={B} T={T} P={P} ps={ps}")
    devs = {t.device for t in (q, k_pool, v_pool, pos_pool, block_tables,
                               q_pos)}
    if len(devs) != 1:
        raise ValueError(f"paged_decode_gqa: tensors on several devices {devs}")


def paged_decode_gqa_attention(q, k_pool, v_pool, pos_pool, block_tables,
                               q_pos, *, window: int = 0) -> torch.Tensor:
    """Paged decode attention: walk the block table instead of a contiguous
    row. q: (B, T, H, hd); k/v_pool: (P, ps, Kv, hd) (the ``PagedKVCache``
    pool layout of one layer); pos_pool: (P, ps) stored positions (-1
    empty); block_tables: (B, n_blocks) page ids (-1 unmapped); q_pos:
    (B, T). Returns (B, T, H, hd).

    The counterpart of
    ``repro.kernels.decode_gqa.ops.paged_decode_gqa_attention``; the pool is
    read in its own layout, with no transposed copy.
    """
    _check_paged(q, k_pool, v_pool, pos_pool, block_tables, q_pos)
    if q.device.type == "cpu":
        return paged_decode_gqa_ref(q, k_pool, v_pool, pos_pool, block_tables,
                                    q_pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_gqa: unsupported device {q.device}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"paged_decode_gqa: dtypes {q.dtype}/{k_pool.dtype}/"
                        f"{v_pool.dtype}; the kernel takes float32 or "
                        f"bfloat16, all alike")
    if any(t.dtype != torch.int32 for t in (pos_pool, block_tables, q_pos)):
        raise TypeError("paged_decode_gqa: positions and block tables must "
                        "be int32")
    if not all(t.is_contiguous() for t in (q, pos_pool, block_tables, q_pos)):
        raise ValueError("paged_decode_gqa: q, pos_pool, block_tables and "
                         "q_pos must be contiguous")
    if k_pool.stride(3) != 1 or v_pool.stride(3) != 1:
        raise ValueError("paged_decode_gqa: the pool's head_dim axis must be "
                         "contiguous")
    if q.shape[-1] > MAX_HD:
        raise ValueError(f"paged_decode_gqa: head_dim {q.shape[-1]} > "
                         f"{MAX_HD}, the kernel's largest bucket")
    if q.numel() == 0:
        return torch.empty_like(q)
    out = paged_decode_gqa_kernel(q, k_pool, v_pool, pos_pool, block_tables,
                                  q_pos, window=window)
    _build.count_launch("paged_decode_gqa")
    return out
