"""Launch of the hand-written CUDA kernel ``csrc/decode_gqa.cu`` (the port of
``repro.kernels.decode_gqa.kernel.decode_gqa_kernel``). Takes tensors the
wrapper in ``ops.py`` has already checked."""

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
