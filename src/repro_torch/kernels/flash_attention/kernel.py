"""Launches of the hand-written CUDA kernels ``csrc/flash_attention.cu``
(the port of ``repro.kernels.flash_attention.kernel.flash_attention_kernel``
plus its backward). They take tensors the wrappers in ``ops.py`` have
already checked."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the largest head_dim: the kernels are built for buckets of 16, 32, 64 and
# 128 (a template parameter) and run a smaller head_dim in the next bucket
# up with zero-padded fragments; the 128 bucket's backward blocks take
# 100 KB of shared memory (six 32-row fp32 tiles of pitch 132)
MAX_HD = 128


def _mask_ptr(key_mask):
    return None if key_mask is None else key_mask.data_ptr()


def flash_attention_fwd_kernel(q, k, v, key_mask, *, causal: bool,
                               window: int, with_lse: bool):
    """q, k, v: (B, S, H, hd) with a contiguous last axis, read through
    their strides; key_mask: (B, S) contiguous bool or None. Returns (out
    (B, S, H, hd) contiguous in q's dtype, lse (B, H, S) float32, or None
    without ``with_lse``: the kernel then writes none)."""
    B, S, H, hd = q.shape
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = _build.load("flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(key_mask),
             out.data_ptr(), None if lse is None else lse.data_ptr(),
             B, S, H, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             int(causal), window, 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err)
    return out, lse


def flash_attention_bwd_kernel(q, k, v, o, lse, do, key_mask, *,
                               causal: bool, window: int):
    """fp32. q, k, v, o, do: (B, S, H, hd) with a contiguous last axis;
    lse: (B, H, S) contiguous; key_mask as for the forward. Two launches:
    dQ, which also fills a (B, H, S) scratch with D = rowsum(dO * O), then
    dK/dV, which reads it. Returns (dq, dk, dv), each (B, S, H, hd)
    contiguous."""
    B, S, H, hd = q.shape
    dq, dk, dv = (torch.empty((B, S, H, hd), dtype=torch.float32,
                              device=q.device) for _ in range(3))
    D = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = _build.load("flash_attention_bwd")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), _mask_ptr(key_mask), lse.data_ptr(),
             D.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             B, S, H, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *o.stride()[:3], *do.stride()[:3], int(causal), window,
             1.0 / math.sqrt(hd),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention_bwd", err)
    return dq, dk, dv
