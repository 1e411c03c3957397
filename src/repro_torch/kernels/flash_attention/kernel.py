"""Launches of the hand-written CUDA kernels ``csrc/flash_attention.cu``
(the port of ``repro.kernels.flash_attention.kernel.flash_attention_kernel``)
and ``csrc/flash_attention_bwd.cu`` (its backward). They take tensors the
wrappers in ``ops.py`` have already checked."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the largest head_dim: the kernels are built for buckets of 16, 32, 64 and
# 128 (a template parameter) and run a smaller head_dim in the next bucket
# up with zero-padded fragments (HuBERT's hd 80 runs in the 128 bucket); the
# 128 bucket's backward blocks take 100 KB of shared memory (six 32-row
# fp32 tiles of pitch 132)
MAX_HD = 128


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_attention_fwd_kernel(q, k, v, key_mask, *, causal: bool,
                               window: int, with_lse: bool,
                               positions=None):
    """q: (B, S, H, hd), k, v: (B, S, Kv, hd), each with a contiguous last
    axis, read through their strides; key_mask: (B, S) contiguous bool or
    None; positions: (B, S) contiguous int32, the queries' and the keys'
    (self-attention), or None (mask by index).
    Returns (out (B, S, H, hd) contiguous in q's dtype, lse (B, H, S)
    float32, or None without ``with_lse``: the kernel then writes none)."""
    B, S, H, hd = q.shape
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    fn = _build.load("flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
             _ptr(positions), _ptr(positions), out.data_ptr(), _ptr(lse),
             B, S, H, k.shape[2], hd, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], int(causal), window, 1.0 / math.sqrt(hd),
             _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err)
    return out, lse


def flash_attention_bwd_kernel(q, k, v, o, lse, do, key_mask, *,
                               causal: bool, window: int, positions=None):
    """fp32. q, o, do: (B, S, H, hd), k, v: (B, S, Kv, hd), each with a
    contiguous last axis; lse: (B, H, S) contiguous; key_mask and positions
    as for the forward. Two launches: dQ, which also fills a (B, H, S)
    scratch with D = rowsum(dO * O), then dK/dV (a block per kv head,
    summing over its query heads), which reads it. Returns (dq (B, S, H,
    hd), dk, dv (B, S, Kv, hd)), contiguous."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    dq = torch.empty((B, S, H, hd), dtype=torch.float32, device=q.device)
    dk, dv = (torch.empty((B, S, Kv, hd), dtype=torch.float32,
                          device=q.device) for _ in range(2))
    D = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = _build.load("flash_attention_bwd")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), _ptr(key_mask), _ptr(positions), _ptr(positions),
             lse.data_ptr(), D.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), B, S, H, Kv, hd, *q.stride()[:3],
             *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
             *do.stride()[:3], int(causal), window, 1.0 / math.sqrt(hd),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention_bwd", err)
    return dq, dk, dv
