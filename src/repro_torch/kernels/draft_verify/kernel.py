"""Launch of the hand-written CUDA kernel ``csrc/draft_verify.cu`` (the port
of ``repro.kernels.draft_verify.kernel.draft_verify_kernel``). Takes tensors
the wrapper in ``ops.py`` has already checked."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_T = 32   # one warp per position


def draft_verify_kernel(logits, drafts, draft_mask):
    """logits: (N, T, V) contiguous; drafts: (N, T-1) contiguous int32;
    draft_mask: (N,) contiguous bool. Returns (tokens (N, T) int32,
    n_acc (N,) int32)."""
    N, T, V = logits.shape
    tokens = torch.empty((N, T), dtype=torch.int32, device=logits.device)
    n_acc = torch.empty((N,), dtype=torch.int32, device=logits.device)
    fn = _build.load("draft_verify")
    err = fn(logits.data_ptr(), drafts.data_ptr(), draft_mask.data_ptr(),
             tokens.data_ptr(), n_acc.data_ptr(), N, T, V,
             _DTYPES[logits.dtype],
             torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check("draft_verify", err)
    return tokens, n_acc
