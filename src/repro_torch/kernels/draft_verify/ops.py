"""The port's fused verify op: the plain version for CPU tensors, the CUDA
kernel for CUDA tensors (no fall-back between them). On meta tensors (a
dry run's shape propagation) it returns empty outputs of the kernel's
shapes and records its work (``verify_work``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.draft_verify.kernel import (_DTYPES,
                                                     draft_verify_kernel)
from repro_torch.kernels.draft_verify.ref import draft_verify_ref


def verify_work(N: int, T: int, V: int, itemsize: int) -> tuple[int, int]:
    """(bytes, flops) of one launch: one compare a logit; the logits, the
    int32 drafts and the bool mask read once, the int32 tokens and
    accepted lengths written once."""
    return N * T * V * itemsize + N * (T - 1) * 4 + N + (N * T + N) * 4, \
        N * T * V


def draft_verify(logits, drafts, draft_mask):
    """logits: (N, T, V); drafts: (N, T-1) int32; draft_mask: (N,) bool.

    Returns (greedy_tokens (N, T) int32, n_acc (N,) int32): the argmax over
    V (first index wins ties) and the accepted-prefix length. The
    counterpart of ``repro.kernels.draft_verify.ops.draft_verify``; unlike
    the TPU wrapper it needs no vocab padding.
    """
    if logits.dim() != 3:
        raise ValueError(f"draft_verify: logits {tuple(logits.shape)}")
    N, T, V = logits.shape
    if tuple(drafts.shape) != (N, T - 1) or tuple(draft_mask.shape) != (N,):
        raise ValueError(f"draft_verify: drafts {tuple(drafts.shape)}, mask "
                         f"{tuple(draft_mask.shape)} for logits "
                         f"{tuple(logits.shape)}")
    if len({logits.device, drafts.device, draft_mask.device}) != 1:
        raise ValueError("draft_verify: tensors on several devices")
    if logits.device.type == "cpu":
        return draft_verify_ref(logits, drafts, draft_mask)
    if logits.device.type == "meta":
        _build.record_work("draft_verify", *verify_work(
            N, T, V, logits.element_size()))
        return (torch.empty((N, T), dtype=torch.int32, device="meta"),
                torch.empty((N,), dtype=torch.int32, device="meta"))
    if logits.device.type != "cuda":
        raise ValueError(f"draft_verify: unsupported device {logits.device}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"draft_verify: logits dtype {logits.dtype}")
    if drafts.dtype != torch.int32 or draft_mask.dtype != torch.bool:
        raise TypeError("draft_verify: drafts must be int32, mask bool")
    if not (logits.is_contiguous() and drafts.is_contiguous()
            and draft_mask.is_contiguous()):
        raise ValueError("draft_verify: inputs must be contiguous")
    if T < 1 or V < 1:
        raise ValueError(f"draft_verify: T={T}, V={V} (each >= 1)")
    if N == 0:
        return (torch.empty((0, T), dtype=torch.int32, device=logits.device),
                torch.empty((0,), dtype=torch.int32, device=logits.device))
    out = draft_verify_kernel(logits, drafts, draft_mask)
    _build.count_launch("draft_verify")
    return out
