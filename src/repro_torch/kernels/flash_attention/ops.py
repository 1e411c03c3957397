"""The port's full-sequence attention: the plain versions for CPU tensors,
the CUDA kernels for CUDA tensors (no fall-back between them), forward and
backward behind one ``torch.autograd.Function``.

Two entries:

- ``flash_attention(q, k, v, *, causal, window, bq, bk)`` keeps the Pallas
  wrapper's signature and ``(B, H, S, hd)`` layout
  (``repro.kernels.flash_attention.ops.flash_attention``); ``bq``/``bk``
  are accepted and the result does not depend on them (the port needs no
  padding to whole blocks);
- ``flash_attention_bshd(q, k, v, *, causal, window, key_mask,
  positions)`` takes the model's layout, q ``(B, S, H, hd)`` and k, v
  ``(B, S, Kv, hd)`` with ``H % Kv == 0`` (grouped-query attention: query
  head h reads kv head ``h // (H // Kv)``), a per-row key mask (``(B, S)``
  bool, True = valid key) and optional positions (``(B, S)`` int32, the
  queries' and the keys' alike: self-attention), which the Pallas
  signature (one scalar ``seq_len``, masks by index) lacks. With
  ``key_mask`` and ``positions`` None and ``Kv == H`` it computes exactly
  the Pallas contract.

``window`` applies only when ``causal``. A query row with no visible key
outputs 0 and gets zero gradient (see ``ref.py``).

On meta tensors (a dry run's shape propagation, ``repro_torch.launch.
hlo_analysis.count_cost``) the forward and the backward return empty
outputs of the kernels' shapes and record their work from the shapes
alone (``flash_work``): every key of a row counts as valid, and a causal
(or windowed) row sees the keys at or before it, the causal mask halving
the work.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (
    _DTYPES, MAX_HD, flash_attention_bwd_kernel, flash_attention_fwd_kernel)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)


def _check(q, k, v, key_mask, window, positions) -> None:
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]
            or k.shape[2] == 0 or q.shape[2] % k.shape[2] != 0):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; expected "
                         f"q (B, S, H, hd) and k, v (B, S, Kv, hd) with "
                         f"H % Kv == 0")
    for name, t in (("key_mask", key_mask), ("positions", positions)):
        if t is not None and tuple(t.shape) != tuple(q.shape[:2]):
            raise ValueError(f"flash_attention: {name} {tuple(t.shape)} "
                             f"for (B, S) = {tuple(q.shape[:2])}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    tensors = [t for t in (q, k, v, key_mask, positions) if t is not None]
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"flash_attention: tensors on several devices {devs}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_work(B: int, S: int, H: int, hd: int, *, Kv: int | None = None,
               causal: bool, window: int = 0, lengths=None,
               masked: bool | None = None, itemsize: int = 4,
               backward: bool = False,
               with_lse: bool = True) -> tuple[int, int]:
    """(bytes, flops) that full-sequence attention needs: each input read
    once and each output written once, the K/V reads of valid keys only
    (``lengths``: each row's valid keys, default all S; Kv kv heads,
    default H); the forward's lse write only ``with_lse`` (training keeps
    it for the backward, inference needs none); the (B, S) key mask read
    when one is passed (``masked``, default: some row is shorter than S);
    flops per visible (query, key) pair of each query head: 4·hd forward
    (QK^T, PV), 10·hd backward (QK^T and dO·V^T recomputed, then dV, dQ,
    dK). A causal row sees the keys at or before it, the last ``window``
    of them with a window."""
    Kv = H if Kv is None else Kv
    if lengths is None:
        if causal and window > 0:
            m = min(S, window)
            seen = m * (m + 1) // 2 + max(0, S - window) * window
        else:
            seen = S * (S + 1) // 2 if causal else S * S
        pairs, valid = H * B * seen, B * S
        masked = bool(masked)
    else:
        import numpy as np

        lengths = np.asarray(lengths)
        qi, ki = np.arange(S)[:, None], np.arange(S)[None, :]
        vis = (ki <= qi) if causal else np.ones((S, S), bool)
        if causal and window > 0:
            vis &= ki > qi - window
        pairs = H * sum(int((vis & (ki < n)).sum()) for n in lengths)
        valid = int(lengths.sum())
        masked = bool(lengths.min() < S) if masked is None else masked
    rows = B * S * H * hd              # q (and out, dO, dQ) elements
    keys = valid * Kv * hd             # K or V elements of valid keys
    mask = B * S if masked else 0
    if not backward:
        lse = B * H * S * 4 if with_lse else 0
        return (2 * rows + 2 * keys) * itemsize + lse + mask, 4 * hd * pairs
    # q, o, dO, dq + k, v (valid keys) + dk, dv (whole); lse, mask
    return ((4 * rows + 2 * keys + 2 * B * S * Kv * hd) * itemsize
            + B * H * S * 4 + mask), 10 * hd * pairs


def _check_cuda(q, k, v, key_mask, positions) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes float32 or bfloat16, "
                        f"all alike")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: the head_dim axis of q, k and v "
                         "must be contiguous")
    if q.shape[3] > MAX_HD:
        raise ValueError(f"flash_attention: head_dim {q.shape[3]} > {MAX_HD}")
    if key_mask is not None and (key_mask.dtype != torch.bool
                                 or not key_mask.is_contiguous()):
        raise TypeError("flash_attention: key_mask must be a contiguous "
                        "bool tensor")
    if positions is not None and (positions.dtype != torch.int32
                                  or not positions.is_contiguous()):
        raise TypeError("flash_attention: positions must be a contiguous "
                        "int32 tensor")
    if positions is not None and q.dtype != torch.float32:
        raise TypeError("flash_attention: the kernels take positions in "
                        "float32 only (the models pass them where they "
                        "train)")


def _forward(q, k, v, key_mask, causal, window, *, with_lse: bool,
             positions=None):
    """(out (B, S, H, hd), lse (B, H, S) fp32) on the tensors' device; lse
    is None without ``with_lse`` (inference: the kernel writes none)."""
    if q.device.type == "cpu":
        out, lse = flash_attention_ref(q, k, v, causal=causal, window=window,
                                       key_mask=key_mask, q_pos=positions,
                                       k_pos=positions)
        return out, (lse if with_lse else None)
    if q.device.type == "meta":
        B, S, H, hd = q.shape
        _build.record_work("flash_attention", *flash_work(
            B, S, H, hd, Kv=k.shape[2], causal=causal, window=window,
            masked=key_mask is not None, itemsize=q.element_size(),
            with_lse=with_lse))
        lse = (torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                           dtype=torch.float32, device="meta")
               if with_lse else None)
        return torch.empty_like(q), lse
    _check_cuda(q, k, v, key_mask, positions)
    if q.numel() == 0:
        return torch.empty_like(q), (torch.empty(
            (q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32,
            device=q.device) if with_lse else None)
    res = flash_attention_fwd_kernel(q, k, v, key_mask, causal=causal,
                                     window=window, with_lse=with_lse,
                                     positions=positions)
    _build.count_launch("flash_attention")
    return res


def _backward(q, k, v, o, lse, do, key_mask, causal, window,
              positions=None):
    """(dq, dk, dv) of the forward's output (dk, dv in k's shape)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, key_mask=key_mask,
                                       q_pos=positions, k_pos=positions)
    if q.device.type == "meta":
        B, S, H, hd = q.shape
        _build.record_work("flash_attention_bwd", *flash_work(
            B, S, H, hd, Kv=k.shape[2], causal=causal, window=window,
            masked=key_mask is not None, itemsize=q.element_size(),
            backward=True))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if any(t.dtype != torch.float32 for t in (q, k, v, o, do)):
        raise TypeError("flash_attention backward: the kernel takes float32 "
                        "only (the model trains in fp32)")
    if do.stride(3) != 1:
        do = do.contiguous()
    if q.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    grads = flash_attention_bwd_kernel(q, k, v, o, lse, do, key_mask,
                                       causal=causal, window=window,
                                       positions=positions)
    _build.count_launch("flash_attention_bwd")
    return grads


class _FlashAttention(torch.autograd.Function):
    """Forward through ``_forward``; the backward recomputes P from the
    saved fp32 ``lse`` (never from another reduction)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, window, positions):
        out, lse = _forward(q, k, v, key_mask, causal, window,
                            with_lse=True, positions=positions)
        ctx.save_for_backward(q, k, v, out, lse, key_mask, positions)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, key_mask, positions = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, do, key_mask, ctx.causal,
                               ctx.window, positions)
        return dq, dk, dv, None, None, None, None


def flash_attention_bshd(q, k, v, *, causal: bool, window: int = 0,
                         key_mask=None, positions=None) -> torch.Tensor:
    """q: (B, S, H, hd), k, v: (B, S, Kv, hd), the model's layout (read
    through their strides on the card); key_mask: (B, S) bool, True =
    valid key, or None; positions: (B, S) int32, the queries' and the
    keys', or None (the indices: the kernels then skip the key tiles a
    causal or windowed row cannot see). Returns (B, S, H, hd) in q's dtype. Differentiable;
    ``lse`` is asked for (and kept for the backward) only when a gradient
    is needed, so serving writes and stores none."""
    _check(q, k, v, key_mask, window, positions)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, key_mask, causal, window,
                                     positions)
    return _forward(q, k, v, key_mask, causal, window, with_lse=False,
                    positions=positions)[0]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    bq: int = 128, bk: int = 128) -> torch.Tensor:
    """q, k, v: (B, H, S, hd) -> (B, H, S, hd): the counterpart of
    ``repro.kernels.flash_attention.ops.flash_attention`` (``bq``/``bk``
    have no effect). The kernel reads the transposed views through their
    strides, so nothing is copied."""
    out = flash_attention_bshd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window)
    return out.transpose(1, 2)
