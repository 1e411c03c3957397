"""Roofline terms of a built step (``launch.steps``) on the H100: the port
of ``repro.launch.hlo_analysis``.

The JAX package reads a compiled artifact: ``cost_analysis()`` for flops
and bytes, the optimized HLO text for collectives. The port has no
compiled artifact. It runs the step on meta tensors instead:

- ``count_cost(fn, *inputs)`` runs ``fn`` under one counting mode (a
  ``TorchDispatchMode``): flops by ``torch.utils.flop_counter``'s formula
  for each aten op (matmuls, convolutions, attention; elementwise ops
  count none); ``bytes accessed`` as each aten op's operand and result
  bytes summed, XLA's convention (views and allocations move nothing; an
  in-place ``index_put_``, such as a cache write, moves its values, its
  indices and the region it writes, not the whole destination);
  the hand-written kernels' work from their wrappers' meta branches
  (``kernels._build.record_work``: every cache slot visible, an upper
  bound); and the peak bytes of the intermediates alive at once
  (``temp_bytes``: tensors made inside the call, by storage, freed when
  the last tensor on a storage dies; a tensor autograd saves lives as long
  as the graph);
- collectives are ``(kind, bytes)`` records: a recording
  ``TensorParallel`` (``sharding.ctx``) makes one for each collective of
  the layers, ``launch.steps`` one for each FSDP gather, reduce-scatter
  and gradient all-reduce of the specs; ``collective_bytes`` sums them by
  kind as JAX's parser sums HLO lines (the largest shape on a line);
- ``trace_roofline(prof, terms)`` sets a ``torch.profiler`` trace of the
  step run on the card beside its terms.

Hardware constants: the NVIDIA H100 80GB HBM3 (SXM5) data sheet:
989.4 TFLOP/s bf16 dense (tensor cores), 66.9 TFLOP/s fp32 (no tensor
cores: the trainer's fp32 with TF32 off), 3.35 TB/s HBM3, and NVLink 4 at
900 GB/s a card, both directions summed over its 18 links: 450 GB/s each
way is the collective rate. The compute peak follows the step's dtype.
"""

from __future__ import annotations

import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

CARD = "NVIDIA H100 80GB HBM3"
BF16_FLOPS = 989.4e12
FP32_FLOPS = 66.9e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_aten = torch.ops.aten
# allocations and aliases: no bytes move
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.new_empty.default,
         _aten.new_empty_strided.default, _aten.detach.default,
         _aten.alias.default, _aten.lift_fresh.default}


def _index_put_bytes(args, kwargs) -> int:
    """Bytes an in-place ``index_put_`` (a cache write, an MoE dispatch)
    moves: its indices and values read, and the indexed region written
    (read too where it accumulates), as XLA counts an in-place
    dynamic-update-slice or scatter; not its whole destination."""
    dest, indices, values = args[:3]
    idx = [None if i is None else torch.empty(i.shape, dtype=i.dtype,
                                              device="meta")
           for i in indices]
    if any(i is not None and i.dtype == torch.bool for i in idx):
        region = values.numel()      # a mask's region depends on the data
    else:
        region = _aten.index.Tensor(torch.empty(dest.shape, device="meta"),
                                    idx).numel()
    accumulate = bool(args[3] if len(args) > 3
                      else kwargs.get("accumulate", False))
    return (sum(t.nbytes for t in _tensors((indices, values)))
            + region * dest.element_size() * (2 if accumulate else 1))


def peak_flops(dtype=torch.bfloat16) -> float:
    """The card's peak for a step in ``dtype``: bf16 (and fp16) on the
    tensor cores, fp32 without them."""
    return BF16_FLOPS if dtype in (torch.bfloat16, torch.float16) \
        else FP32_FLOPS


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _CountMode(TorchDispatchMode):
    """Flops, bytes accessed and live intermediates of every aten op."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.nbytes = 0
        self.live = 0
        self.peak = 0
        self._refs: dict[int, list] = {}

    def _drop(self, key: int) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[key]

    def _hold(self, t: torch.Tensor, key: int) -> None:
        self._refs[key][1] += 1
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if func is _aten.index_put_.default:
            self.nbytes += _index_put_bytes(args, kwargs)
        elif func not in _FREE and not func.is_view:
            self.nbytes += sum(t.nbytes for t in ins) + sum(
                t.nbytes for t in outs)
        in_keys = {_storage_key(t) for t in ins}
        for t in outs:
            key = _storage_key(t)
            if key in self._refs:
                self._hold(t, key)
            elif key not in in_keys and not func.is_view:
                self._refs[key] = [t.untyped_storage().nbytes(), 0]
                self.live += self._refs[key][0]
                self.peak = max(self.peak, self.live)
                self._hold(t, key)
        return out


def count_cost(fn, *inputs) -> tuple[dict, Any]:
    """Run ``fn(*inputs)`` (meta tensors) under the counting mode; returns
    (cost, fn's output). ``cost``: ``flops`` and ``bytes accessed`` (the
    aten ops' and the kernels' together, the keys of JAX's
    ``cost_analysis()``), ``temp_bytes`` (the peak of the live
    intermediates) and ``kernels`` ({name: {launches, flops, bytes}}, the
    kernels' share)."""
    from repro_torch.kernels import _build

    kernels: dict[str, dict] = {}

    def sink(name: str, nbytes: int, flops: int) -> None:
        k = kernels.setdefault(name, dict(launches=0, flops=0, bytes=0))
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    _build.work_sinks.append(sink)
    mode = _CountMode()
    try:
        with mode:
            out = fn(*inputs)
    finally:
        _build.work_sinks.remove(sink)
    cost = {"flops": float(mode.flops + sum(k["flops"]
                                            for k in kernels.values())),
            "bytes accessed": float(mode.nbytes + sum(
                k["bytes"] for k in kernels.values())),
            "temp_bytes": float(mode.peak), "kernels": kernels}
    return cost, out


def collective_bytes(records) -> dict[str, float]:
    """Sum per-device traffic of every collective record ``(kind, bytes)``
    by kind; ``counts``: the records of each kind."""
    out: dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    counts: dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for kind, nbytes in records:
        if kind not in out:
            raise ValueError(f"unknown collective {kind!r}")
        out[kind] += float(nbytes)
        counts[kind] += 1
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    out["counts"] = counts  # type: ignore[assignment]
    return out


def roofline_terms(cost: dict, records, *, dtype=torch.bfloat16
                   ) -> dict[str, Any]:
    """Three roofline terms (seconds, per card) and their inputs, as JAX's:
    the compute peak is ``dtype``'s (``peak_flops``)."""
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    coll = collective_bytes(records)
    terms = {
        "flops_per_device": flops,
        "bytes_per_device": bytes_acc,
        "collective_bytes_per_device": coll["total"],
        "collective_breakdown": {k: coll[k] for k in _COLLECTIVES},
        "collective_counts": coll["counts"],
        "compute_s": flops / peak_flops(dtype),
        "memory_s": bytes_acc / HBM_BW,
        "collective_s": coll["total"] / NVLINK_BW,
    }
    dominant = max(("compute_s", "memory_s", "collective_s"),
                   key=lambda k: terms[k])
    terms["bottleneck"] = dominant.replace("_s", "")
    return terms


def count_params(params_tree) -> tuple[int, int]:
    """(total params, active params); active equals total, as JAX's count
    returns it (``model_flops`` discounts the experts)."""
    total = sum(t.numel() for t in _tensors(params_tree))
    return total, total


def model_flops(cfg, total_params: int, expert_params: int, *, tokens: int,
                train: bool, top_k: int = 0, n_experts: int = 0) -> float:
    """6·N·D (train) / 2·N·D (inference) with MoE discounting."""
    n_active = total_params - expert_params
    if n_experts:
        n_active += expert_params * top_k / n_experts
    mult = 6.0 if train else 2.0
    return mult * n_active * tokens


def trace_roofline(prof, terms: dict) -> dict:
    """A ``torch.profiler`` trace of a step run on the card beside its
    roofline ``terms``: the kernels' device time summed (``kernel_ms``),
    the span from the first kernel's start to the last one's end
    (``span_ms``), the busy share (kernel time over the span; eager
    PyTorch on one stream overlaps no kernels), and the achieved share of
    each term (the term's time over the kernel time: 1.0 is the card at
    that peak). A share above 1 is no result: the card cannot beat its
    peak, so the term's count is wrong. Such a term is listed in ``over``
    with its share, and its ``achieved`` entry is None."""
    events = [e for e in prof.events()
              if str(e.device_type).endswith("CUDA")
              and e.time_range.elapsed_us() > 0]
    if not events:
        raise ValueError("trace_roofline: the trace holds no device kernel "
                         "(was the step run on the card, with CUDA "
                         "activity traced?)")
    kernel_us = sum(e.time_range.elapsed_us() for e in events)
    span_us = (max(e.time_range.end for e in events)
               - min(e.time_range.start for e in events))
    kernel_s = kernel_us / 1e6
    share = {k: terms[f"{k}_s"] / kernel_s
             for k in ("compute", "memory", "collective")}
    return dict(kernel_ms=kernel_us / 1e3, span_ms=span_us / 1e3,
                busy=kernel_us / span_us if span_us else 1.0,
                n_kernels=len(events),
                achieved={k: v if v <= 1.0 else None
                          for k, v in share.items()},
                over={k: v for k, v in share.items() if v > 1.0})
