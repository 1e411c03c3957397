"""Checkpoints in the JAX package's layout (the port of
``repro.checkpoint.io``), written and read without JAX and without the
``msgpack`` package.

The file is one msgpack map ``{"leaves": [leaf, ...]}``; each leaf is
``{"__arr__": True, "dtype": <numpy dtype name>, "shape": [...], "data":
<raw tobytes()>}``. The leaves run in ``jax.tree_util`` flatten order: dict
keys sorted at every level (so a checkpoint's top level is ``extra``,
``opt``, ``params``, ``step``), lists, tuples and named tuples in order,
``None`` no leaf. A seq2seq param tree is stored as the JAX package holds
it: ``enc_blocks`` / ``dec_blocks`` stacked on a leading layer axis, Adam's
moments alike (``repro_torch.bridge``); the checkpoint's ``step`` is an
int64 scalar and Adam's an int32 one. So a file written here is byte for
byte the one ``repro.checkpoint.save_checkpoint`` writes for the same
weights, step and Adam state, and each package reads the other's.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.bridge import seq2seq_params_from_jax, seq2seq_params_to_jax
from repro_torch.checkpoint._msgpack import packb, unpackb
from repro_torch.device import resolve_device
from repro_torch.training.optimizer import AdamState

_ARR = "__arr__"


def _flatten(tree) -> list:
    """Leaves in ``jax.tree_util`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(like, leaves):
    """``leaves`` (in ``_flatten`` order) in the structure of ``like``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _map_leaves(tree, fn):
    return _unflatten(tree, [fn(x) for x in _flatten(tree)])


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _pack_leaf(x) -> dict:
    a = _numpy(x)   # tobytes() is C order; ascontiguousarray would make 0-d 1-d
    if a.dtype.hasobject:
        raise TypeError(f"checkpoint leaf of {type(x).__name__}: not an "
                        f"array of numbers")
    return {_ARR: True, "dtype": str(a.dtype), "shape": list(a.shape),
            "data": a.tobytes()}


def _unpack_leaf(d: dict) -> np.ndarray:
    a = np.frombuffer(d["data"], dtype=np.dtype(d["dtype"]))
    return a.reshape(d["shape"]).copy()   # frombuffer's array is read-only


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree``'s leaves (tensors, numpy arrays or numbers), in
    ``jax.tree_util`` order; atomic (a temp file in the same directory,
    then ``os.replace``)."""
    payload = {"leaves": [_pack_leaf(x) for x in _flatten(tree)]}
    data = packb(payload)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _read_leaves(path: str, like: Any) -> list[np.ndarray]:
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    ref = _flatten(like)
    leaves = [_unpack_leaf(d) for d in payload["leaves"]]
    if len(leaves) != len(ref):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, "
                         f"model expects {len(ref)}")
    for got, want in zip(leaves, ref):
        if tuple(got.shape) != tuple(_shape(want)):
            raise ValueError(f"shape mismatch: {got.shape} vs "
                             f"{_shape(want)}")
    return leaves


def load_pytree(path: str, like: Any, *, device=None) -> Any:
    """The file's leaves in the structure of ``like`` (leaf count and every
    shape checked), as tensors on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    leaves = _read_leaves(path, like)
    return _unflatten(like, [torch.from_numpy(a).to(dev) for a in leaves])


def _is_seq2seq(params) -> bool:
    return isinstance(params, dict) and isinstance(
        params.get("enc_blocks"), list)


def _in_order(like, tree):
    """``tree`` with its dict keys in ``like``'s order, so that the port's
    insertion-order leaf walks (``tree_leaves``, Adam) pair loaded params
    and moments as they paired the ones saved."""
    if isinstance(like, dict):
        return {k: _in_order(like[k], tree[k]) for k in like}
    if isinstance(like, list):
        return [_in_order(a, b) for a, b in zip(like, tree)]
    return tree


def _to_layout(params):
    """Port params -> the stored layout (per-layer lists stacked)."""
    return seq2seq_params_to_jax(params) if _is_seq2seq(params) else params


def _checkpoint_tree(params, opt_state, step, extra) -> dict:
    tree = {"params": _to_layout(params), "step": np.int64(step)}
    if opt_state is not None:
        tree["opt"] = (np.int32(opt_state.step), _to_layout(opt_state.mu),
                       _to_layout(opt_state.nu))
    if extra:
        tree["extra"] = extra
    return tree


def save_checkpoint(path: str, *, params, opt_state: AdamState | None = None,
                    step: int = 0, extra: dict | None = None) -> None:
    """Save port params (a seq2seq tree with per-layer block lists, or any
    tree of tensors), the port's ``AdamState`` and the step, in the JAX
    package's layout."""
    save_pytree(path, _checkpoint_tree(params, opt_state, step, extra))


def load_checkpoint(path: str, *, params_like,
                    opt_like: AdamState | None = None,
                    extra_like: dict | None = None, device=None) -> dict:
    """Read a checkpoint into the structure of ``params_like`` (and
    ``opt_like`` / ``extra_like``), on ``device`` (``None``: the card).
    Returns ``{"params", "step"}`` plus ``"opt"`` (an ``AdamState`` whose
    step is an int again) and ``"extra"`` when asked for."""
    dev = resolve_device(device)
    like = _checkpoint_tree(params_like, opt_like, 0, extra_like)
    tree = _unflatten(like, _read_leaves(path, like))

    def tensors(stored):
        return _map_leaves(stored, lambda a: torch.from_numpy(a).to(dev))

    def back(stored, like_part):
        if _is_seq2seq(like_part):
            return _in_order(like_part,
                             seq2seq_params_from_jax(stored, device=dev))
        return tensors(stored)

    out = {"params": back(tree["params"], params_like),
           "step": int(tree["step"])}
    if opt_like is not None:
        step, mu, nu = tree["opt"]
        out["opt"] = AdamState(step=int(step), mu=back(mu, opt_like.mu),
                               nu=back(nu, opt_like.nu))
    if extra_like:
        out["extra"] = tensors(tree["extra"])
    return out
