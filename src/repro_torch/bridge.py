"""Carry a seq2seq or decoder-only param tree between the JAX package and
the port.

``seq2seq_params_from_jax`` takes the JAX package's tree as nested dicts of
numpy arrays (e.g. ``jax.tree.map(np.asarray, params)``);
``seq2seq_params_to_jax`` gives port params (a trained model, or a
gradient tree) back in that layout, as numpy arrays. So this module needs
no JAX.

- ``enc_blocks`` / ``dec_blocks`` are stacked on a leading layer axis by
  ``jax.vmap`` in the JAX init; they become per-layer lists. The
  decoder-only ``blocks`` is a tuple (one entry per layer-pattern
  position) of such stacks; it becomes a tuple of per-repeat lists
  (``transformer_params_from_jax``).
- Dense ``w`` stays ``(d_in, d_out)``: the port applies it as ``x @ w``, so
  nothing is transposed (``repro_torch.models.layers.dense``).
- An MoE FFN's experts stay stacked on their leading ``(E, ...)`` axis
  (the port runs them as one ``torch.bmm``); its router and shared
  expert, and the Mamba (``mamba``) and RWKV (``rwkv``, ``cmix``)
  blocks' leaves, carry over under their JAX names.
- The embedding ``tok`` is shared by encoder and decoder in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(tree, n: int, device) -> list[dict]:
    return [_map(tree, lambda a, i=i: _tensor(np.asarray(a)[i], device))
            for i in range(n)]


def seq2seq_params_from_jax(tree: dict, *, device=None) -> dict:
    """JAX ``repro.models.seq2seq`` params (numpy leaves) -> port params."""
    dev = resolve_device(device)
    n_enc = len(np.asarray(tree["enc_blocks"]["norm1"]["scale"]))
    n_dec = len(np.asarray(tree["dec_blocks"]["norm1"]["scale"]))
    out = {k: _map(v, lambda a: _tensor(a, dev)) for k, v in tree.items()
           if k not in ("enc_blocks", "dec_blocks")}
    out["enc_blocks"] = _unstack(tree["enc_blocks"], n_enc, dev)
    out["dec_blocks"] = _unstack(tree["dec_blocks"], n_dec, dev)
    return out


def _stack(blocks: list[dict]):
    first = blocks[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in blocks]) for k in first}
    return np.stack([b.detach().cpu().numpy() for b in blocks])


def seq2seq_params_to_jax(params: dict) -> dict:
    """Port params (tensors on any device) -> the JAX package's tree with
    numpy leaves: ``enc_blocks`` / ``dec_blocks`` restacked on a leading
    layer axis (``jax.tree.map(jnp.asarray, ...)`` makes it a JAX tree)."""
    out = {k: _map(v, lambda t: t.detach().cpu().numpy())
           for k, v in params.items() if k not in ("enc_blocks", "dec_blocks")}
    out["enc_blocks"] = _stack(params["enc_blocks"])
    out["dec_blocks"] = _stack(params["dec_blocks"])
    return out


def transformer_params_from_jax(tree: dict, *, device=None) -> dict:
    """JAX ``repro.models.transformer`` params (numpy leaves) -> port params:
    ``blocks`` (a tuple of stacked dicts) becomes a tuple of per-repeat
    lists; ``tok``, ``final_norm`` and ``lm_head`` carry over as they are."""
    dev = resolve_device(device)
    out = {k: _map(v, lambda a: _tensor(a, dev)) for k, v in tree.items()
           if k != "blocks"}
    out["blocks"] = tuple(
        _unstack(stacked, len(np.asarray(stacked["norm1"]["scale"])), dev)
        for stacked in tree["blocks"])
    return out


def transformer_params_to_jax(params: dict) -> dict:
    """Port decoder-only params -> the JAX package's tree with numpy
    leaves (each pattern position's layers restacked)."""
    out = {k: _map(v, lambda t: t.detach().cpu().numpy())
           for k, v in params.items() if k != "blocks"}
    out["blocks"] = tuple(_stack(list(b)) for b in params["blocks"])
    return out
