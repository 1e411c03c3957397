"""Name-based parameter sharding rules, the port of ``repro.sharding.rules``.

Parameter leaf names are a contract with the model code: the rules map each
leaf to a spec over the mesh axes, then drop any axis assignment whose
dimension does not divide by the axis size (GQA KV projections with 8
heads on a 16-way model axis stay whole, as do vocabularies such as
HuBERT's 504).

A spec is a plain tuple with one entry per tensor dim: a mesh-axis name, a
tuple of names, or None (the port's counterpart of ``PartitionSpec``). The
port's per-layer lists carry no scan-repeat dim, so no leading None is
added for one, and an MoE leaf's expert dim is its dim 0.

The rules read only the mesh's axis names and sizes (``axis_sizes``): a
``DeviceMesh`` over a live world, a ``repro_torch.launch.mesh.MeshShape``
with no process group, or a plain ``{axis: size}`` dict.
"""

from __future__ import annotations

import math

import torch

MODEL = "model"

# last name -> spec on the trailing dims of the leaf
_RULES_2D: dict[str, tuple] = {
    "embed": (MODEL, None),          # (vocab, d): shard the vocabulary
    "w_vocab": (None, MODEL),        # (d, vocab)
}

# (parent, leaf) -> trailing spec
_PARENT_RULES: dict[tuple, tuple] = {
    ("wq", "w"): (None, MODEL), ("wq", "b"): (MODEL,),
    ("wk", "w"): (None, MODEL), ("wk", "b"): (MODEL,),
    ("wv", "w"): (None, MODEL), ("wv", "b"): (MODEL,),
    ("wg", "w"): (None, MODEL), ("wg", "b"): (MODEL,),
    ("wr", "w"): (None, MODEL), ("wr", "b"): (MODEL,),
    ("wo", "w"): (MODEL, None), ("wo", "b"): (None,),
    ("w_in", "w"): (None, MODEL), ("w_in", "b"): (MODEL,),
    ("w_gate", "w"): (None, MODEL), ("w_gate", "b"): (MODEL,),
    ("w_out", "w"): (MODEL, None), ("w_out", "b"): (None,),
    ("w_xdbc", "w"): (MODEL, None),
    ("w_dt", "w"): (None, MODEL), ("w_dt", "b"): (MODEL,),
    ("w_lora_a", "w"): (None, None),
    ("w_lora_b", "w"): (None, None),
    ("router", "w"): (None, None),   # the router is tiny: replicate
}

_NAME_RULES: dict[str, tuple] = {
    "conv_w": (None, MODEL),
    "conv_b": (MODEL,),
    "A_log": (MODEL, None),
    "D": (MODEL,),
    "u": (MODEL, None),
}


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, a ``MeshShape`` or a
    dict, in axis order."""
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                      # torch DeviceMesh
        return {str(n): int(s) for n, s in zip(names, tuple(mesh.shape))}
    return {str(k): int(v) for k, v in dict(mesh.shape).items()}


def axes_size(mesh, axes) -> int:
    """Product of the sizes of ``axes`` (a name, a tuple of names, or
    None/() for 1)."""
    if not axes:
        return 1
    sizes = axis_sizes(mesh)
    axes = axes if isinstance(axes, tuple) else (axes,)
    return math.prod(sizes[a] for a in axes)


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a params tree of dicts, lists and tuples;
    ``path`` holds the dict keys and sequence indices from the root."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def path_names(path) -> list[str]:
    return [str(k) for k in path]


def _base_spec(names: list[str], ndim: int) -> tuple:
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if (parent, leaf) in _PARENT_RULES:
        spec = _PARENT_RULES[(parent, leaf)]
    elif leaf in _NAME_RULES:
        spec = _NAME_RULES[leaf]
    elif leaf in _RULES_2D:
        spec = _RULES_2D[leaf]
    else:
        spec = ()   # norms, gates, mixes: replicate
    spec = (None,) * (ndim - len(spec)) + tuple(spec)
    # expert-parallel: leaves under "experts" shard their expert dim (dim
    # 0: no scan-repeat dim here) over MODEL and replicate the rest
    if "experts" in names:
        spec = tuple(MODEL if i == 0 else None for i in range(ndim))
    return spec


def _fit_to_shape(spec: tuple, shape, mesh) -> tuple:
    return tuple(None if ax is None or dim % axes_size(mesh, ax) else ax
                 for dim, ax in zip(shape, spec))


def leaf_pspec(path, shape, mesh, *, fsdp_axes: tuple = ()) -> tuple:
    """The spec of one leaf at ``path`` (dict keys and sequence indices)
    with ``shape``."""
    names = path_names(path)
    shape = tuple(shape)
    spec = list(_fit_to_shape(_base_spec(names, len(shape)), shape, mesh))
    fsdp_axes = tuple(fsdp_axes)
    # the JAX package stacks a layer group's leaves on a scan-repeat dim
    # and shards leaves of 2 dims or more: here that is 1 dim or more
    stacked = any(n in ("blocks", "enc_blocks", "dec_blocks") for n in names)
    if fsdp_axes and len(shape) + stacked >= 2:
        size = axes_size(mesh, fsdp_axes)
        cands = [(shape[i], i) for i in range(len(shape))
                 if spec[i] is None and shape[i] % size == 0]
        if cands:
            _, i = max(cands)
            spec[i] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
    return tuple(spec)


def param_pspecs(params, mesh, *, fsdp_axes: tuple = ()):
    """A spec tree mirroring ``params`` (tensors, or anything with
    ``.shape``: ``torch.empty(..., device="meta")`` plans a model no card
    could hold).

    ``fsdp_axes``: also shard the largest still-replicated dim of every
    leaf of 2 dims or more (counting a layer group's scan-repeat dim, as
    the JAX package's stacked leaves have it) over these axes
    (ZeRO-3-style fully sharded params)."""
    return tree_map_with_path(
        lambda path, leaf: leaf_pspec(path, leaf.shape, mesh,
                                      fsdp_axes=fsdp_axes), params)


def param_shardings(params, mesh, *, fsdp_axes: tuple = ()):
    """The spec tree (the port lays tensors out from specs itself:
    ``shard_tensor``)."""
    return param_pspecs(params, mesh, fsdp_axes=fsdp_axes)


def split_dims(spec: tuple, axis: str) -> list[int]:
    """The tensor dims ``spec`` splits over ``axis``."""
    return [i for i, ax in enumerate(spec)
            if ax == axis or (isinstance(ax, tuple) and axis in ax)]


def shard_tensor(t: torch.Tensor, spec: tuple, axis: str, index: int,
                 size: int) -> torch.Tensor:
    """Shard ``index`` of ``size`` of ``t`` along the dims ``spec`` splits
    over ``axis`` (equal contiguous chunks: the dims divide, by
    ``_fit_to_shape``), a view."""
    for d in split_dims(spec, axis):
        n = t.shape[d] // size
        t = t.narrow(d, index * n, n)
    return t
