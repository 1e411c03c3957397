"""Checkpoints in the JAX package's file layout, with no JAX and no
``msgpack`` package (``repro_torch.checkpoint.io``)."""

from repro_torch.checkpoint.io import (load_checkpoint, load_pytree,
                                       save_checkpoint, save_pytree)

__all__ = ["save_pytree", "load_pytree", "save_checkpoint", "load_checkpoint"]
