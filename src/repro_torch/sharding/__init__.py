"""Parameter sharding rules and the tensor-parallel context (the port of
``repro.sharding``)."""

from repro_torch.sharding import ctx, rules

__all__ = ["ctx", "rules"]
