"""Fleet serving: N engine replicas behind one wire-compatible router.

``FleetRouter`` (``fleet.router``) is the front door; ``ReplicaClient``
(``fleet.client``) its per-replica health/stream pool; placement policy
and the prefix-affinity radix index live in ``fleet.placement``;
``fleet.replica`` is the replica subprocess entry point
(``python -m repro_torch.serving.fleet.replica``) plus the
``spawn_replicas`` helper. The port of ``repro.serving.fleet``: host code
only, over the port's ``FrontDoorServer``.
"""

from repro_torch.serving.fleet.client import (ReplicaClient,
                                              ReplicaUnavailable)
from repro_torch.serving.fleet.placement import (PrefixIndex, ReplicaHealth,
                                                 ReplicaView, place)
from repro_torch.serving.fleet.replica import spawn_replicas, stop_replicas
from repro_torch.serving.fleet.router import FleetConfig, FleetRouter

__all__ = [
    "FleetConfig", "FleetRouter", "PrefixIndex", "ReplicaClient",
    "ReplicaHealth", "ReplicaUnavailable", "ReplicaView", "place",
    "spawn_replicas", "stop_replicas",
]
