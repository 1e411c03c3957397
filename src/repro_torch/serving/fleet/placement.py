"""Replica placement: where the fleet router sends each request (the port
of ``repro.serving.fleet.placement``, pure Python).

The JAX package's sharded engine picks the data shard for an admission by
(1) prefix affinity — the shard already holding the request's cached
prefix pages — then (2) least-loaded. Across engines the same two signals
exist, just coarser: the router keeps its own radix
index over *recently committed prompt prefixes per replica* (it cannot
see the replicas' page tables, but it watched every prompt finish
somewhere), and each replica's ``/v1/stats`` probe reports its load
shape. ``place()`` combines them:

  1. **prefix affinity** — if the request's prompt extends a prefix the
     index attributes to a live replica (match depth >=
     ``min_affinity``), route there: the parent's committed pages are in
     that replica's radix page cache, so the child admission aliases
     them instead of re-prefilling. A planner's ``submit_child`` tree
     therefore stays on one replica (and, one level down, one shard)
     until that replica drains or dies.
  2. **least-loaded** — otherwise the live replica with the smallest
     ``load`` wins; ties break on shed rate (a shedding replica is
     overloaded in a way occupancy understates), then on replica id.

Placement is a PURE function of the replica views + index state: no
clocks, no randomness — given identical stats and index contents it
returns identical decisions (property-tested),
which is what makes fleet incidents replayable from a stats dump.

``ReplicaView.load`` blends the two load sources the router has: the
last health probe's occupancy ((resident + queued) / n_slots, accurate
but stale by up to a probe interval) and the router's own in-flight
count for that replica (live, but blind to traffic from other routers).
The max of the two is the conservative estimate — a burst the probe
hasn't seen yet still counts, and load reported by the replica that this
router didn't cause still counts.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Hashable, Sequence


class ReplicaHealth(str, enum.Enum):
    """Router-side view of one replica's availability. HEALTHY: place
    freely. DRAINING: the replica is finishing residents but refusing new
    work (graceful shutdown) — stop placing, don't reroute what's already
    streaming. DOWN: probes or proxied streams are failing — its cached
    prefixes are dropped from the index and nothing routes there until a
    probe succeeds again."""

    HEALTHY = "healthy"
    DRAINING = "draining"
    DOWN = "down"

    def __str__(self) -> str:
        return self.value


@dataclasses.dataclass
class ReplicaView:
    """What placement knows about one replica: the last probe's load
    shape plus the router's own live in-flight count."""

    health: ReplicaHealth = ReplicaHealth.HEALTHY
    n_slots: int = 1
    occupancy: float = 0.0   # probe: (resident + queued) / n_slots
    shed_rate: float = 0.0   # probe: shed / offered
    inflight: int = 0        # router-side: proxied, not yet terminal

    @property
    def load(self) -> float:
        """Conservative load estimate: the stale-but-global probe vs the
        live-but-local in-flight count, whichever is worse."""
        return max(self.occupancy, self.inflight / max(1, self.n_slots))


class _Node:
    """One radix-tree node. ``edge`` is the (compressed) element run from
    the parent; ``replica`` marks a committed prefix ending here (None for
    pure split nodes); ``stamp`` is the LRU touch counter."""

    __slots__ = ("edge", "children", "replica", "stamp")

    def __init__(self, edge: tuple, replica: Hashable | None, stamp: int):
        self.edge = edge
        self.children: dict = {}
        self.replica = replica
        self.stamp = stamp


class PrefixIndex:
    """Radix index over committed prompt prefixes -> owning replica.

    The router inserts every FINISHED request's prompt under the replica
    that served it; ``lookup`` walks a new prompt as deep as the tree
    matches and returns the deepest owner — the replica whose page cache
    holds the longest committed prefix of this prompt. Sequences are any
    element sequence (token-id lists and strings both work; elements are
    compared, never interpreted).

    Bounded: above ``max_nodes`` the least-recently-touched *owned leaf*
    chain is evicted — mirroring the replica-side radix page cache's
    leaf-first LRU reclaim, so the router's map ages out roughly in step
    with the pages it describes. ``drop_replica`` removes a dead
    replica's ownership wholesale (its pages died with the process)."""

    def __init__(self, max_nodes: int = 4096):
        self.root = _Node((), None, 0)
        self.max_nodes = max_nodes
        self._n = 0            # nodes excluding the root
        self._stamp = 0
        self.inserted = 0
        self.evicted = 0

    def __len__(self) -> int:
        return self._n

    def _touch(self, node: _Node) -> None:
        self._stamp += 1
        node.stamp = self._stamp

    def insert(self, seq: Sequence, replica: Hashable) -> None:
        """Record ``seq`` as a committed prefix owned by ``replica``
        (later inserts of the same prefix re-own it — the most recent
        completion knows where the pages live now)."""
        seq = tuple(seq)
        if not seq:
            return
        node, i = self.root, 0
        while i < len(seq):
            child = node.children.get(seq[i])
            if child is None:
                child = _Node(seq[i:], None, 0)
                node.children[seq[i]] = child
                self._n += 1
                node, i = child, len(seq)
                break
            edge = child.edge
            k = _common(edge, seq[i:])
            if k < len(edge):
                # split the edge: a new interior node owns the shared run
                mid = _Node(edge[:k], None, child.stamp)
                node.children[seq[i]] = mid
                child.edge = edge[k:]
                mid.children[child.edge[0]] = child
                self._n += 1
                node, i = mid, i + k
                if i == len(seq):
                    break
                continue
            node, i = child, i + k
        node.replica = replica
        self._touch(node)
        self.inserted += 1
        self._evict_over_cap()

    def lookup(self, seq: Sequence) -> tuple[Hashable | None, int]:
        """Deepest owned prefix of ``seq``: ``(replica, matched length)``
        (``(None, 0)`` when nothing matches). Touches the matched path so
        hot families survive LRU eviction."""
        seq = tuple(seq)
        node, i = self.root, 0
        best: tuple[Hashable | None, int] = (None, 0)
        while i < len(seq):
            child = node.children.get(seq[i])
            if child is None:
                break
            k = _common(child.edge, seq[i:])
            if k < len(child.edge):
                break
            node, i = child, i + k
            if node.replica is not None:
                best = (node.replica, i)
                self._touch(node)
        return best

    def drop_replica(self, replica: Hashable) -> int:
        """Forget every prefix owned by ``replica`` (the process died —
        its page cache no longer exists). Returns prefixes dropped."""
        dropped = self._drop(self.root, replica)
        self._prune(self.root)
        return dropped

    def _drop(self, node: _Node, replica: Hashable) -> int:
        n = 0
        if node.replica == replica:
            node.replica = None
            n += 1
        for child in node.children.values():
            n += self._drop(child, replica)
        return n

    def _prune(self, node: _Node) -> None:
        """Drop unowned leaf subtrees and merge single-child pass-through
        nodes back into their edges."""
        for key in list(node.children):
            child = node.children[key]
            self._prune(child)
            if not child.children and child.replica is None:
                del node.children[key]
                self._n -= 1
            elif (len(child.children) == 1 and child.replica is None):
                (grand,) = child.children.values()
                grand.edge = child.edge + grand.edge
                node.children[key] = grand
                self._n -= 1

    def _evict_over_cap(self) -> None:
        while self._n > self.max_nodes:
            leaf = self._oldest_owned_leaf(self.root)
            if leaf is None:
                return
            leaf.replica = None
            self.evicted += 1
            self._prune(self.root)

    def _oldest_owned_leaf(self, node: _Node) -> _Node | None:
        best = None
        stack = [node]
        while stack:
            cur = stack.pop()
            if cur.replica is not None and not cur.children:
                if best is None or cur.stamp < best.stamp:
                    best = cur
            stack.extend(cur.children.values())
        return best


def _common(a: tuple, b: tuple) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


def place(replicas: dict[Hashable, ReplicaView], index: PrefixIndex,
          seq: Sequence, *,
          min_affinity: int = 1) -> tuple[Hashable | None, int]:
    """Pick the replica for one request: ``(replica id | None, affinity
    match depth)``. None means no HEALTHY replica exists (the router
    answers with a retryable rejection). ``min_affinity``: minimum
    matched prefix length before affinity overrides least-loaded — below
    it the alias saves less than a page, so load spreading wins (the
    router mirrors the engine's page-boundary truncation with a length
    floor, since page geometry is a replica-side detail)."""
    alive = {i: v for i, v in replicas.items()
             if v.health == ReplicaHealth.HEALTHY}
    if not alive:
        return None, 0
    owner, depth = index.lookup(seq)
    if owner in alive and depth >= max(1, min_affinity):
        return owner, depth
    best = min(alive, key=lambda i: (alive[i].load, alive[i].shed_rate, i))
    return best, 0
