"""``ReplicaClient``: the router's view of one engine front door (the port
of ``repro.serving.fleet.client``, pure asyncio).

One instance per replica, living entirely on the router's asyncio loop
(no locks). It owns three things:

  - **connections**: ``open_stream()`` dials the replica's front door and
    speaks the JSON-lines framing (one request object out, NDJSON events
    back) with bounded connect retry + exponential backoff — a replica
    mid-GC or mid-accept-queue hiccup is retried in place; a dead one
    fails fast so the router reroutes.
  - **health**: ``probe()`` polls ``{"op":"stats"}``; consecutive failures
    past ``down_after`` flip the view to DOWN (and notify the router so
    the prefix index forgets the replica's pages), a success flips it
    back to HEALTHY/DRAINING per the replica's own accepting/draining
    flags. ``mark_down()`` is the fail-fast path for mid-stream breaks —
    placement must stop choosing a corpse before the next probe tick.
  - **load accounting**: the ``ReplicaView`` placement reads — probe
    occupancy/shed stats plus the router's own in-flight count.
"""

from __future__ import annotations

import asyncio
import json
from typing import Callable

from repro_torch.serving.fleet.placement import ReplicaHealth, ReplicaView


class ReplicaUnavailable(ConnectionError):
    """Raised by ``open_stream`` when every connect attempt failed —
    the router's cue to reroute the request to another replica."""


class ReplicaClient:
    def __init__(self, cid: int, host: str, port: int, *,
                 connect_retries: int = 2, retry_backoff_s: float = 0.05,
                 probe_timeout_s: float = 5.0, down_after: int = 2,
                 on_down: Callable[[int], None] | None = None):
        self.id = cid
        self.host = host
        self.port = port
        self.connect_retries = connect_retries
        self.retry_backoff_s = retry_backoff_s
        self.probe_timeout_s = probe_timeout_s
        self.down_after = down_after
        self.on_down = on_down
        self.view = ReplicaView()
        self.last_stats: dict = {}
        self.failures = 0        # consecutive probe failures
        self.n_submitted = 0
        self.n_completed = 0

    # ------------------------------------------------------------- streams
    async def connect(self) -> tuple[asyncio.StreamReader,
                                     asyncio.StreamWriter]:
        """Dial the replica with bounded retry + exponential backoff."""
        backoff = self.retry_backoff_s
        for attempt in range(self.connect_retries + 1):
            try:
                return await asyncio.open_connection(self.host, self.port)
            except OSError:
                if attempt == self.connect_retries:
                    break
                await asyncio.sleep(backoff)
                backoff *= 2
        raise ReplicaUnavailable(
            f"replica {self.id} ({self.host}:{self.port}) unreachable "
            f"after {self.connect_retries + 1} attempts")

    async def open_stream(self, req: dict) -> tuple[asyncio.StreamReader,
                                                    asyncio.StreamWriter]:
        """Open one proxied request: connect, send the NDJSON request
        object, return the (reader, writer) the caller iterates events
        from. The in-flight count bumps here and drops in
        ``stream_closed`` — placement sees the booking immediately, not
        at the next probe."""
        reader, writer = await self.connect()
        writer.write(json.dumps(req, separators=(",", ":")).encode()
                     + b"\n")
        await writer.drain()
        self.view.inflight += 1
        self.n_submitted += 1
        return reader, writer

    def stream_closed(self, *, completed: bool) -> None:
        self.view.inflight = max(0, self.view.inflight - 1)
        if completed:
            self.n_completed += 1

    async def send_oneshot(self, op: dict) -> dict | None:
        """Fire one op (cancel, stats) and read the single reply line;
        None on any transport failure — one-shots never reroute."""
        try:
            reader, writer = await asyncio.wait_for(
                self.connect(), timeout=self.probe_timeout_s)
        except (ReplicaUnavailable, asyncio.TimeoutError):
            return None
        try:
            writer.write(json.dumps(op, separators=(",", ":")).encode()
                         + b"\n")
            await writer.drain()
            line = await asyncio.wait_for(reader.readline(),
                                          timeout=self.probe_timeout_s)
            return json.loads(line) if line.strip() else None
        except (OSError, asyncio.TimeoutError, json.JSONDecodeError):
            return None
        finally:
            try:
                writer.close()
            except Exception:
                pass

    # -------------------------------------------------------------- health
    async def probe(self) -> dict | None:
        """One health probe: the replica's ``stats`` op. Updates the view
        and returns the stats dict (None on failure)."""
        stats = await self.send_oneshot({"op": "stats"})
        if stats is None:
            self.probe_fail()
            return None
        self.probe_ok(stats)
        return stats

    def probe_ok(self, stats: dict) -> None:
        self.failures = 0
        self.last_stats = stats
        self.view.n_slots = int(stats.get("n_slots", self.view.n_slots)
                                or 1)
        self.view.occupancy = float(stats.get("occupancy", 0.0))
        self.view.shed_rate = float(stats.get("shed_rate", 0.0))
        draining = (stats.get("draining", False)
                    or not stats.get("accepting", True))
        self.view.health = (ReplicaHealth.DRAINING if draining
                            else ReplicaHealth.HEALTHY)

    def probe_fail(self) -> None:
        self.failures += 1
        if (self.failures >= self.down_after
                and self.view.health != ReplicaHealth.DOWN):
            self._down()

    def mark_down(self) -> None:
        """Fail fast on a mid-stream break: don't wait ``down_after``
        probes to stop placing onto a dead process. A later successful
        probe resurrects it (fresh process, empty caches — the index
        entries were already dropped)."""
        self.failures = max(self.failures, self.down_after)
        if self.view.health != ReplicaHealth.DOWN:
            self._down()

    def _down(self) -> None:
        self.view.health = ReplicaHealth.DOWN
        self.view.inflight = 0   # every proxied stream is about to break
        if self.on_down is not None:
            self.on_down(self.id)

    def describe(self) -> dict:
        v = self.view
        return {
            "addr": f"{self.host}:{self.port}",
            "health": str(v.health),
            "n_slots": v.n_slots,
            "occupancy": v.occupancy,
            "shed_rate": v.shed_rate,
            "inflight": v.inflight,
            "load": v.load,
            "submitted": self.n_submitted,
            "completed": self.n_completed,
            "probe_failures": self.failures,
            "prefix_hit_rate": float(
                (self.last_stats.get("prefix_stats") or {})
                .get("prefix_hit_rate", 0.0)),
        }
