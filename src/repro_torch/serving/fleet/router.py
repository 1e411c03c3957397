"""``FleetRouter``: many engine replicas behind one front door (the port of
``repro.serving.fleet.router``, pure asyncio).

N independent engine front doors
(``repro_torch.serving.server.FrontDoorServer``, typically one process per
replica) behind a single router that speaks the SAME wire protocol on
its front side. A client cannot tell the router from a lone replica:
``POST /v1/generate`` answers SSE, a ``{``-first connection speaks
NDJSON, ``/v1/cancel`` and ``/v1/stats`` work, and the event vocabulary
(``accepted`` / ``delta`` / ``done`` / ``rejected``) is unchanged except
that ``accepted`` gains a ``replica`` field and a new terminal
``status="lost"`` exists (below).

The router holds NO engine and NO model — it is a pure asyncio proxy
(one event-loop thread, zero locks) built from three pieces:

  - ``ReplicaClient`` pool (``fleet.client``): per-replica health probes
    on a fixed cadence, DOWN after ``down_after`` consecutive failures
    (or immediately on a mid-stream break), DRAINING mirrored from the
    replica's own drain flag, bounded connect retry with exponential
    backoff.
  - placement (``fleet.placement``): prefix-affinity via a router-side
    radix index over committed prompt prefixes (every FINISHED request's
    prompt is inserted under the replica that served it; a dead
    replica's entries are dropped wholesale), falling back to
    least-loaded over probe occupancy + the router's own in-flight
    counts: the two signals a sharded engine uses one level down across
    its shards.
  - the proxy loop (this module): per-request replica streams with
    rid rewriting and **failover**. The rule that keeps failover honest:

      * a request that has not yet delivered a delta to its client can
        be rerouted freely — decoding is deterministic, so restarting it
        on another replica is invisible (same tokens, same ``done``).
        Connect failures, mid-accept breaks, replica-side sheds and
        drain refusals all reroute this way (bounded by
        ``max_reroutes``), and the client sees exactly one ``accepted``
        and one terminal event no matter how many replicas were tried.
      * a request that HAS streamed deltas cannot be silently restarted
        (the client would see the prefix twice). A mid-stream replica
        death therefore surfaces as a typed, retryable terminal:
        ``{"event":"done","status":"lost","retryable":true,
        "retry_after":...}`` (``RequestStatus.LOST``). No silent drops,
        no duplicated tokens — the client owns the retry.

``/v1/stats`` aggregates the fleet: per-replica occupancy / shed_rate /
prefix_hit_rate / health plus router counters (reroutes, losses,
affinity hit rate, index size).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import threading
from typing import Sequence

from repro_torch.serving.fleet.client import (ReplicaClient,
                                              ReplicaUnavailable)
from repro_torch.serving.fleet.placement import (PrefixIndex, ReplicaHealth,
                                                 place)
from repro_torch.serving.server import (SSE_PREAMBLE, read_http,
                                        respond_json)

# replica-side refusals a not-yet-streaming request may retry elsewhere:
# a shed or drain refusal is one replica's overload statement, not the
# fleet's
_REROUTABLE_DONE = ("shed",)
_REROUTABLE_REJECT = ("draining",)


@dataclasses.dataclass
class FleetConfig:
    """Router knobs. ``port=0`` binds an ephemeral front port.

    ``probe_interval_s``: health-probe cadence per replica.
    ``down_after``: consecutive probe failures before a replica is DOWN
    (mid-stream breaks mark DOWN immediately). ``connect_retries`` /
    ``retry_backoff_s``: bounded dial retry before a connect counts as a
    failure. ``max_reroutes``: failover budget per request — beyond it
    the request terminates ``lost`` even if it never streamed.
    ``min_affinity``: minimum matched prefix length before affinity
    overrides least-loaded. ``index_max_nodes``: prefix-index LRU bound.
    ``lost_retry_after`` / ``no_replica_retry_after``: retry hints on
    the two router-generated refusals."""

    host: str = "127.0.0.1"
    port: int = 0
    probe_interval_s: float = 0.25
    probe_timeout_s: float = 5.0
    down_after: int = 2
    connect_retries: int = 2
    retry_backoff_s: float = 0.05
    max_reroutes: int = 4
    min_affinity: int = 1
    index_max_nodes: int = 4096
    lost_retry_after: float = 1.0
    no_replica_retry_after: float = 5.0


class _Route:
    """Loop-thread bookkeeping for one in-flight proxied request."""

    __slots__ = ("client", "replica_rid", "cancelled")

    def __init__(self):
        self.client: ReplicaClient | None = None
        self.replica_rid: int | None = None
        self.cancelled = False


class FleetRouter:
    """The fleet front door. ``start()`` spawns the event-loop thread
    and the probe task; ``shutdown()`` stops them. Replica processes are
    NOT owned by the router — spawn/kill them independently (see
    ``fleet.replica.spawn_replicas``); the router discovers their state
    through probes."""

    def __init__(self, replicas: Sequence[tuple[str, int]],
                 config: FleetConfig | None = None):
        self.cfg = config or FleetConfig()
        self.port: int | None = None
        self.index = PrefixIndex(max_nodes=self.cfg.index_max_nodes)
        self.clients: dict[int, ReplicaClient] = {
            i: ReplicaClient(
                i, host, port,
                connect_retries=self.cfg.connect_retries,
                retry_backoff_s=self.cfg.retry_backoff_s,
                probe_timeout_s=self.cfg.probe_timeout_s,
                down_after=self.cfg.down_after,
                on_down=self._on_replica_down)
            for i, (host, port) in enumerate(replicas)}
        # counters (loop thread only)
        self.n_requests = 0
        self.n_rerouted = 0       # requests that failed over at least once
        self.n_reroutes = 0       # individual failover hops
        self.n_reroute_ok = 0     # rerouted requests that still FINISHED
        self.n_lost = 0
        self.n_no_replica = 0
        self.n_placements = 0
        self.n_affinity_hits = 0
        self._rid = 0
        self._routes: dict[int, _Route] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.AbstractServer | None = None
        self._probe_task: asyncio.Task | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._closed = False

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FleetRouter":
        self._thread = threading.Thread(target=self._run_loop,
                                        name="fleet-router", daemon=True)
        self._thread.start()
        self._started.wait(timeout=10.0)
        if self.port is None:
            raise RuntimeError("fleet router failed to bind "
                               f"{self.cfg.host}:{self.cfg.port}")
        return self

    def _run_loop(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def boot():
            self._server = await asyncio.start_server(
                self._handle_conn, self.cfg.host, self.cfg.port)
            self.port = self._server.sockets[0].getsockname()[1]
            self._probe_task = asyncio.ensure_future(self._probe_loop())
            self._started.set()

        self._loop.run_until_complete(boot())
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    def shutdown(self) -> None:
        if self._closed or self._loop is None:
            return
        self._closed = True
        loop = self._loop

        async def _close():
            if self._server is not None:
                self._server.close()
            tasks = [t for t in asyncio.all_tasks()
                     if t is not asyncio.current_task()]
            for t in tasks:           # probe loop + live proxies
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            await asyncio.sleep(0)    # let transport-close callbacks run
            loop.stop()

        asyncio.run_coroutine_threadsafe(_close(), loop)
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def stats(self, *, fresh: bool = False) -> dict:
        """Thread-safe aggregated fleet stats (what ``/v1/stats``
        serves). ``fresh=True`` probes every replica first."""
        fut = asyncio.run_coroutine_threadsafe(
            self._stats(fresh=fresh), self._loop)
        return fut.result(timeout=30.0)

    # ------------------------------------------------------------- probing
    async def _probe_loop(self) -> None:
        while True:
            await asyncio.gather(
                *(c.probe() for c in self.clients.values()))
            await asyncio.sleep(self.cfg.probe_interval_s)

    def _on_replica_down(self, cid: int) -> None:
        """A replica died: its page cache died with it, so every prefix
        the index attributes to it is stale — drop them all."""
        self.index.drop_replica(cid)

    # ----------------------------------------------------- front-side wire
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            first = await reader.read(1)
            if not first:
                return
            if first == b"{":
                line = first + await reader.readline()
                await self._serve_ndjson(json.loads(line), writer)
            else:
                await self._serve_http(first, reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError,
                json.JSONDecodeError, UnicodeDecodeError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _serve_http(self, first: bytes, reader, writer) -> None:
        method, path, _, body = await read_http(first, reader)
        if method == "POST" and path == "/v1/generate":
            writer.write(SSE_PREAMBLE)
            await self._proxy(json.loads(body or b"{}"), writer, sse=True)
        elif method == "POST" and path == "/v1/cancel":
            req = json.loads(body or b"{}")
            self._cancel(int(req["rid"]))
            respond_json(writer, {"ok": True, "rid": int(req["rid"])})
        elif method == "GET" and path == "/v1/stats":
            respond_json(writer, await self._stats())
        else:
            respond_json(writer, {"error": "not found"}, status=404)
        await _flush(writer)

    async def _serve_ndjson(self, req: dict, writer) -> None:
        op = req.get("op", "generate")
        if op == "generate":
            await self._proxy(req, writer, sse=False)
        elif op == "cancel":
            self._cancel(int(req["rid"]))
            writer.write(json.dumps({"ok": True}).encode() + b"\n")
        elif op == "stats":
            writer.write(json.dumps(await self._stats()).encode() + b"\n")
        await _flush(writer)

    async def _send(self, writer, sse: bool, ev: dict) -> None:
        line = json.dumps(ev, separators=(",", ":")).encode()
        writer.write(b"data: " + line + b"\n\n" if sse else line + b"\n")
        await writer.drain()

    # ------------------------------------------------------------ the proxy
    async def _proxy(self, req: dict, writer, *, sse: bool) -> None:
        """Serve one generate request: place, stream, fail over."""
        if "query" not in req:
            await self._send(writer, sse,
                             {"event": "rejected", "error": "bad_request",
                              "detail": "missing query"})
            return
        self.n_requests += 1
        self._rid += 1
        rid = self._rid
        seq = _seq_key(req["query"])
        fwd = {k: v for k, v in req.items() if k != "op"}
        fwd["op"] = "generate"

        route = _Route()
        self._routes[rid] = route
        tried: set[int] = set()
        accepted_sent = False
        streamed = False          # any delta delivered to the client?
        rerouted = False
        finished = False
        try:
            while True:
                target = self._place(seq, exclude=tried)
                if (target is None
                        or len(tried) > self.cfg.max_reroutes):
                    await self._give_up(writer, sse, rid, accepted_sent,
                                        tried)
                    return
                client = self.clients[target]
                tried.add(target)
                if len(tried) > 1:
                    self.n_reroutes += 1
                    if not rerouted:
                        rerouted = True
                        self.n_rerouted += 1
                outcome = await self._attempt(
                    client, fwd, writer, sse, rid, route,
                    accepted_sent=accepted_sent, streamed=streamed)
                accepted_sent = outcome["accepted_sent"]
                streamed = outcome["streamed"]
                if outcome["kind"] == "reroute":
                    route.client = route.replica_rid = None
                    continue
                if outcome["kind"] == "lost":
                    self.n_lost += 1
                    await self._send(
                        writer, sse,
                        {"event": "done", "rid": rid, "status": "lost",
                         "retryable": True,
                         "retry_after": self.cfg.lost_retry_after,
                         "replica": client.id,
                         "reroutes": len(tried) - 1})
                    return
                finished = outcome["kind"] == "finished"
                if finished:
                    self.index.insert(seq, client.id)
                    if rerouted:
                        self.n_reroute_ok += 1
                return
        except ConnectionError:
            # the CLIENT went away: stop the replica-side work too
            if route.client is not None and route.replica_rid is not None:
                asyncio.ensure_future(route.client.send_oneshot(
                    {"op": "cancel", "rid": route.replica_rid}))
        finally:
            self._routes.pop(rid, None)

    async def _attempt(self, client: ReplicaClient, fwd: dict, writer,
                       sse: bool, rid: int, route: _Route, *,
                       accepted_sent: bool, streamed: bool) -> dict:
        """One replica attempt. Returns ``{"kind": "finished" | "done" |
        "reroute" | "lost", "accepted_sent": ..., "streamed": ...}`` —
        ``done`` is any non-finished terminal already forwarded to the
        client (cancelled / expired / shed passed through / rejected)."""

        def out(kind):
            return {"kind": kind, "accepted_sent": accepted_sent,
                    "streamed": streamed}

        try:
            r_reader, r_writer = await client.open_stream(fwd)
        except ReplicaUnavailable:
            client.mark_down()
            return out("reroute")
        completed = False
        try:
            while True:
                try:
                    line = await r_reader.readline()
                except (ConnectionError, OSError):
                    line = b""
                if not line:
                    # replica died mid-stream: fail fast, then either
                    # reroute (nothing streamed) or surface LOST
                    client.mark_down()
                    return out("lost" if streamed else "reroute")
                if not line.strip():
                    continue
                ev = json.loads(line)
                kind = ev.get("event")
                if kind == "accepted":
                    route.client = client
                    route.replica_rid = int(ev["rid"])
                    if route.cancelled:
                        await client.send_oneshot(
                            {"op": "cancel", "rid": route.replica_rid})
                    if not accepted_sent:
                        accepted_sent = True
                        await self._send(
                            writer, sse,
                            {**ev, "rid": rid, "replica": client.id})
                elif kind == "delta":
                    streamed = True
                    await self._send(writer, sse, {**ev, "rid": rid})
                elif kind == "done":
                    status = ev.get("status")
                    if (status in _REROUTABLE_DONE and not streamed
                            and not route.cancelled
                            and self._has_alternative(client.id)):
                        return out("reroute")
                    completed = status == "finished"
                    await self._send(
                        writer, sse,
                        {**ev, "rid": rid, "replica": client.id})
                    return out("finished" if completed else "done")
                elif kind == "rejected":
                    if (ev.get("error") in _REROUTABLE_REJECT
                            and not route.cancelled
                            and self._has_alternative(client.id)):
                        return out("reroute")
                    await self._send(writer, sse, ev)
                    return out("done")
        finally:
            client.stream_closed(completed=completed)
            try:
                r_writer.close()
            except Exception:
                pass

    def _place(self, seq, *, exclude: set[int]) -> int | None:
        views = {i: c.view for i, c in self.clients.items()
                 if i not in exclude}
        target, depth = place(views, self.index, seq,
                              min_affinity=self.cfg.min_affinity)
        if target is not None:
            self.n_placements += 1
            if depth > 0:
                self.n_affinity_hits += 1
        return target

    def _has_alternative(self, cid: int) -> bool:
        return any(c.view.health == ReplicaHealth.HEALTHY
                   for i, c in self.clients.items() if i != cid)

    async def _give_up(self, writer, sse: bool, rid: int,
                       accepted_sent: bool, tried: set[int]) -> None:
        """No replica left to try. Before any ``accepted``: a retryable
        ``rejected`` (the request never existed). After: a LOST terminal
        (the rid is real and owes exactly one terminal event)."""
        if accepted_sent:
            self.n_lost += 1
            await self._send(
                writer, sse,
                {"event": "done", "rid": rid, "status": "lost",
                 "retryable": True,
                 "retry_after": self.cfg.no_replica_retry_after,
                 "reroutes": max(0, len(tried) - 1)})
        else:
            self.n_no_replica += 1
            await self._send(
                writer, sse,
                {"event": "rejected", "error": "no_replica",
                 "retry_after": self.cfg.no_replica_retry_after})

    # --------------------------------------------------------------- cancel
    def _cancel(self, rid: int) -> None:
        route = self._routes.get(rid)
        if route is None:
            return
        route.cancelled = True
        if route.client is not None and route.replica_rid is not None:
            asyncio.ensure_future(route.client.send_oneshot(
                {"op": "cancel", "rid": route.replica_rid}))

    # ---------------------------------------------------------------- stats
    async def _stats(self, *, fresh: bool = False) -> dict:
        if fresh:
            await asyncio.gather(
                *(c.probe() for c in self.clients.values()))
        reps = {str(i): c.describe() for i, c in self.clients.items()}
        healthy = [c for c in self.clients.values()
                   if c.view.health == ReplicaHealth.HEALTHY]
        return {
            "fleet": True,
            "replicas": reps,
            "n_replicas": len(self.clients),
            "n_healthy": len(healthy),
            "accepting": bool(healthy),
            "occupancy": (sum(c.view.occupancy for c in healthy)
                          / max(1, len(healthy))),
            "shed_rate": (sum(c.view.shed_rate for c in healthy)
                          / max(1, len(healthy))),
            "requests": self.n_requests,
            "rerouted": self.n_rerouted,
            "reroutes": self.n_reroutes,
            "reroute_ok": self.n_reroute_ok,
            "lost": self.n_lost,
            "no_replica": self.n_no_replica,
            "placements": self.n_placements,
            "affinity_hits": self.n_affinity_hits,
            "prefix_hit_rate": (self.n_affinity_hits
                                / max(1, self.n_placements)),
            "index": {"size": len(self.index),
                      "inserted": self.index.inserted,
                      "evicted": self.index.evicted},
        }


def _seq_key(query) -> tuple:
    """The placement sequence for a request's query: element tuples for
    token-id lists, character tuples for strings — whatever form, a
    child prompt that extends a parent prompt extends its key."""
    if isinstance(query, str):
        return tuple(query)
    return tuple(int(x) for x in query)


async def _flush(writer) -> None:
    try:
        await writer.drain()
    except ConnectionError:
        pass
