"""The network front door: an asyncio server over ``StreamingEngine`` (the
port of ``repro.serving.server``; the wire protocol is byte for byte the
JAX package's).

Production traffic arrives over a socket and misbehaves — this module is
the overload-robust boundary between that traffic and the engine's
single-threaded serving loop:

  - **Transport**: submit / stream / cancel over HTTP/1.1 **SSE**
    (``POST /v1/generate`` answers ``text/event-stream``; every event is
    one JSON line in a ``data:`` frame) plus a raw **JSON-lines** framing
    on the same port for gRPC-style streaming clients (first byte ``{``:
    one request object in, newline-delimited event objects out — the
    framing a bidi-streaming gRPC servicer would wrap). Pure stdlib
    asyncio: no server dependency enters the project.
  - **Dedicated drive thread**: ALL engine interaction (submit, cancel,
    pump, delta collection) happens on one thread driving
    ``serve_steps()`` — the event loop only parses sockets and writes
    events. Commands cross via a thread-safe queue; events cross back via
    ``loop.call_soon_threadsafe`` into per-connection queues.
  - **Backpressure**: each connection buffers at most
    ``ServerConfig.max_buffered_events`` undelivered events. TCP pressure
    propagates naturally (the writer awaits ``drain()``, stops consuming,
    the queue fills) and a consumer that falls a full buffer behind the
    decode stream is disconnected and its request cancelled — one slow
    reader can neither stall the drive thread nor grow memory without
    bound (``n_slow_disconnects`` counts them).
  - **Per-tenant admission quotas**: ``ServerConfig.tenant_quota`` caps a
    tenant's in-flight requests at the server boundary; excess
    submissions get a ``rejected`` event with ``retry_after`` and never
    reach the engine.
  - **Per-tenant rate limits**: ``ServerConfig.tenant_rate`` is a
    token-bucket on submissions/second (burst size
    ``ServerConfig.tenant_burst``), complementing the in-flight quota —
    a quota caps concurrency, the bucket caps arrival *rate*, and a
    planner that hammers the door between its own requests' completions
    is throttled even though it never holds more than one slot. A
    rate-limited submission gets a ``rejected`` event whose
    ``retry_after`` is the bucket's actual refill time (when one whole
    token will next be available), so a compliant client retries exactly
    when it can succeed.
  - **Graceful drain** (``shutdown(drain=True)``): stop accepting (new
    connections get 503 + retry hint), shed the queued backlog through
    the scheduler's SHED path (each waiter receives a terminal ``done``
    event with ``status="shed"`` and ``retry_after``), and keep pumping
    until residents finish token-identically.

Wire events (one JSON object per SSE ``data:`` frame / NDJSON line):

  {"event":"accepted", "rid":7, "status":"queued"}
  {"event":"delta",    "rid":7, "tokens":[12,99,3]}
  {"event":"done",     "rid":7, "status":"finished", "tokens":[[...]],
                       "lengths":[...], "logprobs":[...], "text":"..."}
  {"event":"done",     "rid":8, "status":"shed", "retry_after":24.0}
  {"event":"rejected", "error":"quota", "tenant":"t1", "retry_after":1.0}
  {"event":"rejected", "error":"rate",  "tenant":"t1", "retry_after":0.4}

Request fields (``POST /v1/generate`` JSON body, or the NDJSON object
with ``"op":"generate"``): ``query`` (string, or a list of token ids for
tokenizer-less sessions), ``mode``, ``priority``, ``timeout`` (relative
deadline in serving-clock units — the server stamps the absolute
deadline at submission), ``tenant``, and the ``GenerationParams`` knobs
(``max_new``/``draft_len``/``n_drafts``/``n_beams``/``stop_ids``).
``{"op":"cancel","rid":N}`` / ``POST /v1/cancel`` aborts; ``GET
/v1/stats`` reports server + scheduler counters.

Delta streams are byte-identical to ``RequestHandle.stream()``: both
read the same engine stream sink, so the concatenated ``delta`` token
lists equal the handle's concatenated arrays exactly
(the port's server tests assert it end to end).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import math
import queue
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.serving.api import (GenerationParams, RequestSpec,
                                     RequestStatus)
from repro_torch.serving.scheduler import SlotResult


@dataclasses.dataclass
class ServerConfig:
    """Front-door knobs. ``port=0`` binds an ephemeral port (read it from
    ``FrontDoorServer.port`` after ``start()``).

    ``realtime``: drive clock for the engine pump — wall-clock seconds
    (production) vs decode-step counts (deterministic tests/benchmarks).
    ``max_buffered_events``: per-connection backpressure bound; a consumer
    that falls this many events behind is disconnected (and its request
    cancelled). ``tenant_quota``: max in-flight requests per tenant — an
    int applies to every tenant, a dict sets per-tenant caps (missing
    tenants unlimited); None disables quotas. ``quota_retry_after``: the
    retry hint attached to quota rejections. ``tenant_rate``: token-bucket
    rate limit in submissions/second — an int/float applies to every
    tenant, a dict sets per-tenant rates (missing tenants unlimited);
    None disables rate limiting. ``tenant_burst``: bucket capacity in
    whole submissions (same scalar-or-dict shape; default: one second's
    worth of tokens, at least 1) — a burst this size passes at line rate
    before the limiter bites. ``drain_retry_after``: the
    hint attached to 503s while draining. ``default_timeout_s``: deadline
    applied to requests whose client set no ``timeout`` (serving-clock
    seconds, stamped absolute at submission exactly like a client
    timeout); None keeps untimed requests unbounded. ``writer_delay_s``:
    test-only artificial consumer slowness injected before each event
    write."""

    host: str = "127.0.0.1"
    port: int = 0
    realtime: bool = True
    max_buffered_events: int = 256
    tenant_quota: dict[str, int] | int | None = None
    quota_retry_after: float = 1.0
    tenant_rate: dict[str, float] | float | None = None
    tenant_burst: dict[str, float] | float | None = None
    drain_retry_after: float = 5.0
    default_timeout_s: float | None = None
    writer_delay_s: float = 0.0


_PARAM_KEYS = ("max_new", "draft_len", "n_drafts", "n_beams")

# shared transport helpers — the fleet router (serving.fleet.router)
# speaks the identical wire protocol on its front side, so the HTTP/SSE
# plumbing lives at module level rather than on the server class

SSE_PREAMBLE = (b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: text/event-stream\r\n"
                b"Cache-Control: no-cache\r\n"
                b"Connection: close\r\n\r\n")


async def read_http(first: bytes, reader) -> tuple[str, str, dict, bytes]:
    """Parse one HTTP/1.1 request (whose first byte was already read):
    ``(method, path, lower-cased headers, body)``."""
    head = first + await reader.readuntil(b"\r\n\r\n")
    req_line, *header_lines = head.decode("latin-1").split("\r\n")
    method, path, _ = (req_line.split(" ") + ["", ""])[:3]
    headers = {}
    for h in header_lines:
        if ":" in h:
            k, v = h.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    body = b""
    n = int(headers.get("content-length", 0) or 0)
    if n:
        body = await reader.readexactly(n)
    return method, path, headers, body


def respond_json(writer, payload: dict, status: int = 200) -> None:
    """One-shot JSON response. 503s with a ``retry_after`` additionally
    carry it as a standard ``Retry-After`` header (RFC 9110 §10.2.3
    delta-seconds, rounded UP so a compliant client never retries before
    the JSON body's float hint)."""
    body = json.dumps(payload).encode()
    reason = {200: "OK", 404: "Not Found",
              503: "Service Unavailable"}.get(status, "OK")
    extra = ""
    if status == 503 and payload.get("retry_after") is not None:
        extra = (f"Retry-After: "
                 f"{math.ceil(float(payload['retry_after']))}\r\n")
    writer.write(
        f"HTTP/1.1 {status} {reason}\r\n"
        f"Content-Type: application/json\r\n"
        f"Content-Length: {len(body)}\r\n"
        f"{extra}"
        f"Connection: close\r\n\r\n".encode() + body)


def parse_spec(req: dict) -> RequestSpec:
    """Build the canonical ``RequestSpec`` from a wire request (deadline
    stays relative here; the drive thread stamps it absolute)."""
    query = req["query"]
    if isinstance(query, list):
        query = np.asarray(query, np.int32)
    params = GenerationParams(
        **{k: req[k] for k in _PARAM_KEYS if req.get(k) is not None},
        stop_ids=tuple(req.get("stop_ids", ())))
    return RequestSpec(query=query, params=params, mode=req.get("mode"),
                       priority=int(req.get("priority", 0)),
                       deadline=None, tenant=req.get("tenant"))


class _TokenBucket:
    """Per-tenant submission rate limiter (drive thread only). Classic
    token bucket: ``rate`` tokens/second refill up to ``burst``; one whole
    token buys one submission. ``take()`` returns 0.0 on success or the
    exact time until a whole token will exist — the ``retry_after`` a
    rejected client should honor."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.level = self.burst
        self.t: float | None = None

    def take(self, now: float) -> float:
        if self.t is None:
            self.t = now
        self.level = min(self.burst, self.level + (now - self.t) * self.rate)
        self.t = now
        if self.level >= 1.0:
            self.level -= 1.0
            return 0.0
        return (1.0 - self.level) / self.rate


class _Conn:
    """Loop-thread view of one streaming connection: the bounded event
    queue the drive thread fills (via ``call_soon_threadsafe``) and the
    writer task drains. ``None`` in the queue is the close sentinel."""

    def __init__(self, server: "FrontDoorServer", sse: bool):
        self.server = server
        self.sse = sse
        self.q: asyncio.Queue = asyncio.Queue(
            maxsize=max(1, server.cfg.max_buffered_events))
        self.dead = False
        self.rid: int | None = None

    def encode(self, ev: dict) -> bytes:
        line = json.dumps(ev, separators=(",", ":")).encode()
        return b"data: " + line + b"\n\n" if self.sse else line + b"\n"

    def deliver(self, ev: dict | None) -> None:
        """Runs ON THE EVENT LOOP. Queue full = the consumer fell a whole
        buffer behind the decode stream: disconnect it and cancel its
        request rather than stall the drive thread or buffer forever."""
        if self.dead:
            return
        try:
            self.q.put_nowait(ev)
        except asyncio.QueueFull:
            self.dead = True
            self.server.n_slow_disconnects += 1
            while not self.q.empty():
                self.q.get_nowait()
            self.q.put_nowait(None)
            if self.rid is not None:
                self.server._cmd(("cancel", self.rid))


class FrontDoorServer:
    """Asyncio SSE/JSON-lines front door over one ``StreamingEngine``.

    ``start()`` spawns the event-loop thread (socket I/O) and the drive
    thread (all engine calls); ``shutdown(drain=True)`` is the graceful
    path: refuse new work, shed the queue with retry hints, finish
    residents, then stop both threads. The server owns the engine's pump
    for its lifetime — don't drive the same engine elsewhere while the
    server runs. A mesh engine is refused: its ranks must see the same
    submissions in the same order, which one socket front door on one
    rank does not give them (nor the fleet, whose replicas are front
    doors)."""

    def __init__(self, engine, config: ServerConfig | None = None):
        if getattr(engine, "mesh", None) is not None:
            raise NotImplementedError(
                "FrontDoorServer (and the fleet) over a mesh engine is not "
                "ported yet (ROADMAP.md Queue 1 item 9c)")
        self.engine = engine
        self.cfg = config or ServerConfig()
        self.port: int | None = None
        # counters (drive/loop threads bump disjoint ones; reads are
        # informational)
        self.n_accepted = 0
        self.n_quota_rejected = 0
        self.n_rate_limited = 0
        self.n_slow_disconnects = 0
        self._cmds: queue.Queue = queue.Queue()
        self._subs: dict[int, dict] = {}     # drive thread: rid -> sub
        self._inflight: dict[str, int] = {}  # drive thread: tenant -> n
        self._buckets: dict[str, _TokenBucket] = {}  # drive thread
        self._bucket_clock = time.monotonic  # tests may inject a fake clock
        self._accepting = True
        self._draining = False
        self._closed = False
        self._drained = threading.Event()
        self._stop = threading.Event()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.AbstractServer | None = None
        self._loop_thread: threading.Thread | None = None
        self._drive_thread: threading.Thread | None = None
        self._started = threading.Event()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FrontDoorServer":
        self._loop_thread = threading.Thread(target=self._run_loop,
                                             name="frontdoor-loop",
                                             daemon=True)
        self._loop_thread.start()
        self._started.wait(timeout=10.0)
        if self.port is None:
            raise RuntimeError("front door failed to bind "
                               f"{self.cfg.host}:{self.cfg.port}")
        self._drive_thread = threading.Thread(target=self._drive,
                                              name="frontdoor-drive",
                                              daemon=True)
        self._drive_thread.start()
        return self

    def _run_loop(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def boot():
            self._server = await asyncio.start_server(
                self._handle_conn, self.cfg.host, self.cfg.port)
            self.port = self._server.sockets[0].getsockname()[1]
            self._started.set()

        self._loop.run_until_complete(boot())
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    def shutdown(self, *, drain: bool = True,
                 timeout: float | None = 30.0) -> None:
        """Stop the front door. ``drain=True``: graceful — refuse new
        work (503 + retry hint), shed the queued backlog (terminal SHED
        events with ``retry_after`` to their waiters), finish residents
        token-identically, then stop. ``drain=False``: immediate stop.
        Idempotent: a second call (e.g. an unconditional cleanup after a
        graceful drain) is a no-op."""
        if self._closed:
            return
        self._closed = True
        self._accepting = False
        if drain:
            self._draining = True
            self._cmd(("drain", None))
            self._drained.wait(timeout=timeout)
        self._stop.set()
        self._cmd(("noop", None))          # wake the drive thread
        if self._drive_thread is not None:
            self._drive_thread.join(timeout=10.0)
        if self._loop is not None:
            loop = self._loop

            async def _close():
                if self._server is not None:
                    self._server.close()
                # cancel live connection handlers so their transports
                # actually close: a peer (client or fleet router) must
                # see EOF on a hard stop, the same signal a process kill
                # produces, not a socket that hangs open forever
                tasks = [t for t in asyncio.all_tasks()
                         if t is not asyncio.current_task()]
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                await asyncio.sleep(0)   # let transport-close callbacks run
                loop.stop()

            try:
                asyncio.run_coroutine_threadsafe(_close(), loop)
            except RuntimeError:
                pass   # loop already torn down
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10.0)

    def _cmd(self, cmd: tuple) -> None:
        self._cmds.put(cmd)

    # ------------------------------------------------- event loop (sockets)
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
            await self._stream_request(json.loads(body or b"{}"), writer,
                                       sse=True)
        elif method == "POST" and path == "/v1/cancel":
            req = json.loads(body or b"{}")
            self._cmd(("cancel", int(req["rid"])))
            self._respond_json(writer, {"ok": True, "rid": int(req["rid"])})
        elif method == "GET" and path == "/v1/stats":
            self._respond_json(writer, self.stats())
        else:
            self._respond_json(writer, {"error": "not found"}, status=404)
        await _flush(writer)

    async def _serve_ndjson(self, req: dict, writer) -> None:
        op = req.get("op", "generate")
        if op == "generate":
            await self._stream_request(req, writer, sse=False)
        elif op == "cancel":
            self._cmd(("cancel", int(req["rid"])))
            writer.write(json.dumps({"ok": True}).encode() + b"\n")
        elif op == "stats":
            writer.write(json.dumps(self.stats()).encode() + b"\n")
        await _flush(writer)

    async def _stream_request(self, req: dict, writer, *,
                              sse: bool) -> None:
        if sse:
            if not self._accepting:
                self._respond_json(
                    writer,
                    {"error": "draining",
                     "retry_after": self.cfg.drain_retry_after},
                    status=503)
                return
            writer.write(SSE_PREAMBLE)
        conn = _Conn(self, sse=sse)
        if not self._accepting:   # NDJSON drain refusal, as an event
            conn.deliver({"event": "rejected", "error": "draining",
                          "retry_after": self.cfg.drain_retry_after})
            conn.deliver(None)
        else:
            try:
                spec = parse_spec(req)
            except (KeyError, TypeError, ValueError) as e:
                conn.deliver({"event": "rejected", "error": "bad_request",
                              "detail": str(e)})
                conn.deliver(None)
            else:
                timeout = req.get("timeout")
                self._cmd(("submit", (spec, timeout, conn)))
        await self._write_events(conn, writer)

    async def _write_events(self, conn: _Conn, writer) -> None:
        delay = self.cfg.writer_delay_s
        try:
            while True:
                ev = await conn.q.get()
                if ev is None:
                    break
                if delay:
                    await asyncio.sleep(delay)
                writer.write(conn.encode(ev))
                await writer.drain()   # TCP pressure propagates to conn.q
        except ConnectionError:
            conn.dead = True
            if conn.rid is not None:
                self._cmd(("cancel", conn.rid))

    def _respond_json(self, writer, payload: dict,
                      status: int = 200) -> None:
        respond_json(writer, payload, status)

    # --------------------------------------------- drive thread (the engine)
    @torch.no_grad()   # grad mode is per thread: the engine's pump sets it
    def _drive(self) -> None:   # for its own steps, this for the rest
        eng = self.engine
        while not self._stop.is_set():
            block = not eng.scheduler.pending
            try:
                cmd = self._cmds.get(block=block, timeout=0.05)
            except queue.Empty:
                cmd = None
            while cmd is not None:
                self._handle_cmd(cmd)
                try:
                    cmd = self._cmds.get_nowait()
                except queue.Empty:
                    cmd = None
            if eng.scheduler.pending:
                eng.serve_steps(realtime=self.cfg.realtime)
                eng._pump_once()
            self._emit()
            if (self._draining and not eng.scheduler.pending
                    and not self._subs):
                self._drained.set()

    def _handle_cmd(self, cmd: tuple) -> None:
        kind, arg = cmd
        eng = self.engine
        if kind == "submit":
            spec, timeout, conn = arg
            tenant = spec.tenant
            if not self._quota_ok(tenant):
                self.n_quota_rejected += 1
                self._post(conn, {"event": "rejected", "error": "quota",
                                  "tenant": tenant,
                                  "retry_after": self.cfg.quota_retry_after})
                self._post(conn, None)
                return
            wait = self._rate_take(tenant)
            if wait > 0.0:
                self.n_rate_limited += 1
                self._post(conn, {"event": "rejected", "error": "rate",
                                  "tenant": tenant, "retry_after": wait})
                self._post(conn, None)
                return
            if timeout is None:
                timeout = self.cfg.default_timeout_s
            if timeout is not None:
                spec = dataclasses.replace(
                    spec, deadline=eng.scheduler._now + float(timeout))
            h = eng.submit_spec(spec)
            rid = int(h)
            conn.rid = rid
            if tenant is not None:
                self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
            self.n_accepted += 1
            self._subs[rid] = {"conn": conn, "tenant": tenant,
                               "sink": eng.subscribe(rid)}
            self._post(conn, {"event": "accepted", "rid": rid,
                              "status": str(h.status)})
        elif kind == "cancel":
            eng._cancel(int(arg))
        elif kind == "drain":
            eng.begin_drain()

    def _quota_ok(self, tenant: str | None) -> bool:
        q = self.cfg.tenant_quota
        if q is None or tenant is None:
            return True
        cap = q if isinstance(q, int) else q.get(tenant)
        return cap is None or self._inflight.get(tenant, 0) < cap

    def _rate_take(self, tenant: str | None) -> float:
        """Charge the tenant's token bucket for one submission. Returns
        0.0 (granted) or the refill-derived ``retry_after``."""
        rates = self.cfg.tenant_rate
        if rates is None or tenant is None:
            return 0.0
        rate = rates if isinstance(rates, (int, float)) else \
            rates.get(tenant)
        if rate is None or rate <= 0.0:
            return 0.0
        bucket = self._buckets.get(tenant)
        if bucket is None:
            bursts = self.cfg.tenant_burst
            burst = (bursts if isinstance(bursts, (int, float))
                     else (bursts or {}).get(tenant))
            bucket = _TokenBucket(rate, float(rate) if burst is None
                                  else burst)
            self._buckets[tenant] = bucket
        return bucket.take(self._bucket_clock())

    def _emit(self) -> None:
        """Drain every subscription's stream sink into its connection,
        then deliver terminal events — runs on the drive thread after
        each pump iteration."""
        eng = self.engine
        for rid in list(self._subs):
            sub = self._subs[rid]
            conn, sink = sub["conn"], sub["sink"]
            while sink["buf"]:
                d = sink["buf"].pop(0)
                if d.size:
                    self._post(conn, {"event": "delta", "rid": rid,
                                      "tokens": [int(x) for x in d]})
            r = eng._done.get(rid)
            if r is not None and sink["done"]:
                self._post(conn, self._done_event(rid, r))
                self._post(conn, None)
                eng.unsubscribe(rid)
                tenant = sub["tenant"]
                if tenant is not None:
                    n = self._inflight.get(tenant, 1) - 1
                    self._inflight[tenant] = max(0, n)
                del self._subs[rid]

    def _done_event(self, rid: int, r: SlotResult) -> dict:
        ev: dict[str, Any] = {"event": "done", "rid": rid,
                              "status": str(r.status)}
        if r.status == RequestStatus.FINISHED:
            toks = [[int(x) for x in row[:int(n)]]
                    for row, n in zip(r.tokens, r.lengths)]
            ev.update(tokens=toks, lengths=[int(n) for n in r.lengths],
                      logprobs=[float(x) for x in r.logprobs],
                      n_calls=int(r.n_calls), accepted=int(r.accepted))
            tok = getattr(self.engine, "tok", None)
            if tok is not None and toks:
                ev["text"] = tok.decode(np.asarray(r.tokens[0]))
        if r.retry_after is not None:
            ev["retry_after"] = float(r.retry_after)
        return ev

    def _post(self, conn: _Conn, ev: dict | None) -> None:
        """Drive thread -> connection queue, via the event loop."""
        if self._loop is not None and not self._loop.is_closed():
            self._loop.call_soon_threadsafe(conn.deliver, ev)

    # ----------------------------------------------------------------- info
    def stats(self) -> dict:
        """Server + engine observability, served on ``GET /v1/stats`` /
        ``{"op":"stats"}``. Beyond the door's own counters this surfaces
        the engine's load shape — ``occupancy`` ((resident + queued) /
        n_slots), ``shed_rate`` (shed / offered) — plus the full
        ``shard_stats()`` / ``prefix_stats()`` / overload counters, which
        is exactly what the fleet router's placement policy consumes
        (``serving.fleet``); it is equally useful standalone (one
        curl shows whether a replica is shedding, thrashing preemptions,
        or missing its prefix cache)."""
        eng = self.engine
        sch = eng.scheduler
        resident = len(sch._resident)
        offered = self.n_accepted + sch.n_shed
        return {
            "accepted": self.n_accepted,
            "quota_rejected": self.n_quota_rejected,
            "rate_limited": self.n_rate_limited,
            "slow_disconnects": self.n_slow_disconnects,
            "inflight": dict(self._inflight),
            "accepting": self._accepting,
            "draining": self._draining or sch.draining,
            "queued": sch.queued,
            "resident": resident,
            "n_slots": eng.n_slots,
            "occupancy": (resident + sch.queued) / max(1, eng.n_slots),
            "shed_rate": sch.n_shed / max(1, offered),
            "n_steps": sch.n_steps,
            "n_shed": sch.n_shed,
            "n_cancelled": sch.n_cancelled,
            "n_expired": sch.n_expired,
            "n_preemptions": sch.n_preemptions,
            "shard_stats": eng.shard_stats(),
            "prefix_stats": eng.prefix_stats(),
            "overload": {
                "n_preemptions": sch.n_preemptions,
                "n_expired": sch.n_expired,
                "n_shed": sch.n_shed,
                "max_resident": sch.max_resident,
                "aging_rate": sch.policy.aging_rate,
                "shed_depth": sch.policy.shed_depth,
                "deadline_preemption": sch.policy.deadline_preemption,
            },
        }


async def _flush(writer) -> None:
    try:
        await writer.drain()
    except ConnectionError:
        pass


# ------------------------------------------------------------ test client
def sse_events(host: str, port: int, payload: dict,
               timeout: float = 60.0) -> list[dict]:
    """Minimal blocking SSE client (tests + examples): POST the request
    to ``/v1/generate`` and return every decoded event until the server
    closes the stream."""
    import socket

    body = json.dumps(payload).encode()
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(
            f"POST /v1/generate HTTP/1.1\r\nHost: {host}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    head, _, stream = buf.partition(b"\r\n\r\n")
    if b" 200 " not in head.split(b"\r\n", 1)[0]:
        return [json.loads(stream or head.split(b"\r\n")[-1] or b"{}")]
    events = []
    for frame in stream.split(b"\n\n"):
        for line in frame.split(b"\n"):
            if line.startswith(b"data: "):
                events.append(json.loads(line[len(b"data: "):]))
    return events
