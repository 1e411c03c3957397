"""The port's network front door (``repro_torch.serving.server``) and fleet
layer (``repro_torch.serving.fleet``) against the JAX package's, on the
random tiny MT carried across with ``repro_torch.bridge``:

- the cases of ``tests/test_server.py`` on the port's server: the SSE
  deltas equal ``RequestHandle.stream()`` chunk for chunk, NDJSON carries
  the same events, bad requests, wire cancel, the slow consumer, tenant
  quotas and rate limits, ``/v1/stats``, graceful drain, the draining 503's
  ``Retry-After`` and the default timeout; and for the same params and
  queries the events equal those of the JAX package's ``FrontDoorServer``;
- the wire helpers (``SSE_PREAMBLE``, ``respond_json``, ``read_http``,
  ``parse_spec``) give JAX's bytes and values on the same inputs;
- the drive thread builds no autograd graph from params that require grad
  (grad mode is per thread);
- the cases of ``tests/test_fleet.py`` on the port's router over port
  replicas, the replica-kill drill and the typed retryable rejection
  included, the router's events equal to the JAX router's, and ``place()``
  / ``PrefixIndex`` equal to JAX's on the same hypothesis-drawn inputs.

Every engine runs on the step clock (``realtime=False``); greedy
log-probs are 0, so events compare exactly.
"""

import asyncio
import dataclasses
import json
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from repro.testing import given, settings, strategies as st

from repro.configs.mt import tiny_config as jax_tiny_config  # noqa: E402
from repro.data import SyntheticReactionDataset  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import FleetRouter as JaxFleetRouter  # noqa: E402
from repro.serving import FrontDoorServer as JaxFrontDoorServer  # noqa: E402
from repro.serving import ServerConfig as JaxServerConfig  # noqa: E402
from repro.serving import StreamingEngine as JaxStreamingEngine  # noqa: E402
from repro.serving import server as jax_server  # noqa: E402
from repro.serving.fleet import placement as jax_placement  # noqa: E402
from repro_torch.bridge import seq2seq_params_from_jax  # noqa: E402
from repro_torch.configs.mt import tiny_config  # noqa: E402
from repro_torch.data.tokenizer import SmilesTokenizer  # noqa: E402
from repro_torch.serving import (EngineConfig, FleetConfig,  # noqa: E402
                                 FleetRouter, FrontDoorServer, RequestStatus,
                                 ServerConfig, StreamingEngine)
from repro_torch.serving import server as port_server  # noqa: E402
from repro_torch.serving.fleet import placement as port_placement  # noqa: E402
from repro_torch.serving.server import sse_events  # noqa: E402
from repro_torch.training.optimizer import (tree_leaves,  # noqa: E402
                                            tree_unflatten)

MAX_NEW = 64   # tests/test_server.py's
HOST = "127.0.0.1"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny model's ops are far too small to share out between threads,
    and under pytest-xdist every worker's own thread pool would contend for
    the same cores; one thread, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy():
    ds = SyntheticReactionDataset(16, seed=0)
    V = ds.tokenizer.vocab_size
    cfg_j = jax_tiny_config(V, depth=2, d_model=64, max_len=192)
    pj = js2s.init(jax.random.PRNGKey(0), cfg_j)
    cfg_t = tiny_config(V, depth=2, d_model=64, max_len=192)
    pt = seq2seq_params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    tok = SmilesTokenizer.from_dict(ds.tokenizer.to_dict())
    return dict(ds=ds, cfg_j=cfg_j, pj=pj, cfg_t=cfg_t, pt=pt, tok=tok)


def _q(toy, i):
    return toy["ds"].pair(i)[0]


def _ecfg(**kw):
    base = dict(mode="greedy", max_new=MAX_NEW, max_src=96, n_slots=1)
    base.update(kw)
    return base


def _engine(toy, params=None, **kw):
    """A warmed one-slot port engine on the CPU (warm-up, then reset, as
    the JAX tests do before a server owns the pump)."""
    eng = StreamingEngine(toy["pt"] if params is None else params,
                          toy["cfg_t"], toy["tok"],
                          EngineConfig(**_ecfg(**kw)), device="cpu")
    eng.submit(_q(toy, 0))
    eng.serve()
    eng.reset()
    return eng


def _jax_engine(toy, **kw):
    eng = JaxStreamingEngine(toy["pj"], toy["cfg_j"], toy["ds"].tokenizer,
                             JaxEngineConfig(**_ecfg(**kw)))
    eng.submit(_q(toy, 0))
    eng.serve()
    eng.reset()
    return eng


@pytest.fixture
def served(toy):
    """A started port server over a warmed 1-slot engine."""
    eng = _engine(toy)
    srv = FrontDoorServer(eng, ServerConfig(realtime=False)).start()
    yield eng, srv
    srv.shutdown(drain=False)


class SSEClient:
    """Incremental SSE reader (``tests/test_server.py``'s): events one at a
    time, so a test can act mid-stream."""

    def __init__(self, host, port, payload, timeout=60.0):
        body = json.dumps(payload).encode()
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.sendall(
            f"POST /v1/generate HTTP/1.1\r\nHost: {host}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        self.buf = b""
        while b"\r\n\r\n" not in self.buf:
            self.buf += self.sock.recv(65536)
        head, _, self.buf = self.buf.partition(b"\r\n\r\n")
        self.status = int(head.split(b" ", 2)[1])

    def next_event(self):
        while b"\n\n" not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                return None
            self.buf += chunk
        frame, self.buf = self.buf.split(b"\n\n", 1)
        assert frame.startswith(b"data: ")
        return json.loads(frame[len(b"data: "):])

    def drain(self, prior=()):
        out = list(prior)
        while (ev := self.next_event()) is not None:
            out.append(ev)
        self.sock.close()
        return out


def _raw(port, data: bytes, *, until_close=True) -> bytes:
    with socket.create_connection((HOST, port), timeout=30) as s:
        s.sendall(data)
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
            if not until_close and buf.endswith(b"\n"):
                break
    return buf


def _ndjson(port, req: dict) -> list[dict]:
    buf = _raw(port, json.dumps(req).encode() + b"\n")
    return [json.loads(line) for line in buf.splitlines() if line]


def _deltas(events):
    return [ev["tokens"] for ev in events if ev["event"] == "delta"]


def _acks(events):
    """(n_accepted, n_terminal): every request owes exactly (1, 1)."""
    return (sum(e["event"] == "accepted" for e in events),
            sum(e["event"] == "done" for e in events))


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


# ---------------------------------------------------------------------------
# wire identity


def test_sse_stream_equals_handle_stream_and_jax_server(toy, served):
    """The SSE deltas equal a twin engine's ``RequestHandle.stream()``
    chunk for chunk, the final payload its ``result()``; and the whole
    event list equals the JAX package's server's for the same query."""
    eng, srv = served
    query = _q(toy, 3)
    events = sse_events(HOST, srv.port, {"query": query})
    assert [e["event"] for e in events[:1]] == ["accepted"]
    done = events[-1]
    assert done["event"] == "done" and done["status"] == "finished"

    twin = _engine(toy)
    h = twin.submit(query)
    chunks = [[int(x) for x in d] for d in h.stream()]
    r = twin._done[int(h)]
    assert _deltas(events) == chunks
    assert done["tokens"] == [[int(x) for x in row[:int(n)]]
                              for row, n in zip(r.tokens, r.lengths)]
    assert done["text"] == toy["tok"].decode(np.asarray(r.tokens[0]))

    jeng = _jax_engine(toy)
    jsrv = JaxFrontDoorServer(jeng, JaxServerConfig(realtime=False)).start()
    try:
        want = jax_server.sse_events(HOST, jsrv.port, {"query": query})
    finally:
        jsrv.shutdown(drain=False)
    assert events == want


def test_ndjson_framing_carries_same_events(toy, served):
    _, srv = served
    query = _q(toy, 4)
    sse = sse_events(HOST, srv.port, {"query": query})
    nd = _ndjson(srv.port, {"op": "generate", "query": query})
    strip = lambda evs: [{k: v for k, v in e.items() if k != "rid"}
                         for e in evs]
    assert strip(nd) == strip(sse)


def test_bad_request_and_unknown_route(served):
    _, srv = served
    events = sse_events(HOST, srv.port, {"mode": "greedy"})   # no query
    assert [e["event"] for e in events] == ["rejected"]
    assert events[0]["error"] == "bad_request"
    assert _raw(srv.port, b"GET /nope HTTP/1.1\r\nHost: x\r\n\r\n"
                ).startswith(b"HTTP/1.1 404")


def test_cancel_over_the_wire(toy, served):
    eng, srv = served
    c = SSEClient(HOST, srv.port, {"query": _q(toy, 5)})
    accepted = c.next_event()
    assert accepted["event"] == "accepted"
    rid = accepted["rid"]
    body = json.dumps({"rid": rid}).encode()
    _raw(srv.port, f"POST /v1/cancel HTTP/1.1\r\nHost: x\r\n"
                   f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    rest = c.drain()
    assert rest[-1]["event"] == "done" and rest[-1]["status"] == "cancelled"
    assert eng._done[rid].status == RequestStatus.CANCELLED


def test_slow_consumer_disconnected_and_cancelled(toy):
    eng = _engine(toy)
    srv = FrontDoorServer(eng, ServerConfig(
        realtime=False, max_buffered_events=2, writer_delay_s=0.2)).start()
    try:
        c = SSEClient(HOST, srv.port, {"query": _q(toy, 6)})
        first = c.next_event()
        assert first["event"] == "accepted"
        rid = first["rid"]
        c.drain()
        assert _wait(lambda: srv.n_slow_disconnects == 1)
        assert _wait(lambda: rid in eng._done)
        assert eng._done[rid].status == RequestStatus.CANCELLED
    finally:
        srv.shutdown(drain=False)


def test_tenant_quota_rejects_at_the_door(toy):
    eng = _engine(toy)
    srv = FrontDoorServer(eng, ServerConfig(
        realtime=False, tenant_quota={"acme": 1},
        quota_retry_after=7.5)).start()
    try:
        a = SSEClient(HOST, srv.port, {"query": _q(toy, 1), "tenant": "acme"})
        assert a.next_event()["event"] == "accepted"
        rej = sse_events(HOST, srv.port, {"query": _q(toy, 2),
                                          "tenant": "acme"})
        assert rej == [{"event": "rejected", "error": "quota",
                        "tenant": "acme", "retry_after": 7.5}]
        assert srv.n_quota_rejected == 1
        other = sse_events(HOST, srv.port, {"query": _q(toy, 2),
                                            "tenant": "zen"})
        assert other[-1]["status"] == "finished"
        assert a.drain()[-1]["event"] == "done"
        again = sse_events(HOST, srv.port, {"query": _q(toy, 2),
                                            "tenant": "acme"})
        assert again[-1]["status"] == "finished"
    finally:
        srv.shutdown(drain=False)


@pytest.mark.parametrize("rate,burst,n_ok,retry", [
    ({"acme": 0.5}, {"acme": 1}, 1, 2.0),
    (2.0, 3.0, 3, 0.5)])
def test_tenant_rate_limit_retry_after_is_the_refill(toy, rate, burst, n_ok,
                                                     retry):
    """A burst-sized volley passes; the next submission is rejected with
    the bucket's refill time; an unconfigured tenant is untouched; after
    the advertised refill the tenant is admitted again."""
    eng = _engine(toy)
    srv = FrontDoorServer(eng, ServerConfig(
        realtime=False, tenant_rate=rate, tenant_burst=burst)).start()
    clk = {"t": 0.0}
    srv._bucket_clock = lambda: clk["t"]
    q = _q(toy, 2)
    try:
        for _ in range(n_ok):
            evs = sse_events(HOST, srv.port, {"query": q, "tenant": "acme"})
            assert evs[-1]["status"] == "finished"
        rej = sse_events(HOST, srv.port, {"query": q, "tenant": "acme"})
        assert rej == [{"event": "rejected", "error": "rate",
                        "tenant": "acme", "retry_after": retry}]
        assert srv.n_rate_limited == 1
        if isinstance(rate, dict):
            zen = sse_events(HOST, srv.port, {"query": q, "tenant": "zen"})
            assert zen[-1]["status"] == "finished"
        clk["t"] = retry
        again = sse_events(HOST, srv.port, {"query": q, "tenant": "acme"})
        assert again[-1]["status"] == "finished"
    finally:
        srv.shutdown(drain=False)


def test_stats_match_jax_servers(toy):
    """``/v1/stats`` (and ``{"op": "stats"}``) carry the placement signals
    and the engine's counters; after the same request the two packages'
    stats are equal but for the one-shard counter (the port's one shard
    counts its admissions; JAX's unsharded engine reports 0)."""
    got = []
    for make, cls, cfg in ((_engine, FrontDoorServer, ServerConfig),
                           (_jax_engine, JaxFrontDoorServer,
                            JaxServerConfig)):
        srv = cls(make(toy), cfg(realtime=False)).start()
        try:
            done = sse_events(HOST, srv.port, {"query": _q(toy, 4)})
            assert done[-1]["status"] == "finished"
            stats = json.loads(_raw(srv.port, b'{"op":"stats"}\n',
                                    until_close=False))
            http = _raw(srv.port, b"GET /v1/stats HTTP/1.1\r\nHost: x\r\n\r\n")
            assert json.loads(http.partition(b"\r\n\r\n")[2]) == stats
            got.append(stats)
        finally:
            srv.shutdown(drain=False)
    port, want = got
    assert port["accepted"] == 1 and port["accepting"] is True
    assert port["n_slots"] == 1 and port["occupancy"] == 0.0
    # an unsharded engine counts no sharded admissions, in both packages
    assert port["shard_stats"] == {"n_shards": 1, "admitted_by_shard": [0],
                                   "admit_imbalance": 1.0}
    assert port == want


def test_graceful_drain_over_the_wire(toy):
    """A resident mid-stream, B queued: shutdown(drain=True) finishes A
    token-identically, sheds B with retry metadata, 503s newcomers."""
    eng = _engine(toy)
    srv = FrontDoorServer(eng, ServerConfig(realtime=False)).start()
    qa, qb = _q(toy, 7), _q(toy, 8)
    try:
        a = SSEClient(HOST, srv.port, {"query": qa})
        assert a.next_event()["event"] == "accepted"
        assert a.next_event()["event"] == "delta"
        b = SSEClient(HOST, srv.port, {"query": qb})
        assert b.next_event()["event"] == "accepted"
        stopper = threading.Thread(target=srv.shutdown,
                                   kwargs={"drain": True})
        stopper.start()
        assert _wait(lambda: not srv._accepting, 10.0)
        refused = sse_events(HOST, srv.port, {"query": qa})
        assert refused[0]["error"] == "draining"
        assert refused[0]["retry_after"] > 0
        b_done = b.drain()[-1]
        assert b_done["status"] == "shed" and b_done["retry_after"] > 0
        a_done = a.drain()[-1]
        assert a_done["status"] == "finished"
        stopper.join(timeout=30.0)
        assert not stopper.is_alive()
        r = _engine(toy).submit(qa).result()
        assert a_done["tokens"] == [[int(x) for x in row[:int(n)]]
                                    for row, n in zip(r.tokens, r.lengths)]
    finally:
        srv.shutdown(drain=False)


def test_draining_503_sets_retry_after_header(toy):
    srv = FrontDoorServer(_engine(toy), ServerConfig(
        realtime=False, drain_retry_after=2.5)).start()
    try:
        srv._accepting = False
        body = json.dumps({"query": _q(toy, 0)}).encode()
        buf = _raw(srv.port, f"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                             f"Content-Length: {len(body)}\r\n\r\n".encode()
                   + body)
        head = buf.partition(b"\r\n\r\n")[0].decode()
        assert int(head.split(" ", 2)[1]) == 503
        headers = {k.strip().lower(): v.strip() for k, v in
                   (ln.split(":", 1) for ln in head.split("\r\n")[1:]
                    if ":" in ln)}
        assert headers["retry-after"] == "3"
    finally:
        srv.shutdown(drain=False)


def test_default_timeout_stamps_deadline(toy):
    srv = FrontDoorServer(_engine(toy), ServerConfig(
        realtime=False, default_timeout_s=0.0)).start()
    q = _q(toy, 3)
    try:
        untimed = SSEClient(HOST, srv.port, {"query": q}).drain()
        assert untimed[0]["event"] == "accepted"
        assert untimed[-1]["status"] == "expired"
        timed = SSEClient(HOST, srv.port, {"query": q,
                                           "timeout": 1e9}).drain()
        assert timed[-1]["status"] == "finished"
    finally:
        srv.shutdown(drain=False)


def test_drive_thread_builds_no_graph_from_grad_params(toy):
    """Params that require grad (a trainer's): everything the drive thread
    does to the engine, inside the pump and outside it (submit, cancel),
    runs with grad off, and the session's tensors hold no graph."""
    pt = tree_unflatten(toy["pt"], [x.clone().requires_grad_(True)
                                    for x in tree_leaves(toy["pt"])])
    eng = _engine(toy, params=pt, prefix_cache=True)
    seen = []
    submit_spec, cancel = eng.submit_spec, eng._cancel

    def spy_submit(spec):
        seen.append(torch.is_grad_enabled())
        return submit_spec(spec)

    def spy_cancel(rid):
        seen.append(torch.is_grad_enabled())
        return cancel(rid)

    eng.submit_spec, eng._cancel = spy_submit, spy_cancel
    srv = FrontDoorServer(eng, ServerConfig(realtime=False)).start()
    try:
        assert sse_events(HOST, srv.port,
                          {"query": _q(toy, 2)})[-1]["status"] == "finished"
        c = SSEClient(HOST, srv.port, {"query": _q(toy, 3)})
        rid = c.next_event()["rid"]
        body = json.dumps({"rid": rid}).encode()
        _raw(srv.port, f"POST /v1/cancel HTTP/1.1\r\nHost: x\r\n"
                       f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        assert c.drain()[-1]["status"] == "cancelled"
    finally:
        srv.shutdown(drain=False)
    assert seen and not any(seen)
    assert torch.is_grad_enabled()   # this thread's mode is untouched
    leaves = [x for x in tree_leaves(eng.scheduler.state.cache)
              if isinstance(x, torch.Tensor)]
    leaves += [x for ent in eng._encode_lru.values()
               for x in (*ent[0].values(), ent[1])]
    assert leaves and all(x.grad_fn is None and not x.requires_grad
                          for x in leaves)


# ---------------------------------------------------------------------------
# the wire helpers, against JAX's


class _Writer:
    def __init__(self):
        self.buf = b""

    def write(self, b):
        self.buf += b


@pytest.mark.parametrize("payload,status", [
    ({"ok": True, "rid": 3}, 200), ({"error": "not found"}, 404),
    ({"error": "draining", "retry_after": 2.5}, 503),
    ({"error": "draining", "retry_after": 3}, 503), ({"x": [1, 2.5]}, 201)])
def test_respond_json_bytes_match_jax(payload, status):
    a, b = _Writer(), _Writer()
    port_server.respond_json(a, payload, status)
    jax_server.respond_json(b, payload, status)
    assert a.buf == b.buf
    assert port_server.SSE_PREAMBLE == jax_server.SSE_PREAMBLE


@pytest.mark.parametrize("raw", [
    b"GET /v1/stats HTTP/1.1\r\nHost: x\r\n\r\n",
    b"POST /v1/generate HTTP/1.1\r\nHost: h\r\nContent-Type: application/"
    b"json\r\nContent-Length: 16\r\n\r\n{\"query\": \"CCO\"}",
    b"POST /v1/cancel HTTP/1.1\r\nX-Odd:  spaced : value \r\n"
    b"content-length: 2\r\n\r\n{}"])
def test_read_http_matches_jax(raw):
    async def parse(fn):
        reader = asyncio.StreamReader()
        reader.feed_data(raw[1:])
        reader.feed_eof()
        return await fn(raw[:1], reader)

    assert asyncio.run(parse(port_server.read_http)) == \
        asyncio.run(parse(jax_server.read_http))


@pytest.mark.parametrize("req", [
    {"query": "CCO"},
    {"query": "CCO", "mode": "speculative", "priority": 2, "tenant": "t",
     "max_new": 12, "draft_len": 3, "n_drafts": 4, "stop_ids": [5, 6]},
    {"query": [4, 5, 6], "n_beams": 2, "max_new": None}])
def test_parse_spec_matches_jax(req):
    a, b = port_server.parse_spec(req), jax_server.parse_spec(req)
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    qa, qb = da.pop("query"), db.pop("query")
    np.testing.assert_array_equal(qa, qb)
    assert type(qa) is type(qb) and da == db


def test_parse_spec_errors_match_jax():
    for req in ({}, {"query": "C", "max_new": "many"}):
        errors = []
        for mod in (port_server, jax_server):
            try:
                mod.parse_spec(req)
                errors.append(None)
            except (KeyError, TypeError, ValueError) as e:
                errors.append(type(e))
        assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# placement, against JAX's


def _build(pl, flat, inserts, n_views):
    """(views, index) in module ``pl`` from flat int streams
    (``tests/test_fleet.py``'s builder)."""
    healths = (pl.ReplicaHealth.HEALTHY, pl.ReplicaHealth.DRAINING,
               pl.ReplicaHealth.DOWN)
    views = {}
    for i in range(n_views):
        chunk = flat[5 * i:5 * i + 5]
        if len(chunk) < 5:
            break
        views[i] = pl.ReplicaView(
            health=healths[chunk[0] % 3], n_slots=1 + chunk[1] % 4,
            occupancy=(chunk[2] % 9) / 4.0, shed_rate=(chunk[3] % 5) / 4.0,
            inflight=chunk[4] % 6)
    idx = pl.PrefixIndex(max_nodes=8)
    for j, seq in enumerate(inserts):
        idx.insert(tuple(seq), j % max(1, n_views))
    return views, idx


@given(st.lists(st.integers(0, 9), min_size=0, max_size=40),
       st.lists(st.lists(st.integers(0, 5), min_size=1, max_size=6),
                min_size=0, max_size=16),
       st.lists(st.lists(st.integers(0, 5), min_size=0, max_size=8),
                min_size=1, max_size=4),
       st.integers(0, 4), st.integers(0, 3))
@settings(max_examples=80, deadline=None)
def test_placement_and_index_match_jax(flat, inserts, queries, min_aff,
                                       drop):
    """The same views, index inserts, drops and lookups give the same
    placements, matches and index counters in both packages."""
    n = max(1, len(flat) // 5)
    vt, it = _build(port_placement, flat, inserts, n)
    vj, ij = _build(jax_placement, flat, inserts, n)
    assert (len(it), it.inserted, it.evicted) == \
        (len(ij), ij.inserted, ij.evicted)
    for q in queries:
        assert it.lookup(tuple(q)) == ij.lookup(tuple(q))
        assert port_placement.place(vt, it, tuple(q), min_affinity=min_aff) \
            == jax_placement.place(vj, ij, tuple(q), min_affinity=min_aff)
    assert it.drop_replica(drop) == ij.drop_replica(drop)
    assert len(it) == len(ij)
    for q in queries:
        assert it.lookup(tuple(q)) == ij.lookup(tuple(q))


def test_placement_cases():
    """``tests/test_fleet.py``'s placement cases on the port."""
    pl = port_placement
    H, D, X = (pl.ReplicaHealth.HEALTHY, pl.ReplicaHealth.DRAINING,
               pl.ReplicaHealth.DOWN)

    def view(health=H, n_slots=1, occupancy=0.0, shed_rate=0.0,
             inflight=0):
        return pl.ReplicaView(health=health, n_slots=n_slots,
                              occupancy=occupancy, shed_rate=shed_rate,
                              inflight=inflight)

    idx = pl.PrefixIndex()
    assert pl.place({0: view(occupancy=0.8), 1: view(occupancy=0.2),
                     2: view(occupancy=0.5)}, idx, "q") == (1, 0)
    assert pl.place({0: view(occupancy=0.5, shed_rate=0.3),
                     1: view(occupancy=0.5)}, idx, "q") == (1, 0)
    assert pl.place({i: view(occupancy=0.5) for i in (10, 2, 0)}, idx,
                    "q") == (0, 0)
    busy = {0: view(occupancy=0.0, inflight=2, n_slots=2),
            1: view(occupancy=0.4)}
    assert busy[0].load == 1.0 and pl.place(busy, idx, "q") == (1, 0)
    idx.insert("CCO>>CC", 0)
    busy = {0: view(occupancy=0.9), 1: view(occupancy=0.0)}
    assert pl.place(busy, idx, "CCO>>CCN") == (0, 7)
    assert pl.place(busy, idx, "CCO>>CCN", min_affinity=8) == (1, 0)
    idx.insert("abc", 0)
    dead = {0: view(health=X), 1: view(health=D), 2: view(occupancy=0.9)}
    assert pl.place(dead, idx, "abcdef") == (2, 0)
    assert pl.place({0: view(health=X), 1: view(health=D)}, idx,
                    "abcdef") == (None, 0)
    lru = pl.PrefixIndex(max_nodes=8)
    for i in range(50):
        lru.insert((100 + i, 200 + i, 300 + i), i % 2)
    assert len(lru) <= 8 and lru.evicted > 0
    assert lru.lookup((149, 249, 349)) == (1, 3)


# ---------------------------------------------------------------------------
# the router over live port replicas


def _replica(toy):
    return FrontDoorServer(_engine(toy), ServerConfig(realtime=False)).start()


@pytest.fixture
def fleet(toy):
    srvs = [_replica(toy) for _ in range(2)]
    router = FleetRouter([(HOST, s.port) for s in srvs],
                         FleetConfig(probe_interval_s=0.05)).start()
    time.sleep(0.15)               # let one probe round land
    yield srvs, router
    router.shutdown()
    for s in srvs:
        s.shutdown(drain=False)


def test_router_is_wire_invisible_prefix_affine_and_matches_jax(toy, fleet):
    """Same events and tokens through the router as from a bare replica;
    a repeat sticks to its replica; the JAX router over JAX replicas gives
    the same events."""
    srvs, router = fleet
    query = _q(toy, 3)
    via_router = sse_events(HOST, router.port, {"query": query})
    direct = sse_events(HOST, srvs[0].port, {"query": query})
    assert _acks(via_router) == (1, 1)
    assert via_router[0]["replica"] == 0
    assert via_router[-1]["status"] == "finished"
    assert via_router[-1]["tokens"] == direct[-1]["tokens"]
    assert _deltas(via_router) == _deltas(direct)
    again = sse_events(HOST, router.port, {"query": query})
    assert again[0]["replica"] == 0
    st_ = router.stats()
    assert st_["affinity_hits"] >= 1 and st_["prefix_hit_rate"] > 0
    assert st_["index"]["size"] > 0

    jsrvs = [JaxFrontDoorServer(_jax_engine(toy),
                                JaxServerConfig(realtime=False)).start()
             for _ in range(2)]
    jrouter = JaxFleetRouter([(HOST, s.port) for s in jsrvs]).start()
    try:
        time.sleep(0.15)
        want = jax_server.sse_events(HOST, jrouter.port, {"query": query})
    finally:
        jrouter.shutdown()
        for s in jsrvs:
            s.shutdown(drain=False)
    assert via_router == want


def test_cancel_routes_through_to_the_owning_replica(toy, fleet):
    _, router = fleet
    c = SSEClient(HOST, router.port, {"query": _q(toy, 5)})
    accepted = c.next_event()
    assert accepted["event"] == "accepted"
    body = json.dumps({"rid": accepted["rid"]}).encode()
    _raw(router.port, f"POST /v1/cancel HTTP/1.1\r\nHost: x\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    events = c.drain(prior=[accepted])
    assert _acks(events) == (1, 1)
    assert events[-1]["status"] == "cancelled"


def test_fleet_stats_aggregate_per_replica_health(fleet):
    _, router = fleet
    st_ = router.stats(fresh=True)
    assert st_["fleet"] and st_["n_replicas"] == 2 and st_["n_healthy"] == 2
    for rep in st_["replicas"].values():
        assert rep["health"] == "healthy"
        for key in ("occupancy", "shed_rate", "load", "prefix_hit_rate"):
            assert key in rep


def test_replica_kill_drill_reroutes_every_queued_request(toy, fleet):
    """Kill replica 0 with one request streaming on it and two affine
    requests queued behind it: the queued ones finish on the survivor,
    token-identically, one ``accepted`` and one terminal each; the
    streaming one finishes or ends ``lost`` (typed, retryable)."""
    srvs, router = fleet
    prompt, other = _q(toy, 7), _q(toy, 8)
    seed = sse_events(HOST, router.port, {"query": prompt})
    assert seed[-1]["status"] == "finished" and seed[0]["replica"] == 0

    a = SSEClient(HOST, router.port, {"query": prompt})
    a_pre = [a.next_event()]
    assert a_pre[0]["event"] == "accepted" and a_pre[0]["replica"] == 0
    a_pre.append(a.next_event())
    assert a_pre[1]["event"] == "delta"
    b = SSEClient(HOST, router.port, {"query": other})
    b_pre = [b.next_event()]
    assert b_pre[0]["replica"] == 1
    queued = []
    for _ in range(2):
        c = SSEClient(HOST, router.port, {"query": prompt})
        ev = c.next_event()
        assert ev["event"] == "accepted" and ev["replica"] == 0
        queued.append((c, [ev]))

    srvs[0].shutdown(drain=False)             # the kill

    for c, pre in queued:
        events = c.drain(prior=pre)
        assert _acks(events) == (1, 1)
        assert events[-1]["status"] == "finished"
        assert events[-1]["replica"] == 1
        assert events[-1]["tokens"] == seed[-1]["tokens"]
    a_events = a.drain(prior=a_pre)
    assert _acks(a_events) == (1, 1)
    assert a_events[-1]["status"] in ("finished", "lost")
    if a_events[-1]["status"] == "lost":
        assert a_events[-1]["retryable"] is True
        assert a_events[-1]["retry_after"] > 0
    b_events = b.drain(prior=b_pre)
    assert _acks(b_events) == (1, 1)
    assert b_events[-1]["status"] == "finished"
    st_ = router.stats()
    assert st_["rerouted"] == 2 and st_["reroute_ok"] == 2
    assert st_["n_healthy"] == 1
    again = sse_events(HOST, router.port, {"query": prompt})
    assert again[0]["replica"] == 1
    assert again[-1]["tokens"] == seed[-1]["tokens"]


def test_no_healthy_replica_is_a_typed_retryable_rejection(toy):
    srv = _replica(toy)
    router = FleetRouter([(HOST, srv.port)], FleetConfig(
        probe_interval_s=0.05, no_replica_retry_after=3.5)).start()
    try:
        time.sleep(0.15)
        srv.shutdown(drain=False)
        assert _wait(lambda: router.stats()["n_healthy"] == 0, 10.0)
        events = sse_events(HOST, router.port, {"query": _q(toy, 2)})
        assert events == [{"event": "rejected", "error": "no_replica",
                           "retry_after": 3.5}]
        assert router.stats()["no_replica"] == 1
    finally:
        router.shutdown()
        srv.shutdown(drain=False)


def _replica_args(**kw):
    base = dict(model="arch", arch="smollm-135m", reduced=True,
                mode="speculative", slots=2, max_new=8, max_src=24,
                draft_len=4, n_drafts=4, paged=True, page_size=8,
                prefix_cache=False, prefill_chunk=5, device="cpu")
    base.update(kw)
    return type("Args", (), base)()


def test_replica_entry_point_refuses_decoder_only_models():
    """``--model arch`` builds every decoder-only family, the cross-attention
    VLM among them since it is ported; what it cannot serve is refused: an
    arch with no decode step (the audio encoder) by family, an unknown one
    naming the registered archs."""
    from repro_torch.serving.fleet import replica

    eng = replica.build_engine(_replica_args(arch="llama-3.2-vision-11b"))
    assert eng.cfg.layer_pattern[-1] == "xattn"
    with pytest.raises(ValueError, match="encoder-only"):
        replica.build_engine(_replica_args(arch="hubert-xlarge"))
    with pytest.raises(KeyError, match="smollm-135m"):
        replica.build_engine(_replica_args(arch="llama-3.2-vision-90b"))


def test_replica_serves_a_decoder_only_arch():
    """``--model arch --arch smollm-135m --reduced`` behind the front door:
    token ids in, and the done event's tokens equal an engine built
    directly from the same seed."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    from repro_torch.serving.fleet import replica

    eng = replica.build_engine(_replica_args())
    prompt = np.random.default_rng(5).integers(4, 500, 19).tolist()
    cfg = get_config("smollm-135m", reduced=True)
    ref = StreamingEngine(
        tr.init(torch.Generator().manual_seed(0), cfg, device="cpu"), cfg,
        None, EngineConfig(mode="speculative", n_slots=2, max_new=8,
                           max_src=24, draft_len=4, n_drafts=4, paged=True,
                           page_size=8, prefill_chunk=5, eos_id=2),
        device="cpu")
    want = ref.submit(np.asarray(prompt, np.int32)).result().tokens[0]
    srv = FrontDoorServer(eng, ServerConfig(realtime=False)).start()
    try:
        events = sse_events(HOST, srv.port, {"query": prompt})
    finally:
        srv.shutdown(drain=False)
    assert [e["event"] for e in events][0] == "accepted"
    done = events[-1]
    assert done["event"] == "done"
    np.testing.assert_array_equal(done["tokens"][0], want)
