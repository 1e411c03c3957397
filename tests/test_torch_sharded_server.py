"""The port's front door and fleet over a mesh engine: ``FrontDoorServer``
on every rank of a ``(data, model)`` mesh of a 4-rank gloo world of CPU
processes (one world a module, ``repro_torch.launch.world.World``; the
door serves through ``repro_torch.launch.mesh_runs.front_door``), on the
toys of ``tests/test_torch_sharded.py`` (the MT ``tiny_config`` at depth 2
/ d_model 64; SmolLM ``reduced()``, paged) with the JAX package's weights
carried across, live sockets on 127.0.0.1, every engine on the step clock:

(a) each mode's SSE and NDJSON events equal those of the JAX package's
    door over its ``(2, 2)`` mesh engine (on the forced host devices of
    ``tests/conftest.py``) and of the port's unsharded door: rids,
    deltas, done events (log-probs within 1e-4);
(b) cancel over the wire, a slow consumer's disconnect, and a late
    subscriber on rank 0 alone, whose catch-up equals the unsharded
    engine's;
(c) quota and rate-limit rejections stay on rank 0: every rank takes the
    same steps;
(d) a graceful drain finishes the residents token-identically, sheds the
    queue and stops every rank;
(e) ``stats()`` keys and ``shard_stats()`` equal JAX's;
(f) a ``FleetRouter`` over the mesh door and an unsharded replica routes,
    cancels and fails over, tokens equal, and its probes carry the mesh
    replica's ``shard_stats``;
(g) a follower whose rank 0 is gone raises within its stated limit;

and a door over a ``(1, 1)`` mesh engine on a one-rank world in this
process.
"""

import json
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.mt import tiny_config as jax_tiny  # noqa: E402
from repro.data import SyntheticReactionDataset  # noqa: E402
from repro.launch.mesh import make_serving_mesh as jax_mesh  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import FrontDoorServer as JaxFrontDoorServer  # noqa: E402
from repro.serving import ServerConfig as JaxServerConfig  # noqa: E402
from repro.serving import StreamingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import (seq2seq_params_from_jax,  # noqa: E402
                                transformer_params_from_jax)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.mt import tiny_config  # noqa: E402
from repro_torch.data.tokenizer import SmilesTokenizer  # noqa: E402
from repro_torch.launch import mesh_runs  # noqa: E402
from repro_torch.launch.world import World  # noqa: E402
from repro_torch.serving import (EngineConfig, FleetConfig,  # noqa: E402
                                 FleetRouter, FrontDoorServer, ServerConfig,
                                 StreamingEngine)
from repro_torch.serving.server import sse_events  # noqa: E402

HOST = "127.0.0.1"
MODES = ("greedy", "speculative", "beam", "speculative_beam")
DOOR = "repro_torch.launch.mesh_runs:front_door"
LONG = dict(mode="greedy", max_new=64, max_src=96, n_slots=2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    with World(4, device="cpu") as w:
        yield w


@pytest.fixture(scope="module")
def toys(tmp_path_factory):
    """The JAX toys, their port twins and their mesh descriptions (weights
    saved once for the ranks)."""
    d = tmp_path_factory.mktemp("door")
    ds = SyntheticReactionDataset(16, seed=0)
    V = ds.tokenizer.vocab_size
    jcfg = jax_tiny(V, depth=2, d_model=64, max_len=192)
    jp = js2s.init(jax.random.PRNGKey(0), jcfg)
    mt_params = seq2seq_params_from_jax(jax.tree.map(np.asarray, jp),
                                        device="cpu")
    torch.save(mt_params, d / "mt.pt")
    lcfg = jax_get_config("smollm-135m", reduced=True)
    lp = jtr.init(jax.random.PRNGKey(0), lcfg)
    lm_params = transformer_params_from_jax(jax.tree.map(np.asarray, lp),
                                            device="cpu")
    torch.save(lm_params, d / "lm.pt")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(4, 500, size=L).astype(np.int32).tolist()
               for L in (9, 17, 24, 5)]
    mt_cfg = tiny_config(V, depth=2, d_model=64, max_len=192)
    lm_cfg = get_config("smollm-135m", reduced=True)
    return dict(
        ds=ds, tok=SmilesTokenizer.from_dict(ds.tokenizer.to_dict()),
        prompts=prompts,
        jax=dict(mt=(jp, jcfg, ds.tokenizer), lm=(lp, lcfg, None)),
        port=dict(mt=(mt_params, mt_cfg), lm=(lm_params, lm_cfg)),
        mt=dict(family="mt", cfg=mt_cfg, params=str(d / "mt.pt"),
                tokenizer=ds.tokenizer.to_dict()),
        lm=dict(family="lm", cfg=lm_cfg, params=str(d / "lm.pt")))


def _kw(backend: str) -> dict:
    kw = dict(max_new=8, draft_len=3, n_drafts=4, n_beams=2,
              mode_groups={m: 2 for m in MODES})
    kw.update(dict(max_src=96) if backend == "mt" else
              dict(max_src=28, prefill_chunk=8, eos_id=2, paged=True,
                   page_size=8))
    return kw


def _queries(toys, backend: str) -> list:
    """One query a mode: (query, mode)."""
    qs = ([toys["ds"].pair(i)[0] for i in range(4)] if backend == "mt"
          else toys["prompts"])
    return list(zip(qs, MODES))


def _q(toys, i):
    return toys["ds"].pair(i)[0]


def _warm(toys, backend: str):
    return _queries(toys, backend)[0]


# ---------------------------------------------------------------------------
# the doors


class MeshDoor:
    """``mesh_runs.front_door`` on every rank of the world: ``port`` once
    rank 0 has bound it; ``stop(how)`` stops it and returns every rank's
    report."""

    def __init__(self, world, tmp_path, model: dict, engine: dict, *,
                 server: dict | None = None, warm=None, mesh=(2, 2),
                 leader: bool = True):
        self.world, self.reports = world, None
        self._port = tmp_path / "port"
        self._stop = tmp_path / "stop"
        world.start(DOOR, on_card=False, model=model, engine=engine,
                    mesh=mesh, server=dict(realtime=False, **(server or {})),
                    warm=warm, leader=leader, port_file=str(self._port),
                    stop_file=str(self._stop))
        self.port = None
        if leader:
            deadline = time.monotonic() + 120
            while not self._port.exists():
                if time.monotonic() > deadline:
                    self.stop()
                    raise AssertionError("the mesh door never bound a port")
                time.sleep(0.01)
            self.port = int(self._port.read_text())

    def stop(self, how: str = "stop") -> list:
        if self.reports is None:
            self._stop.write_text(how)
            self.reports = self.world.collect()
        return self.reports

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def _port_engine(toys, backend: str, kw: dict, **extra):
    params, cfg = toys["port"][backend]
    tok = toys["tok"] if backend == "mt" else None
    eng = StreamingEngine(params, cfg, tok, EngineConfig(**kw, **extra),
                          device="cpu")
    q, m = _warm(toys, backend)
    eng.submit(np.asarray(q, np.int32) if isinstance(q, list) else q, mode=m)
    eng.serve()
    eng.reset()
    return eng


def _port_door(toys, backend: str, kw: dict, **server):
    return FrontDoorServer(_port_engine(toys, backend, kw),
                           ServerConfig(realtime=False, **server)).start()


def _jax_door(toys, backend: str, kw: dict):
    p, cfg, tok = toys["jax"][backend]
    eng = JaxEngine(p, cfg, tok, JaxEngineConfig(mesh=jax_mesh((2, 2)),
                                                 **kw))
    q, m = _warm(toys, backend)
    eng.submit(np.asarray(q, np.int32) if isinstance(q, list) else q, mode=m)
    eng.serve()
    eng.reset()
    return JaxFrontDoorServer(eng, JaxServerConfig(realtime=False)).start()


# ---------------------------------------------------------------------------
# the wire


class SSEClient:
    """An incremental SSE reader: events one at a time, so a test can act
    mid-stream."""

    def __init__(self, port, payload, timeout=60.0):
        body = json.dumps(payload).encode()
        self.sock = socket.create_connection((HOST, port), timeout=timeout)
        self.sock.sendall(
            f"POST /v1/generate HTTP/1.1\r\nHost: {HOST}\r\n"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        self.buf = b""
        while b"\r\n\r\n" not in self.buf:
            self.buf += self.sock.recv(65536)
        _, _, self.buf = self.buf.partition(b"\r\n\r\n")

    def next_event(self):
        while b"\n\n" not in self.buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                return None
            self.buf += chunk
        frame, self.buf = self.buf.split(b"\n\n", 1)
        return json.loads(frame[len(b"data: "):])

    def drain(self, prior=()):
        out = list(prior)
        while (ev := self.next_event()) is not None:
            out.append(ev)
        self.sock.close()
        return out


def _oneshot(port, data: bytes) -> bytes:
    with socket.create_connection((HOST, port), timeout=60) as s:
        s.sendall(data)
        buf = b""
        while chunk := s.recv(65536):
            buf += chunk
    return buf


def _ndjson(port, req: dict) -> list[dict]:
    buf = _oneshot(port, json.dumps(req).encode() + b"\n")
    return [json.loads(line) for line in buf.splitlines() if line]


def _stats(port) -> dict:
    nd = _ndjson(port, {"op": "stats"})[0]
    http = _oneshot(port, b"GET /v1/stats HTTP/1.1\r\nHost: x\r\n\r\n")
    assert json.loads(http.partition(b"\r\n\r\n")[2]) == nd
    return nd


def _cancel(port, rid: int) -> None:
    body = json.dumps({"rid": rid}).encode()
    _oneshot(port, f"POST /v1/cancel HTTP/1.1\r\nHost: x\r\n"
                   f"Content-Length: {len(body)}\r\n\r\n".encode() + body)


def _exchange(port, queries) -> list[list[dict]]:
    """Each (query, mode) over SSE and then over NDJSON, one at a time."""
    out = []
    for q, m in queries:
        out.append(sse_events(HOST, port, {"query": q, "mode": m}))
        out.append(_ndjson(port, {"op": "generate", "query": q, "mode": m}))
    return out


def _deltas(events) -> list:
    return [t for e in events if e["event"] == "delta" for t in e["tokens"]]


def _tokens(events) -> list:
    return events[-1]["tokens"][0]


def _same_events(got: list, want: list) -> None:
    """Event for event: equal but for log-probs, which agree within 1e-4
    (a mesh sums its partial products in another order)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "logprobs"} == \
            {k: v for k, v in w.items() if k != "logprobs"}
        if "logprobs" in w:
            np.testing.assert_allclose(g["logprobs"], w["logprobs"],
                                       rtol=1e-4, atol=1e-4)


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _same_steps(reports: list) -> None:
    """Every rank stopped cleanly after the same engine calls: the same
    steps, cancels and sheds."""
    for r in reports:
        assert r["error"] is None, r
        for k in ("steps", "n_cancelled", "n_shed", "shard_stats"):
            assert r[k] == reports[0][k], (k, r[k], reports[0][k])


# ---------------------------------------------------------------------------
# (a) the events and (e) the stats


@pytest.fixture(scope="module")
def jax_runs(toys):
    """The JAX package's door over its (2, 2) mesh engine: each backend's
    exchange and its stats after it."""
    out = {}
    for backend in ("mt", "lm"):
        srv = _jax_door(toys, backend, _kw(backend))
        try:
            events = _exchange(srv.port, _queries(toys, backend))
            out[backend] = (events, _stats(srv.port))
        finally:
            srv.shutdown(drain=False)
    return out


def _keys(d: dict) -> dict:
    return {k: _keys(v) if isinstance(v, dict) and k != "inflight" else None
            for k, v in d.items()}


@pytest.mark.parametrize("backend", ["mt", "lm"])
def test_mesh_door_events_equal_jax_and_unsharded(world, toys, jax_runs,
                                                  tmp_path, backend):
    kw = _kw(backend)
    queries = _queries(toys, backend)
    with MeshDoor(world, tmp_path, toys[backend], kw,
                  warm=_warm(toys, backend)) as door:
        got = _exchange(door.port, queries)
        stats = _stats(door.port)
    reports = door.reports
    _same_steps(reports)
    srv = _port_door(toys, backend, kw)
    try:
        plain = _exchange(srv.port, queries)
        plain_stats = _stats(srv.port)
    finally:
        srv.shutdown(drain=False)
    want, jax_stats = jax_runs[backend]
    for g, p, w in zip(got, plain, want):
        assert [e["event"] for e in g][-1] == "done", g
        assert g[-1]["status"] == "finished"
        _same_events(g, p)
        _same_events(g, w)
    strip = lambda evs: [{k: v for k, v in e.items() if k != "rid"}
                         for e in evs]
    for i in range(0, len(got), 2):   # NDJSON carries the SSE events
        assert strip(got[i + 1]) == strip(got[i])
    # (e): the stats' keys, and shard_stats() == JAX's door over its mesh
    # (a sharded pool adds its segments' peaks and capacities)
    assert _keys(stats) == _keys(jax_stats)
    assert dict(_keys(stats), shard_stats=None) == \
        dict(_keys(plain_stats), shard_stats=None)
    assert stats["shard_stats"] == jax_stats["shard_stats"]
    assert stats["shard_stats"]["n_shards"] == 2
    assert stats["accepted"] == jax_stats["accepted"] == len(got)
    assert stats["n_steps"] == reports[0]["steps"]
    for r in reports:   # every rank saw every submission and step
        assert r["stats"]["n_steps"] == stats["n_steps"]
        assert r["stats"]["shard_stats"] == stats["shard_stats"]


# ---------------------------------------------------------------------------
# (b) cancel, the slow consumer, the late subscriber


def test_mesh_door_cancel_over_the_wire(world, toys, tmp_path):
    q = _q(toys, 5)
    want = _tokens(sse_events(HOST, (srv := _port_door(toys, "mt",
                                                       LONG)).port,
                              {"query": q}))
    srv.shutdown(drain=False)
    with MeshDoor(world, tmp_path, toys["mt"], LONG,
                  warm=(_q(toys, 0), "greedy")) as door:
        c = SSEClient(door.port, {"query": q})
        accepted = c.next_event()
        assert accepted["event"] == "accepted"
        first = c.next_event()
        assert first["event"] == "delta"
        _cancel(door.port, accepted["rid"])
        rest = c.drain(prior=[accepted, first])
        after = sse_events(HOST, door.port, {"query": q, "max_new": 8})
    assert rest[-1]["event"] == "done" and rest[-1]["status"] == "cancelled"
    got = _deltas(rest)
    assert got == want[:len(got)] and len(got) < len(want)
    assert _tokens(after) == want[:8]   # the door serves on after a cancel
    _same_steps(door.reports)
    assert all(r["n_cancelled"] == 1 for r in door.reports)


def test_mesh_door_slow_consumer_disconnected_and_cancelled(world, toys,
                                                            tmp_path):
    with MeshDoor(world, tmp_path, toys["mt"], LONG,
                  server=dict(max_buffered_events=2, writer_delay_s=0.2),
                  warm=(_q(toys, 0), "greedy")) as door:
        c = SSEClient(door.port, {"query": _q(toys, 6)})
        assert c.next_event()["event"] == "accepted"
        c.drain()
        assert _wait(lambda: _stats(door.port)["slow_disconnects"] == 1)
        assert _wait(lambda: _stats(door.port)["n_cancelled"] == 1)
    _same_steps(door.reports)
    assert door.reports[0]["stats"]["slow_disconnects"] == 1
    assert all(r["n_cancelled"] == 1 for r in door.reports)


@pytest.mark.parametrize("backend,after", [("mt", 4), ("lm", 6)])
def test_late_subscriber_on_rank_0_catches_up(world, toys, backend, after):
    """Rank 0 alone subscribes mid-flight: its catch-up reads no other
    rank (no collective), and its chunks equal the unsharded engine's."""
    kw = (dict(LONG, mode="speculative", draft_len=3, n_drafts=4)
          if backend == "mt" else
          dict(_kw(backend), mode_groups=None, mode="speculative",
               n_slots=2))
    q = _queries(toys, backend)[1][0]
    ref = mesh_runs.late_stream(toys[backend], kw, q, after=after,
                                mesh=None, on_card=False)
    got = world.run("repro_torch.launch.mesh_runs:late_stream",
                    on_card=False, model=toys[backend], engine=kw, query=q,
                    after=after)
    # tokens were committed before the subscription: the first chunk is
    # the catch-up, live deltas follow
    assert len(ref["chunks"][0]) >= ref["before"] > 0
    assert len(ref["chunks"]) >= 2
    assert got[0]["chunks"] == ref["chunks"]
    assert sum(got[0]["chunks"], []) == ref["tokens"]
    assert all(r["tokens"] == ref["tokens"] and not r["chunks"]
               for r in got[1:])


# ---------------------------------------------------------------------------
# (c) rejections at rank 0's door


def test_mesh_door_rejections_stay_on_rank_0(world, toys, tmp_path):
    with MeshDoor(world, tmp_path, toys["mt"], LONG,
                  server=dict(tenant_quota={"acme": 1},
                              quota_retry_after=7.5,
                              tenant_rate={"zen": 0.01},
                              tenant_burst={"zen": 1}),
                  warm=(_q(toys, 0), "greedy")) as door:
        a = SSEClient(door.port, {"query": _q(toys, 1), "tenant": "acme"})
        assert a.next_event()["event"] == "accepted"
        rej = sse_events(HOST, door.port, {"query": _q(toys, 2),
                                           "tenant": "acme"})
        assert rej == [{"event": "rejected", "error": "quota",
                        "tenant": "acme", "retry_after": 7.5}]
        zen = sse_events(HOST, door.port, {"query": _q(toys, 2),
                                           "tenant": "zen"})
        assert zen[-1]["status"] == "finished"
        limited = sse_events(HOST, door.port, {"query": _q(toys, 2),
                                               "tenant": "zen"})
        assert [e["error"] for e in limited] == ["rate"]
        assert limited[0]["retry_after"] > 0
        assert a.drain()[-1]["status"] == "finished"
        again = sse_events(HOST, door.port, {"query": _q(toys, 2),
                                             "tenant": "acme"})
        assert again[-1]["status"] == "finished"
    _same_steps(door.reports)
    r0 = door.reports[0]["stats"]
    assert (r0["quota_rejected"], r0["rate_limited"], r0["accepted"]) == \
        (1, 1, 3)
    for r in door.reports[1:]:   # the engines never saw a rejection
        assert r["stats"]["accepted"] == 0
        assert r["stats"]["quota_rejected"] == r["stats"]["rate_limited"] == 0


# ---------------------------------------------------------------------------
# (d) graceful drain


def test_mesh_door_graceful_drain(world, toys, tmp_path):
    """Two residents mid-stream (one a shard), a third queued: a drain
    sheds the third with a retry hint, finishes the residents
    token-identically and stops every rank."""
    qa, qb, qc = _q(toys, 7), _q(toys, 8), _q(toys, 9)
    door = MeshDoor(world, tmp_path, toys["mt"], LONG,
                    warm=(_q(toys, 0), "greedy"))
    try:
        a = SSEClient(door.port, {"query": qa})
        assert a.next_event()["event"] == "accepted"
        assert a.next_event()["event"] == "delta"
        b = SSEClient(door.port, {"query": qb})
        assert b.next_event()["event"] == "accepted"
        c = SSEClient(door.port, {"query": qc})
        assert c.next_event()["event"] == "accepted"
        door._stop.write_text("drain")
        c_done = c.drain()[-1]
        a_done, b_done = a.drain()[-1], b.drain()[-1]
    finally:
        reports = door.stop("drain")
    assert c_done["status"] == "shed" and c_done["retry_after"] > 0
    eng = _port_engine(toys, "mt", LONG)
    for q, done in ((qa, a_done), (qb, b_done)):
        r = eng.submit(q).result()
        assert done["status"] == "finished"
        assert done["tokens"] == [[int(x) for x in row[:int(n)]]
                                  for row, n in zip(r.tokens, r.lengths)]
    _same_steps(reports)
    assert all(r["n_shed"] == 1 for r in reports)
    assert reports[0]["stats"]["draining"] is True
    assert reports[0]["stats"]["shard_stats"]["admitted_by_shard"] == [1, 1]


# ---------------------------------------------------------------------------
# (f) the fleet over a mesh replica


def test_fleet_over_a_mesh_door_and_an_unsharded_replica(world, toys,
                                                         tmp_path):
    qs = [_q(toys, i) for i in range(1, 4)]
    kw = dict(LONG, max_new=12)
    plain = _port_door(toys, "mt", kw)
    router = None
    try:
        with MeshDoor(world, tmp_path, toys["mt"], kw,
                      warm=(_q(toys, 0), "greedy")) as door:
            want = [_tokens(sse_events(HOST, plain.port, {"query": q}))
                    for q in qs]
            router = FleetRouter([(HOST, door.port), (HOST, plain.port)],
                                 FleetConfig(probe_interval_s=0.05)).start()
            st = router.stats(fresh=True)
            assert st["n_healthy"] == 2
            mesh_stats = router.clients[0].last_stats
            assert mesh_stats["shard_stats"] == _stats(door.port)[
                "shard_stats"]
            assert mesh_stats["shard_stats"]["n_shards"] == 2
            via = [sse_events(HOST, router.port, {"query": q}) for q in qs]
            for events, w in zip(via, want):
                assert events[-1]["status"] == "finished"
                assert _tokens(events) == _deltas(events) == w
            # cancel through the router, on the replica that holds it
            c = SSEClient(router.port, {"query": qs[0]})
            accepted = c.next_event()
            assert accepted["event"] == "accepted"
            _cancel(router.port, accepted["rid"])
            assert c.drain(prior=[accepted])[-1]["status"] == "cancelled"
            # the unsharded replica goes: the mesh door takes every request
            plain.shutdown(drain=False)
            assert _wait(lambda: router.stats(fresh=True)["n_healthy"] == 1)
            after = [sse_events(HOST, router.port, {"query": q})
                     for q in qs[:2]]
            assert [e[0]["replica"] for e in after] == [0, 0]
            assert [_tokens(e) for e in after] == want[:2]
            placed = router.stats()["replicas"]["0"]["submitted"]
    finally:
        if router is not None:
            router.shutdown()
        plain.shutdown(drain=False)
    _same_steps(door.reports)
    assert placed >= 2
    assert door.reports[0]["stats"]["accepted"] == placed


# ---------------------------------------------------------------------------
# (g) a rank 0 that is gone


def test_follower_raises_when_rank_0_is_gone(toys, tmp_path):
    limit = 2.0
    with World(2, device="cpu") as w:
        door = MeshDoor(w, tmp_path, toys["mt"], dict(LONG, max_new=8),
                        mesh=(1, 2), leader=False,
                        server=dict(follower_timeout_s=limit))
        reports = door.stop()
    follower = reports[1]
    assert "no word from rank 0" in follower["error"]
    assert limit <= follower["waited_s"] < limit + 10.0


# ---------------------------------------------------------------------------
# a door over a (1, 1) mesh engine in this process


def test_one_rank_mesh_door_serves_as_the_unsharded_door(toys, tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serving_mesh

    kw = _kw("mt")
    queries = _queries(toys, "mt")[:2]
    srv = _port_door(toys, "mt", kw)
    try:
        want = _exchange(srv.port, queries)
    finally:
        srv.shutdown(drain=False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        params, cfg = toys["port"]["mt"]
        eng = StreamingEngine(params, cfg, toys["tok"], EngineConfig(
            mesh=make_serving_mesh((1, 1)), **kw), device="cpu")
        q, m = _warm(toys, "mt")
        eng.submit(q, mode=m)
        eng.serve()
        eng.reset()
        srv = FrontDoorServer(eng, ServerConfig(realtime=False)).start()
        try:
            got = _exchange(srv.port, queries)
            stats = _stats(srv.port)
        finally:
            srv.shutdown(drain=True)
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, want):
        _same_events(g, w)
    assert stats["shard_stats"]["n_shards"] == 1 and srv.error is None
