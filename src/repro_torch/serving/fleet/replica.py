"""One fleet replica: a ``FrontDoorServer`` over one engine, as a process
(the port of ``repro.serving.fleet.replica``).

    PYTHONPATH=src python -m repro_torch.serving.fleet.replica --port 0 \
        --model synthetic --mode greedy --slots 2 [--device cpu]

Builds the model DETERMINISTICALLY (fixed init seed), warms the engine
(compile + one admit) so the first proxied request never pays a tracing
stall, starts the front door, and prints the readiness handshake

    FLEET_REPLICA_READY port=<bound port>

on stdout — the line ``spawn_replicas`` (and the CI fleet smoke) blocks
on. Determinism across replicas is what makes router failover invisible:
every replica of a fleet initialises identical weights from the same
seed, so a request rerouted mid-queue decodes the exact token stream the
first replica would have produced.

The model: ``--model synthetic``, the toy Molecular Transformer —
``SyntheticReactionDataset`` + the tiny seq2seq config; ``--model arch
--arch <name> [--reduced]``, a decoder-only architecture of
``repro_torch.configs`` (dense, MoE, the Mamba hybrid or RWKV6; an
attention-free one without ``--paged``) served token-in / token-out
(``tokenizer=None``, EOS id 2). Weights are drawn from ``torch.Generator().manual_seed(0)``.
``--device`` follows the port's rule: the card unless ``cpu`` is asked
for.

SIGTERM drains gracefully (residents finish token-identically, the
router reroutes refused work); SIGKILL is the replica-death drill — the
router's probes and broken streams detect it.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
import time


def build_engine(args):
    """Deterministic model + warmed ``StreamingEngine`` (imports live
    here so ``spawn_replicas`` is importable without torch)."""
    import numpy as np
    import torch

    from repro_torch.serving import EngineConfig, StreamingEngine

    ecfg_kw = dict(mode=args.mode, max_new=args.max_new,
                   max_src=args.max_src, n_slots=args.slots,
                   draft_len=args.draft_len, n_drafts=args.n_drafts,
                   paged=args.paged, page_size=args.page_size,
                   prefix_cache=args.prefix_cache,
                   prefill_chunk=args.prefill_chunk)
    gen = torch.Generator().manual_seed(0)
    if args.model == "synthetic":
        from repro_torch.configs.mt import tiny_config
        from repro_torch.data import SyntheticReactionDataset
        from repro_torch.models import seq2seq as s2s

        ds = SyntheticReactionDataset(16, seed=0)
        cfg = tiny_config(ds.tokenizer.vocab_size, depth=2, d_model=64,
                          max_len=192)
        params = s2s.init(gen, cfg, device=args.device)
        eng = StreamingEngine(params, cfg, ds.tokenizer,
                              EngineConfig(**ecfg_kw), device=args.device)
        warm = ds.pair(0)[0]
    else:
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as tr

        cfg = get_config(args.arch, reduced=args.reduced)
        params = tr.init(gen, cfg, device=args.device)
        eng = StreamingEngine(params, cfg, None,
                              EngineConfig(eos_id=2, **ecfg_kw),
                              device=args.device)
        rng = np.random.default_rng(0)
        warm = rng.integers(4, cfg.vocab_size,
                            size=(min(16, args.max_src),), dtype=np.int32)
    eng.submit(warm)
    eng.serve()
    eng.reset()
    return eng


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--model", default="synthetic",
                    choices=("synthetic", "arch"))
    ap.add_argument("--arch", default="smollm-135m",
                    help="a registered arch id (repro_torch.configs."
                         "list_archs()); --reduced on the CPU")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", default="greedy")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--max-src", type=int, default=96)
    ap.add_argument("--draft-len", type=int, default=8)
    ap.add_argument("--n-drafts", type=int, default=8)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="where the engine runs (default: the card)")
    ap.add_argument("--step-clock", action="store_true",
                    help="drive the engine on the decode-step clock "
                         "instead of wall time (deterministic tests)")
    args = ap.parse_args(argv)

    from repro_torch.serving import FrontDoorServer, ServerConfig

    eng = build_engine(args)
    srv = FrontDoorServer(eng, ServerConfig(
        host=args.host, port=args.port,
        realtime=not args.step_clock)).start()
    print(f"FLEET_REPLICA_READY port={srv.port}", flush=True)

    done = threading.Event()

    def _term(signum, frame):
        done.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    done.wait()
    srv.shutdown(drain=True)


# --------------------------------------------------------- spawn helper
def spawn_replicas(n: int, *, extra_args: list[str] | None = None,
                   timeout: float = 300.0):
    """Launch ``n`` replica subprocesses on loopback (ephemeral ports)
    and wait for every readiness handshake. Returns
    ``(procs, addrs)`` — ``addrs`` feeds ``FleetRouter`` directly.
    Kill a replica with ``proc.kill()`` (the drill) or drain it with
    ``proc.terminate()``; ``stop_replicas`` cleans up the rest."""
    import repro_torch

    src_root = os.path.dirname(os.path.dirname(
        os.path.abspath(repro_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src_root, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-u", "-m",
           "repro_torch.serving.fleet.replica",
           "--port", "0"] + list(extra_args or [])
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True)
             for _ in range(n)]
    addrs: list[tuple[str, int]] = []
    deadline = time.monotonic() + timeout
    try:
        for proc in procs:
            port = _await_ready(proc, deadline)
            addrs.append(("127.0.0.1", port))
    except Exception:
        stop_replicas(procs)
        raise
    return procs, addrs


def _await_ready(proc, deadline: float) -> int:
    """Block until one replica prints its handshake (a reader thread
    guards against a wedged child holding the pipe open forever)."""
    result: dict = {}

    def read():
        for line in proc.stdout:
            if line.startswith("FLEET_REPLICA_READY"):
                result["port"] = int(line.split("port=")[1])
                return
        result["eof"] = True

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout=max(0.0, deadline - time.monotonic()))
    if "port" not in result:
        raise RuntimeError(
            "replica failed to come up "
            f"(rc={proc.poll()}, eof={result.get('eof', False)})")
    # keep draining stdout so the child never blocks on a full pipe
    threading.Thread(target=lambda: proc.stdout.read(),
                     daemon=True).start()
    return result["port"]


def stop_replicas(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            p.kill()


if __name__ == "__main__":
    main()
