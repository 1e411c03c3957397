"""A world of ranks on one host: the process group a serving mesh lays
itself over (``repro_torch.launch.mesh.make_serving_mesh``).

The backend rule: NCCL when each rank has a card of its own, gloo when
ranks share a card or run on the CPU (NCCL refuses two ranks on one card;
gloo takes CUDA tensors for ``all_reduce`` and ``broadcast``, which is all
the model's collectives use, and CPU tensors for the host's). The rule is
stated, never tried and switched.

``init_world`` joins a world whose rendezvous is a file store or torchrun's
environment (``init_method="env://"``). ``World`` starts ``n`` ranks as
child processes, each pinned to one thread, that stay up and run the jobs
given them (``"module:function"`` plus keyword arguments) in lockstep: a
test module or ``chip_smoke.py`` starts one world and runs many engines
through it. The rendezvous is a file store in a fresh temporary directory,
never a fixed port, so worlds of parallel test workers never meet. A rank
that raises fails the job; the world is then torn down, since the other
ranks may wait on it inside a collective.
"""

from __future__ import annotations

import importlib
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch


def backend_for(world_size: int, device) -> str:
    """"nccl" when every rank of ``world_size`` has a card of its own,
    else "gloo" (ranks sharing a card, or on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def rank_device(rank: int, device) -> torch.device:
    """The card a rank computes on: its own under NCCL, the shared one
    (ranks modulo the cards) under gloo; or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


def init_world(rank: int, world_size: int, *, device,
               init_method: str = "env://") -> str:
    """Join the world by the backend rule; returns the backend."""
    import torch.distributed as dist

    backend = backend_for(world_size, device)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return backend


def host_group(group=None):
    """A gloo group over ``group``'s ranks (None: the world) for the host's
    CPU tensors: the group itself under gloo, else a gloo group made once
    (every rank must reach the first call together)."""
    import torch.distributed as dist

    if dist.get_backend(group) == "gloo":
        return group
    key = None if group is None else tuple(dist.get_process_group_ranks(group))
    made = _host_groups.get(key)
    if made is None:
        ranks = (None if group is None
                 else dist.get_process_group_ranks(group))
        made = _host_groups[key] = dist.new_group(ranks, backend="gloo")
    return made


_host_groups: dict = {}


def _resolve(path: str):
    mod, fn = path.split(":")
    return getattr(importlib.import_module(mod), fn)


def _rank_main(rank: int, n: int, store: str, device: str, inbox, outbox):
    torch.set_num_threads(1)   # n ranks on a shared host: no oversubscription
    try:
        backend = init_world(rank, n, device=device,
                             init_method=f"file://{store}")
        outbox.put((rank, "ready", backend))
    except Exception:
        outbox.put((rank, "error", traceback.format_exc()))
        return
    import torch.distributed as dist

    while True:
        job = inbox.get()
        if job is None:
            break
        fn, kwargs = job
        try:
            outbox.put((rank, "ok", _resolve(fn)(**kwargs)))
        except Exception:
            outbox.put((rank, "error", traceback.format_exc()))
            break
    dist.destroy_process_group()


class World:
    """``n`` ranks in child processes (``device``: "cpu" or "cuda") that
    run jobs in lockstep until ``close()``."""

    def __init__(self, n: int, *, device: str = "cpu",
                 timeout_s: float = 600.0):
        import torch.multiprocessing as mp

        self.n, self.device, self.timeout_s = n, device, timeout_s
        self._dir = tempfile.mkdtemp(prefix="repro_torch_world_")
        ctx = mp.get_context("spawn")
        self._inboxes = [ctx.Queue() for _ in range(n)]
        self._outbox = ctx.Queue()
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, n, os.path.join(self._dir, "store"), device,
                  self._inboxes[r], self._outbox)) for r in range(n)]
        for p in self._procs:
            p.start()
        self.backend = self._collect("start")[0]

    def _collect(self, what: str) -> list:
        got: dict[int, object] = {}
        deadline = time.monotonic() + self.timeout_s
        while len(got) < self.n:
            left = deadline - time.monotonic()
            try:
                rank, status, value = self._outbox.get(
                    timeout=max(1.0, min(left, 5.0)))
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive() and r not in got]
                if dead or left <= 0:
                    self.close(force=True)
                    raise RuntimeError(
                        f"world {what}: ranks {dead or 'all'} "
                        f"{'died' if dead else 'timed out'}")
                continue
            if status == "error":
                self.close(force=True)
                raise RuntimeError(f"world {what}: rank {rank} raised:\n"
                                   f"{value}")
            got[rank] = value
        return [got[r] for r in range(self.n)]

    def run(self, fn: str, **kwargs) -> list:
        """Run ``fn`` ("module:function") on every rank with ``kwargs``;
        returns each rank's result, rank order."""
        if not self._procs:
            raise RuntimeError("the world is closed")
        for box in self._inboxes:
            box.put((fn, kwargs))
        return self._collect(fn)

    def close(self, force: bool = False) -> None:
        if not self._procs:
            return
        if not force:
            for box in self._inboxes:
                box.put(None)
            for p in self._procs:
                p.join(timeout=30)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self._procs = []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(force=exc[0] is not None)
