"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The
libraries go to ``build/repro_torch/`` at the repository root (listed in
``.gitignore``), named by a hash of the source, every ``csrc/*.cuh`` header
and the flags, so a changed source or header rebuilds and an unchanged one
loads at once. ``build_all`` starts one
``nvcc`` per source, all together. Nothing here runs at import: the CPU
tests import every module and this machine may have no ``nvcc``. One lock
covers building and loading, so threads of one process that reach a first
launch together (a server's drive thread, two replicas' engines) build
each library once.

The launch counts live here too: each kernel wrapper adds one to its count
where it launches its kernel and nowhere else, so a run can show that the
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
KERNELS = ("decode_gqa", "draft_verify", "flash_attention",
           "flash_attention_bwd", "paged_decode_gqa")   # csrc/<name>.cu

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.RLock()   # build_all and load (load calls build_all)
build_log: dict[str, str] = {}   # nvcc's output (ptxas register/smem report)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # any source may include one
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build_all(names=KERNELS) -> float:
    """Compile every kernel whose library is missing, in parallel; returns
    the wall seconds spent. Raises with nvcc's output if one fails."""
    with _lock:
        return _build_all(names)


def _build_all(names) -> float:
    t0 = time.perf_counter()
    todo = [n for n in names if not _lib_path(n).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name in todo:
            tmp = _lib_path(name).with_suffix(
                f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            else:
                os.replace(tmp, _lib_path(name))  # atomic: no half-written lib
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


# launch function -> (source, C symbol, argtypes); one launch count each
_ARGTYPES = {
    "decode_gqa": ("decode_gqa", "decode_gqa_launch",
                   [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 6
                   + [ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p]),
    "paged_decode_gqa": ("paged_decode_gqa", "paged_decode_gqa_launch",
                         [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                         + [ctypes.c_longlong] * 6
                         + [ctypes.c_int, ctypes.c_float]
                         + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
    "draft_verify": ("draft_verify", "draft_verify_launch",
                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                     + [ctypes.c_void_p]),
    "flash_attention": ("flash_attention", "flash_attention_fwd_launch",
                        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                        + [ctypes.c_longlong] * 9
                        + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                           ctypes.c_int, ctypes.c_void_p]),
    "flash_attention_bwd": ("flash_attention_bwd",
                            "flash_attention_bwd_launch",
                            [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                            + [ctypes.c_longlong] * 15
                            + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                               ctypes.c_void_p]),
}
launch_counts: dict[str, int] = {name: 0 for name in _ARGTYPES}
_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Add one to ``name``'s launch count (under a lock: engines on two
    threads launch the same kernels)."""
    with _count_lock:
        launch_counts[name] += 1


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


# the active counts of meta runs (``launch.hlo_analysis.count_cost``): each
# takes ``(kernel, flops, bytes)`` from a wrapper's meta branch, where the
# kernel is planned, not launched (the launch counts stay the launches')
work_sinks: list = []


def record_work(name: str, nbytes: int, flops: int) -> None:
    """Hand a meta call's work to every active count (none: nothing)."""
    for sink in tuple(work_sinks):
        sink(name, int(nbytes), int(flops))


def load(name: str):
    """The C launch function ``name`` (a key of ``launch_counts``), its
    source built at first use."""
    source, fn_name, argtypes = _ARGTYPES[name]
    with _lock:
        if source not in _libs:
            build_all((source,))
            _libs[source] = ctypes.CDLL(str(_lib_path(source)))
        fn = getattr(_libs[source], fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_ticket_lock = threading.Lock()


def tickets(store: dict, device, n: int, zeros):
    """A split launch's ticket counters: a zeroed int32 buffer of at least
    ``n`` entries (``zeros(size)`` makes one), kept per device in ``store``
    (the kernel module's dict) and grown under a lock, so two threads of one
    process never swap it out from under each other. The combining block of
    each row resets its counter, so the buffer stays zero between launches
    on one stream (every thread's default)."""
    with _ticket_lock:
        t = store.get(device)
        if t is None or t.numel() < n:
            t = zeros(max(n, 1024))
            store[device] = t
        return t


def check(name: str, err: int) -> None:
    """Raise on a nonzero cudaError_t from a launch."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
