"""Launch of the hand-written CUDA kernel ``csrc/draft_verify.cu`` (the port
of ``repro.kernels.draft_verify.kernel.draft_verify_kernel``). Takes tensors
the wrapper in ``ops.py`` has already checked.

The plan is Python, so the CPU tests can reach it (``plan``): the greedy
kernel at T 1 and a short vocab; the row path (``warps`` warps a row,
``rows`` rows a block, ``lanes`` lanes a position) for a vocab of up to a
thousand entries or so whose row fits a block's shared memory; else the
split path (a block per (row, position, vocab split), ``n_split`` splits
of ``chunk`` entries); and whether every run the kernel copies is whole
16-byte chunks from a 16-byte boundary (``vector_loads``), or takes a
scalar head and tail around its aligned body.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
N_SMS = 132                    # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 48 * 1024         # a block's shared memory without opt-in
MAX_WARPS = 8                  # row path: warps a block
GREEDY_V = 32 * 8              # greedy kernel (T 1): the largest vocab
ROW_VOCAB_BYTES = 4096         # row path: the largest vocab row it takes
LANE_ENTRIES = 16              # row path: entries a lane scans, where more
                               # warps a row (up to MAX_WARPS) can take them
SHUFFLE_STEPS = 4              # a shuffle level's cost, in scanned entries
SPLIT_THREADS = 256            # split path: threads a block
SPLIT_BYTES = SPLIT_THREADS * 4 * 16   # one round of a block's loads (4 in
                                       # flight a thread): a split's least
SPLIT_BLOCKS = 4 * N_SMS       # split path: the grid it fills up to
CHUNK_ALIGN = 16               # a split's entries: a multiple of this

_tickets: dict[torch.device, torch.Tensor] = {}


class Plan(NamedTuple):
    rows: int       # row path: rows a block; 0: the split path
    warps: int      # row path: warps a row
    lanes: int      # row path: lanes a position; 0: the greedy kernel
    n_split: int    # split path: blocks a (row, position)
    chunk: int      # split path: vocab entries a split


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def row_bytes(T: int, V: int, itemsize: int) -> int:
    """A row's shared memory on the row path (``draft_verify.cu``'s
    ``row_bytes``): the T*V logits with 16 bytes of slack, the drafts and
    the tokens."""
    return (_up(T * V * itemsize, 16) + 16 + _up(4 * (T - 1), 16)
            + _up(4 * T, 16))


def warps_per_row(T: int, V: int) -> int:
    """Warps that share a row on the row path: enough that a lane scans
    about LANE_ENTRIES of the row's T*V entries, at most MAX_WARPS."""
    return max(1, min(MAX_WARPS, -(-T * V // (32 * LANE_ENTRIES))))


def lanes_per_position(T: int, V: int, warps: int = 1) -> int:
    """The lanes (a power of two) that share a position on the row path:
    the fewest steps a lane takes, each pass ``ceil(V / lanes)`` scanned
    entries and ``log2(lanes)`` shuffle levels, for ``ceil(T / (32 *
    warps / lanes))`` passes; the most lanes among equals."""
    def steps(g):
        return (-(-T * g // (32 * warps))
                * (-(-V // g) + SHUFFLE_STEPS * int(math.log2(g))))
    return min((32, 16, 8, 4, 2, 1), key=steps)


def plan(N: int, T: int, V: int, itemsize: int) -> Plan:
    """At T 1 and V <= GREEDY_V the greedy kernel, one warp a row. Else the
    row path where the vocab row is at most ROW_VOCAB_BYTES and a row's run
    fits the block's shared memory: ``warps_per_row``, and rows a block to
    leave about N_SMS blocks (at least one row; at most MAX_WARPS warps and
    what the shared memory holds). Else the split path: one block a (row,
    position) where those reach SPLIT_BLOCKS, else enough vocab splits to
    reach it, each at least SPLIT_BYTES and a multiple of CHUNK_ALIGN
    entries, none empty."""
    if T == 1 and V <= GREEDY_V:
        return Plan(max(1, min(N // N_SMS, MAX_WARPS)), 1, 0, 1, V)
    rb = row_bytes(T, V, itemsize)
    if V * itemsize <= ROW_VOCAB_BYTES and rb <= SMEM_LIMIT:
        w = warps_per_row(T, V)
        rows = max(1, min(N // N_SMS, MAX_WARPS // w, SMEM_LIMIT // rb))
        return Plan(rows, w, lanes_per_position(T, V, w), 1, V)
    blocks = max(1, N * T)
    return split_plan(V, min(-(-V * itemsize // SPLIT_BYTES),
                             -(-SPLIT_BLOCKS // blocks)))


def split_plan(V: int, n_split: int) -> Plan:
    """The split path with about ``n_split`` splits: whole CHUNK_ALIGN
    multiples of entries, none empty."""
    chunk = _up(-(-V // max(1, n_split)), CHUNK_ALIGN)
    return Plan(0, 0, 0, -(-V // chunk), chunk)


def vector_loads(ptr: int, itemsize: int, run: int) -> bool:
    """True when every run the kernel copies starts on a 16-byte boundary
    and is whole 16-byte chunks: the base pointer is 16-byte aligned and a
    run of ``run`` entries (T*V on the row path, V on the split path, whose
    splits are whole chunks) is a multiple of 16 bytes. Else each run takes
    a scalar head and tail around its aligned body."""
    return ptr % 16 == 0 and run * itemsize % 16 == 0


def _scratch(device, N, T, p: Plan):
    """Split partials and the per-row ticket counters
    (``_build.tickets``), or NULLs on the row path."""
    if p.rows:
        return None, 0, 0
    part = torch.empty(2 * N * T * p.n_split, dtype=torch.float32,
                       device=device)
    t = _build.tickets(_tickets, device, N, lambda n: torch.zeros(
        n, dtype=torch.int32, device=device))
    return part, part.data_ptr(), t.data_ptr()


def draft_verify_kernel(logits, drafts, draft_mask, *,
                        n_split: int | None = None):
    """logits: (N, T, V) contiguous, N >= 1; drafts: (N, T-1) contiguous
    int32; draft_mask: (N,) contiguous bool. ``n_split`` forces the split
    path with that many splits (for measurements). Returns (tokens (N, T)
    int32, n_acc (N,) int32)."""
    N, T, V = logits.shape
    isz = logits.element_size()
    p = plan(N, T, V, isz) if n_split is None else split_plan(V, n_split)
    whole = vector_loads(logits.data_ptr(), isz, T * V if p.rows else V)
    tokens = torch.empty((N, T), dtype=torch.int32, device=logits.device)
    n_acc = torch.empty((N,), dtype=torch.int32, device=logits.device)
    keep, part, tickets = _scratch(logits.device, N, T, p)
    fn = _build.load("draft_verify")
    err = fn(logits.data_ptr(), drafts.data_ptr(), draft_mask.data_ptr(),
             tokens.data_ptr(), n_acc.data_ptr(), part, tickets, N, T, V,
             p.rows, p.warps, p.lanes, p.n_split, p.chunk, int(whole),
             _DTYPES[logits.dtype],
             torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check("draft_verify", err)
    del keep   # reused by the caching allocator only for later work on this stream
    return tokens, n_acc
