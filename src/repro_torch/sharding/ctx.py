"""Activation-sharding and tensor-parallel context, the port of
``repro.sharding.ctx``.

``activation_rules(mesh, batch=, seq=)`` / ``constrain_activation(x)`` keep
the JAX package's surface: under the serving mesh every rank already holds
only its own rows, so the constraint is the identity.

``tensor_parallel(...)`` installs the model-axis group the layers reduce
over while a sharded engine runs its model. Outside it (one device, the
tests' CPU path, training) ``current()`` is None and every layer runs
exactly as it does unsharded. Inside it:

- a row-parallel projection (``wo``, ``w_out``: its input dim split over
  ``model``) sums its partial products with one ``all_reduce`` before its
  bias (``row_reduce``);
- a vocab-parallel embedding looks up its own rows and sums the rows of
  every rank (``embed_lookup``);
- vocab-split logits are gathered whole (``gather_last``) before anything
  reads them (``draft_verify``, the beam step's log-softmax);
- a per-channel slice is gathered whole on its last dim (``model_gather``:
  RWKV's ``ln_x``, a LayerNorm over the whole width) and a whole tensor
  cut to this rank's channels (``model_slice``);
- an expert-parallel MoE FFN (its experts split on their expert dim,
  ``TensorParallel.expert_split``) sums its output over the model axis
  (``model_sum``, ``expert_reduce``): each choice's expert lives on one
  rank, so the sum adds zeros to each term, exact for top-1 and top-2;
- the MoE router places its choices in the global call's order: the
  per-expert counts of the lower data shards and the global token count
  come from one ``all_reduce`` over the data axis
  (``data_prefix_counts``).

Which weights are split is recorded by identity when the engine lays the
params out (``TensorParallel.row_split`` / ``vocab_split`` /
``expert_split``), so a layer never guesses from shapes. A gather is an
``all_reduce`` of a zeroed buffer into which each rank writes its slice:
exact (x + 0 = x), and one collective that gloo also takes for CUDA
tensors, where it takes no ``all_gather``. Every other collective here is
a sum that reorders the fp32 additions of the unsharded op (a row-split
projection's partial products), except where it says exact.
``n_collectives`` counts the model-axis collectives issued,
``n_data_collectives`` the data-axis ones.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

_state = threading.local()


# ---------------------------------------------------------------------------
# activation rules (the JAX package's surface)


def _rules():
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def activation_rules(mesh, *, batch=("data",), seq=None):
    prev = _rules()
    _state.rules = {"mesh": mesh, "batch": batch, "seq": seq}
    try:
        yield
    finally:
        _state.rules = prev


def constrain_activation(x):
    """The identity: a rank's activations are its own rows already."""
    return x


# ---------------------------------------------------------------------------
# tensor parallelism over the mesh's model axis


@dataclasses.dataclass
class TensorParallel:
    group: object            # the model axis's process group
    rank: int                # this rank's index on the model axis
    size: int                # the model axis's size
    row_split: frozenset     # id() of weights whose input dim is split
    vocab_split: frozenset   # id() of embeddings / heads split over vocab
    expert_split: frozenset = frozenset()  # id() of experts split on dim 0
    data_group: object = None  # the data axis's process group
    data_rank: int = 0       # this rank's data shard
    data_size: int = 1       # the data axis's size
    n_collectives: int = 0
    n_data_collectives: int = 0


def current() -> TensorParallel | None:
    return getattr(_state, "tp", None)


@contextlib.contextmanager
def tensor_parallel(tp: TensorParallel | None):
    """Run the model with ``tp`` (None: unsharded) on this thread."""
    prev = current()
    _state.tp = tp
    try:
        yield tp
    finally:
        _state.tp = prev


def _all_reduce(tp: TensorParallel, x: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    dist.all_reduce(x, group=tp.group)
    tp.n_collectives += 1
    return x


def row_reduce(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum a row-parallel projection's partial products over the model
    axis (``w``: the projection's weight, as laid out)."""
    tp = current()
    if tp is None or id(w) not in tp.row_split:
        return y
    return _all_reduce(tp, y)


def model_sum(y: torch.Tensor) -> torch.Tensor:
    """``y`` summed over the model axis (unsharded: ``y``)."""
    tp = current()
    return y if tp is None or tp.size == 1 else _all_reduce(tp, y)


def model_slice(x: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's ``n`` channels of ``x``'s last dim: ``x`` as it is when
    it holds ``n`` already (unsharded, or a whole weight beside it)."""
    tp = current()
    if tp is None or x.shape[-1] == n:
        return x
    return x[..., tp.rank * n:(tp.rank + 1) * n]


def model_gather(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x``'s last dim whole (``n`` wide) from each rank's equal slice:
    ``x`` as it is when it holds ``n`` already. Exact (a zeroed buffer
    summed)."""
    tp = current()
    if tp is None or x.shape[-1] == n:
        return x
    w = x.shape[-1]
    full = x.new_zeros((*x.shape[:-1], n))
    full[..., tp.rank * w:(tp.rank + 1) * w] = x
    return _all_reduce(tp, full)


def expert_offset(w: torch.Tensor) -> int:
    """The global index of the first expert of a stacked ``(E_local, ...)``
    expert weight ``w`` on this rank (0 when the experts are whole)."""
    tp = current()
    if tp is None or id(w) not in tp.expert_split:
        return 0
    return tp.rank * w.shape[0]


def expert_split(w: torch.Tensor) -> bool:
    """True when ``w`` is a stacked expert weight split over the model
    axis (the FFN's output is then summed there)."""
    tp = current()
    return tp is not None and id(w) in tp.expert_split


def row_split(w: torch.Tensor) -> bool:
    """True when ``w``'s input dim is split over the model axis."""
    tp = current()
    return tp is not None and id(w) in tp.row_split


def data_prefix_counts(counts: torch.Tensor, n: int
                       ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """``(prefix, total, n_total)`` of an integer vector ``counts`` and a
    count ``n`` over the data shards: the sum of the lower shards'
    vectors, of every shard's, and every shard's ``n``, by one
    ``all_reduce`` of an ``(n_shards, len + 1)`` buffer over the data
    axis, each rank writing its own row (exact: integers; ``n_total`` is
    read on the host). Unsharded: ``(0, counts, n)``, no collective and no
    read."""
    tp = current()
    if tp is None or tp.data_size == 1:
        return torch.zeros_like(counts), counts, n
    import torch.distributed as dist

    buf = counts.new_zeros((tp.data_size, counts.shape[0] + 1))
    buf[tp.data_rank, :-1] = counts
    buf[tp.data_rank, -1] = n
    dist.all_reduce(buf, group=tp.data_group)
    tp.n_data_collectives += 1
    return (buf[:tp.data_rank, :-1].sum(0), buf[:, :-1].sum(0),
            int(buf[:, -1].sum()))


def row_input(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The slice of ``x`` a row-split ``w`` multiplies: ``x`` as it is when
    it is already this rank's slice (its heads split with ``wq``), else the
    rank's contiguous part of the whole (``wq`` whole, ``wo`` split)."""
    tp = current()
    if tp is None or id(w) not in tp.row_split or x.shape[-1] == w.shape[0]:
        return x
    n = w.shape[0]
    return x[..., tp.rank * n:(tp.rank + 1) * n]


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; on a vocab-split table, this rank's rows (zero
    elsewhere) summed over the model axis."""
    tp = current()
    if tp is None or id(table) not in tp.vocab_split:
        return table[tokens.long()]
    n = table.shape[0]
    local = tokens.long() - tp.rank * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return _all_reduce(tp, rows)


def gather_last(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Logits from a vocab-split head ``w`` gathered whole on the last dim
    (this rank's slice at its offset, zeros elsewhere, summed)."""
    tp = current()
    if tp is None or id(w) not in tp.vocab_split:
        return y
    n = y.shape[-1]
    full = y.new_zeros((*y.shape[:-1], n * tp.size))
    full[..., tp.rank * n:(tp.rank + 1) * n] = y
    return _all_reduce(tp, full)


def kv_heads_for(rank: int, n_q_local: int, n_q: int,
                 n_kv: int) -> tuple[int, int]:
    """The kv-head range ``[lo, hi)`` that query heads ``[rank * n_q_local,
    (rank + 1) * n_q_local)`` read: every kv head when ``wq`` is whole, a
    part when ``wq`` is split over the model axis and ``wk`` / ``wv`` are
    whole (the kv heads do not divide the axis). The range must give each
    of its kv heads the same number of local query heads (one GQA group
    size)."""
    if n_q_local == n_q:
        return 0, n_kv
    G = n_q // n_kv
    a = rank * n_q_local
    lo, hi = a // G, (a + n_q_local - 1) // G + 1
    if hi - lo > 1 and (a % G or n_q_local % G):
        raise ValueError(
            f"query heads [{a}, {a + n_q_local}) of {n_q} over {n_kv} kv "
            f"heads do not form equal groups on one rank")
    return lo, hi
