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
  (``data_prefix_counts``);
- a built step's FSDP params are gathered whole over the data axis before
  the model runs (``layers_params``, by the layout ``launch.steps`` sets);
- under ``activation_rules(seq=("model",))`` the decoder-only residual
  stream is split along T over the model axis where the axis divides T
  (``seq_shards``): a block gathers its normed input whole along T
  (``seq_gather``) and, inside ``split_stream``, its output sum is a
  reduce-scatter along T (``out_reduce``, ``out_sum``) and a whole output
  is cut to the rank's positions (``out_part``).

Under autograd (a train step on a world of ranks) every forward sum is a
new tensor whose backward is the identity (``_Sum``): each rank's partial
term gets the whole sum's gradient. Its conjugate is ``enter``: the
identity whose backward sums the gradient over the model axis. It stands
wherever a tensor held whole on every model rank (an activation, or a
whole weight) enters a computation that is the rank's own: a split
projection's input, a whole tensor cut to the rank's channels
(``model_slice``, ``row_input``), a vocab-split head's input
(``vocab_input``), the tokens and gates of split experts, a whole
``wk`` / ``wv`` cut to the rank's kv heads, a norm over the rank's
heads. So every tensor held whole gets the whole gradient on every rank,
and every weight held whole its whole gradient, summed once. The data
axis: a train step takes its gradients of the gathered leaves
(``layers_params`` gathers outside autograd), reduces them over the data
axis in tree order (``reduce_gradients``: each FSDP leaf's
reduce-scattered to the rank's shard, each other leaf's all-reduced), and
sums its token count, metrics and squared norms there (``data_total``,
``model_total``). A split stream keeps the rule: the gathered input is
held whole, so its gather's backward keeps the rank's part of the whole
gradient (``_SeqGather``); a reduce-scatter's and a cut's backward gather
the ranks' gradients (``_SeqScatter``, ``_SeqCut``); a whole weight
applied to the rank's positions (a norm, a bias after the sum, a gate) is
entered (``on_positions``).

Which weights are split is recorded by identity when the engine lays the
params out (``TensorParallel.row_split`` / ``vocab_split`` /
``expert_split``), so a layer never guesses from shapes. A gather is an
``all_reduce`` of a zeroed buffer into which each rank writes its slice:
exact (x + 0 = x), and one collective that gloo also takes for CUDA
tensors, where it takes no ``all_gather``. Every other collective here is
a sum that reorders the fp32 additions of the unsharded op (a row-split
projection's partial products), except where it says exact.
``n_collectives`` counts the model-axis collectives issued,
``n_data_collectives`` the data-axis ones; a live context given a ``log``
list appends each collective's ``(kind, bytes)`` to it as a recorder
does, the data-axis gather as an ``all-gather`` of the whole.

A recording ``TensorParallel`` (``recording_tensor_parallel``) has no
process group: it stands for one rank of a planned mesh (a
``repro_torch.launch.mesh.MeshShape``) in a dry run. Each collective
appends ``(kind, bytes)`` to its ``records`` and returns its input's
shape and values unreduced (on meta: the shape), so the layers run at the
rank's local widths in one process. ``data_prefix_counts`` returns the
global token count as the local count times the data shards (a dry run's
batches divide evenly), with no host read. Under autograd a recorder
records each ``enter`` in the backward, where the live context issues it,
and a remat'd forward's collectives again where its backward recomputes
them.
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
    """Install the rules on this thread while open: ``batch`` (a rank holds
    its rows already: nothing to do) and ``seq``, ``("model",)`` to split
    the decoder-only residual stream along T over the model axis
    (``seq_shards``; None: whole)."""
    prev = _rules()
    _state.rules = {"mesh": mesh, "batch": batch, "seq": seq}
    try:
        yield
    finally:
        _state.rules = prev


def constrain_activation(x):
    """The identity: a rank's activations are its own rows already, and a
    split stream is cut where the model splits it (``seq_shards``)."""
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
    records: list | None = None  # a recorder's (kind, bytes); None: live
    log: list | None = None  # a live context's (kind, bytes), when asked
    # a world rank's param layout, by leaf path (``launch.steps`` sets it;
    # None: no layout, one rank or a plan's recorder): whether the leaf is
    # cut over the model axis, the dim an FSDP leaf is split on over the
    # data axis, and the leaves recorded as split (``"row"`` / ``"vocab"``
    # / ``"expert"``: their ``*_split`` ids are set anew on the gathered
    # params)
    model_cut: dict | None = None
    gather_dims: dict = dataclasses.field(default_factory=dict)
    split_paths: dict = dataclasses.field(default_factory=dict)


def recording_tensor_parallel(mesh, *, model_rank: int = 0,
                              data_rank: int = 0) -> TensorParallel:
    """A recorder for the rank at (``data_rank``, ``model_rank``) of
    ``mesh`` (anything ``rules.axis_sizes`` reads: a ``MeshShape``); the
    data shard is the flattened index over every axis but ``model``."""
    from repro_torch.sharding.rules import MODEL, axis_sizes

    sizes = axis_sizes(mesh)
    data = 1
    for name, n in sizes.items():
        if name != MODEL:
            data *= n
    return TensorParallel(group=None, rank=model_rank,
                          size=sizes.get(MODEL, 1), row_split=frozenset(),
                          vocab_split=frozenset(), data_rank=data_rank,
                          data_size=data, records=[])


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


def _fresh(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` (a collective sums in place)."""
    return x.clone(memory_format=torch.contiguous_format)


def _reduce(tp: TensorParallel, x: torch.Tensor, *, data: bool = False,
            kind: str = "all-reduce") -> torch.Tensor:
    """``x`` summed over the model axis (``data``: the data axis), in
    place when ``x`` is contiguous; counted, and logged or recorded as
    ``(kind, bytes)``. A recorder returns ``x`` as it is."""
    if data:
        tp.n_data_collectives += 1
    else:
        tp.n_collectives += 1
    if tp.records is not None:
        tp.records.append((kind, x.nbytes))
        return x
    import torch.distributed as dist

    x = x.contiguous()
    dist.all_reduce(x, group=tp.data_group if data else tp.group)
    if tp.log is not None:
        tp.log.append((kind, x.nbytes))
    return x


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Sum(torch.autograd.Function):
    """A sum over the model axis whose backward is the identity: each
    rank's term gets the whole sum's gradient, which every rank holds."""

    @staticmethod
    def forward(ctx_, x, tp):
        return _reduce(tp, x.view_as(x) if tp.records is not None
                       else _fresh(x))

    @staticmethod
    def backward(ctx_, g):
        return g, None


class _Enter(torch.autograd.Function):
    """The identity whose backward sums the gradient over the model axis:
    a tensor held whole on every model rank entering a computation that
    is the rank's own (its heads, channels, experts or vocabulary), whose
    backward gives only the rank's part of the gradient."""

    @staticmethod
    def forward(ctx_, x, tp):
        ctx_.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx_, g):
        tp = ctx_.tp
        return _reduce(tp, g if tp.records is not None else _fresh(g)), None


def _all_reduce(tp: TensorParallel, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model axis; under autograd a new tensor whose
    backward is the identity (``_Sum``), else in place."""
    if _grad(x):
        return _Sum.apply(x, tp)
    return _reduce(tp, x)


def enter(x: torch.Tensor) -> torch.Tensor:
    """``x``, held whole on every model rank, as the input of a computation
    that is this rank's own: the identity, whose backward sums the
    gradient over the model axis (``_Enter``). ``x`` as it is unsharded,
    on a model axis of one, or where no gradient is asked for."""
    tp = current()
    if tp is None or tp.size == 1 or not _grad(x):
        return x
    return _Enter.apply(x, tp)


def enter_tree(p: dict) -> dict:
    """``enter`` on each tensor of a weight's dict (``{"w": ..., "b":
    ...}``): a whole weight used by this rank's own computation, whose
    gradient each rank holds only its part of."""
    return {k: enter(v) for k, v in p.items()}


def row_reduce(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum a row-parallel projection's partial products over the model
    axis (``w``: the projection's weight, as laid out)."""
    tp = current()
    if tp is None or id(w) not in tp.row_split:
        return y
    return _all_reduce(tp, y)


# ---------------------------------------------------------------------------
# sequence sharding: the residual stream split along T over the model axis


def seq_shards(T: int) -> int:
    """The parts a ``(B, T, d)`` residual stream is split into along T:
    the model axis's size where the rules split ``seq`` over ``model``
    (``activation_rules``), a tensor-parallel context is on and T divides
    the axis (JAX's rule); else 1, the stream whole."""
    from repro_torch.sharding.rules import MODEL

    rules, tp = _rules(), current()
    if rules is None or rules["seq"] is None or tp is None or tp.size == 1:
        return 1
    seq = rules["seq"] if isinstance(rules["seq"], tuple) else (rules["seq"],)
    if seq != (MODEL,):
        raise NotImplementedError(f"sequence sharding over {seq}: only the "
                                  f"model axis ({MODEL!r}) splits T")
    return tp.size if T % tp.size == 0 else 1


@contextlib.contextmanager
def split_stream(on: bool):
    """While open (and ``on``), the layers run are a block of a stream
    split along T: their output sums are reduce-scatters along T
    (``out_reduce``, ``out_sum``), a whole output is cut to this rank's
    positions (``out_part``) and a whole weight applied there is entered
    (``on_positions``). The block sets it on the thread the layers run on
    (the remat recompute's too)."""
    prev = getattr(_state, "split", False)
    _state.split = on
    try:
        yield
    finally:
        _state.split = prev


def _split() -> TensorParallel | None:
    """The context of a split-stream block, or None."""
    return current() if getattr(_state, "split", False) else None


def _seq_part(tp: TensorParallel, x: torch.Tensor) -> torch.Tensor:
    """This rank's equal part of ``x``'s dim 1 (a view)."""
    n = x.shape[1] // tp.size
    return x.narrow(1, tp.rank * n, n)


def _seq_gather(tp: TensorParallel, x: torch.Tensor) -> torch.Tensor:
    """``x``'s dim 1 whole from each rank's part: an ``all_reduce`` of a
    zeroed buffer, exact, logged as an ``all-gather`` of the whole."""
    n = x.shape[1]
    full = x.new_zeros((x.shape[0], n * tp.size, *x.shape[2:]))
    full.narrow(1, tp.rank * n, n).copy_(x)
    return _reduce(tp, full, kind="all-gather")


class _SeqGather(torch.autograd.Function):
    """The whole sequence from each rank's positions. The gathered tensor
    is held whole and gets the whole gradient on every rank (the layers'
    own ``enter`` sums what their split parts give), so the backward keeps
    the rank's positions of it."""

    @staticmethod
    def forward(ctx_, x, tp):
        ctx_.tp = tp
        return _seq_gather(tp, x)

    @staticmethod
    def backward(ctx_, g):
        return _seq_part(ctx_.tp, g), None


class _SeqScatter(torch.autograd.Function):
    """A sum over the model axis of which the rank keeps its positions (a
    reduce-scatter along T: an ``all_reduce``, gloo taking no
    ``reduce_scatter`` of CUDA tensors). Each rank's term gets the whole
    sum's gradient: the backward gathers the ranks' positions of it."""

    @staticmethod
    def forward(ctx_, y, tp):
        ctx_.tp = tp
        full = _reduce(tp, y.view_as(y) if tp.records is not None
                       else _fresh(y), kind="reduce-scatter")
        return _seq_part(tp, full).clone()

    @staticmethod
    def backward(ctx_, g):
        return _seq_gather(ctx_.tp, g.contiguous()), None


class _SeqCut(torch.autograd.Function):
    """This rank's positions of a tensor held whole on every model rank;
    the backward gathers the ranks' positions of the gradient, so the
    whole tensor gets the whole gradient on every rank."""

    @staticmethod
    def forward(ctx_, x, tp):
        ctx_.tp = tp
        return _seq_part(tp, x).clone()

    @staticmethod
    def backward(ctx_, g):
        return _seq_gather(ctx_.tp, g.contiguous()), None


def seq_gather(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, T / m, ...), this rank's positions of a split stream,
    gathered whole along T (``_SeqGather`` under autograd)."""
    tp = current()
    if _grad(x):
        return _SeqGather.apply(x, tp)
    return _seq_gather(tp, x)


def seq_cut(x: torch.Tensor) -> torch.Tensor:
    """This rank's positions of ``x`` (B, T, ...), held whole on every
    model rank (``_SeqCut`` under autograd)."""
    tp = current()
    if _grad(x):
        return _SeqCut.apply(x, tp)
    return _seq_part(tp, x).clone()


def _seq_scatter(tp: TensorParallel, y: torch.Tensor) -> torch.Tensor:
    if _grad(y):
        return _SeqScatter.apply(y, tp)
    return _seq_part(tp, _reduce(tp, y, kind="reduce-scatter")).clone()


def out_reduce(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A layer's output projection ``w``'s partial products summed
    (``row_reduce``); in a split-stream block this rank's positions of the
    sum (a reduce-scatter), or of ``y`` where ``w`` is whole."""
    tp = _split()
    if tp is None:
        return row_reduce(w, y)
    return _seq_scatter(tp, y) if id(w) in tp.row_split else seq_cut(y)


def out_sum(y: torch.Tensor) -> torch.Tensor:
    """``model_sum`` of a layer's output, or this rank's positions of it
    in a split-stream block (a reduce-scatter)."""
    tp = _split()
    return model_sum(y) if tp is None else _seq_scatter(tp, y)


def out_part(y: torch.Tensor) -> torch.Tensor:
    """A layer's whole output ``y``: this rank's positions of it in a
    split-stream block, else ``y``."""
    return y if _split() is None else seq_cut(y)


def on_positions(t: torch.Tensor) -> torch.Tensor:
    """A whole weight applied to a layer's output: ``enter`` in a
    split-stream block, where it sees only this rank's positions (its
    gradient a part), else ``t``."""
    return t if _split() is None else enter(t)


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
    return enter(x)[..., tp.rank * n:(tp.rank + 1) * n]


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
    if tp.records is not None:
        tp.records.append(("all-reduce", tp.data_size * (counts.shape[0] + 1)
                           * counts.element_size()))
        tp.n_data_collectives += 1
        return (torch.zeros_like(counts), counts * tp.data_size,
                n * tp.data_size)
    import torch.distributed as dist

    buf = counts.new_zeros((tp.data_size, counts.shape[0] + 1))
    buf[tp.data_rank, :-1] = counts
    buf[tp.data_rank, -1] = n
    dist.all_reduce(buf, group=tp.data_group)
    tp.n_data_collectives += 1
    if tp.log is not None:
        tp.log.append(("all-reduce", buf.nbytes))
    return (buf[:tp.data_rank, :-1].sum(0), buf[:, :-1].sum(0),
            int(buf[:, -1].sum()))


def _gather(tp: TensorParallel, x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * tp.data_size
    full = x.new_zeros(shape)
    full.narrow(dim, tp.data_rank * n, n).copy_(x)
    return _reduce(tp, full, data=True, kind="all-gather")


def _reduce_scatter(tp: TensorParallel, g: torch.Tensor,
                    dim: int) -> torch.Tensor:
    """This data shard's equal part on ``dim`` of ``g`` summed over the
    data axis: an ``all_reduce`` of which the rank keeps its part (gloo
    takes no ``reduce_scatter`` of CUDA tensors), logged as a
    ``reduce-scatter`` of the whole."""
    full = _reduce(tp, _fresh(g), data=True, kind="reduce-scatter")
    n = full.shape[dim] // tp.data_size
    return full.narrow(dim, tp.data_rank * n, n).clone()


def data_total(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a count, a squared norm, a few metrics) summed over the data
    axis, outside autograd: a new tensor, or ``x`` unsharded or on one
    data shard (a recorder records the sum and returns ``x``)."""
    tp = current()
    if tp is None or tp.data_size == 1:
        return x
    x = x.detach()
    return _reduce(tp, x if tp.records is not None else _fresh(x),
                   data=True)


def model_total(x: torch.Tensor) -> torch.Tensor:
    """``data_total`` over the model axis."""
    tp = current()
    if tp is None or tp.size == 1:
        return x
    x = x.detach()
    return _reduce(tp, x if tp.records is not None else _fresh(x))


def layers_params(params):
    """The params the layers run: ``params`` as they are, or on a world
    rank with a param layout (``TensorParallel.model_cut`` set) each FSDP
    leaf gathered whole over the data axis from each data shard's equal
    contiguous part: one ``all_reduce`` of a zeroed buffer into which each
    rank writes its part, exact, over the data group (gloo takes no
    ``all_gather`` of CUDA tensors). The gathered leaves are new tensors
    outside autograd, set to require grad when it is on: a train step
    takes its gradients there and reduces them itself
    (``reduce_gradients``). The split weights are recorded anew by the
    gathered tensors' identity."""
    from repro_torch.sharding.rules import tree_map_with_path

    tp = current()
    if tp is None or tp.model_cut is None:
        return params
    grad = torch.is_grad_enabled()
    ids = {k: set() for k in tp.split_paths}

    def one(path, t):
        d = tp.gather_dims.get(path)
        if d is not None:
            with torch.no_grad():
                t = _gather(tp, t.detach(), d)
            t.requires_grad_(grad)
        for k, paths in tp.split_paths.items():
            if path in paths:
                ids[k].add(id(t))
        return t

    out = tree_map_with_path(one, params)
    for k, v in ids.items():
        setattr(tp, f"{k}_split", frozenset(v))
    return out


def reduce_gradients(grads):
    """A world rank's gradients of the params its layers ran
    (``layers_params``; a tree shaped like the params), reduced over the
    data axis leaf by leaf in tree order: each FSDP leaf's
    reduce-scattered to the rank's shard, each other leaf's all-reduced
    (the data shards' rows are parts of one global batch). As they are
    without a param layout: one rank, or a plan's recorder, whose plan
    counts this traffic itself (``launch.steps.fsdp_records``)."""
    from repro_torch.sharding.rules import tree_map_with_path

    tp = current()
    if tp is None or tp.model_cut is None:
        return grads
    dims = tp.gather_dims

    def one(path, g):
        if path in dims:
            return _reduce_scatter(tp, g, dims[path])
        if tp.data_size > 1:
            return _reduce(tp, _fresh(g), data=True)
        return g

    return tree_map_with_path(one, grads)


def leaf_axes(tree) -> list:
    """Per leaf of a param-shaped tree, in tree order: (split over the data
    axis, cut over the model axis) on a world rank with a param layout;
    (False, False) without one."""
    from repro_torch.sharding.rules import tree_map_with_path

    tp = current()
    lay = tp is not None and tp.model_cut is not None
    out = []
    tree_map_with_path(lambda path, _: out.append(
        (path in tp.gather_dims, tp.model_cut[path]) if lay else
        (False, False)), tree)
    return out


def row_input(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The slice of ``x`` a row-split ``w`` multiplies: ``x`` as it is when
    it is already this rank's slice (its heads split with ``wq``), else the
    rank's contiguous part of the whole (``wq`` whole, ``wo`` split)."""
    tp = current()
    if tp is None or id(w) not in tp.row_split or x.shape[-1] == w.shape[0]:
        return x
    n = w.shape[0]
    return enter(x)[..., tp.rank * n:(tp.rank + 1) * n]


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; on a vocab-split table, this rank's rows (zero
    elsewhere) summed over the model axis. In a split-stream block this
    rank's positions of it (``out_sum``, ``out_part``)."""
    tp = current()
    if tp is None or id(table) not in tp.vocab_split:
        return out_part(table[tokens.long()])
    n = table.shape[0]
    local = tokens.long() - tp.rank * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return out_sum(rows)


def vocab_input(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The input ``x`` of a vocab-split head ``w`` (``enter``), or ``x``."""
    tp = current()
    if tp is None or id(w) not in tp.vocab_split:
        return x
    return enter(x)


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
