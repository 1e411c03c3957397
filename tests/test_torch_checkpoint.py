"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``), on the random tiny MT carried across with
``repro_torch.bridge``.

- the file: byte for byte the one ``repro.checkpoint.save_checkpoint``
  writes for the same weights, step and Adam state (params alone; params
  with the Adam state after a few port train steps; ``step`` 17 as in
  ``tests/test_training.py``);
- both ways: JAX's ``load_checkpoint`` reads the port's file and the port
  reads JAX's, bitwise;
- the codec (``repro_torch.checkpoint._msgpack``) against the installed
  ``msgpack`` on random trees of its subset, every length class included;
- the leaf-count and shape errors.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as jax_load  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.configs.mt import tiny_config as jax_tiny_config  # noqa: E402
from repro.data import SyntheticReactionDataset  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro.training.optimizer import AdamState as JaxAdamState  # noqa: E402
from repro.training.optimizer import adam_init as jax_adam_init  # noqa: E402
from repro_torch.bridge import (seq2seq_params_from_jax,  # noqa: E402
                                seq2seq_params_to_jax)
from repro_torch.checkpoint import (load_checkpoint, load_pytree,  # noqa: E402
                                    save_checkpoint, save_pytree)
from repro_torch.checkpoint._msgpack import packb, unpackb  # noqa: E402
from repro_torch.configs.mt import tiny_config  # noqa: E402
from repro_torch.data import batched_dataset  # noqa: E402
from repro_torch.data.tokenizer import SmilesTokenizer  # noqa: E402
from repro_torch.training import (Trainer,  # noqa: E402
                                  make_seq2seq_train_step)
from repro_torch.training.optimizer import (adam_init,  # noqa: E402
                                            tree_leaves, tree_unflatten)


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
    """The random tiny MT in both packages and a port trainer that took a
    few steps (its Adam state is not zero)."""
    ds = SyntheticReactionDataset(16, seed=0)
    V = ds.tokenizer.vocab_size
    cfg_j = jax_tiny_config(V, depth=2, d_model=64, max_len=192)
    pj = js2s.init(jax.random.PRNGKey(0), cfg_j)
    cfg_t = tiny_config(V, depth=2, d_model=64, max_len=192)
    pt = seq2seq_params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    tok = SmilesTokenizer.from_dict(ds.tokenizer.to_dict())
    trainer = Trainer(cfg_t, seq2seq_params_from_jax(
        jax.tree.map(np.asarray, pj), device="cpu"),
        make_seq2seq_train_step(cfg_t, lr=1e-3, label_smoothing=0.0),
        device="cpu")
    batches = list(batched_dataset(tok, ds.pairs(), 4, 48, 48))
    trainer.fit(batches[:3], verbose=False)
    return dict(cfg_j=cfg_j, pj=pj, pt=pt, trainer=trainer, batches=batches)


def _jax_adam(state) -> JaxAdamState:
    """The port's AdamState as the JAX package holds it."""
    def tree(t):
        return jax.tree.map(jnp.asarray, seq2seq_params_to_jax(t))
    return JaxAdamState(step=jnp.asarray(state.step, jnp.int32),
                        mu=tree(state.mu), nu=tree(state.nu))


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _assert_leaves_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# the file, byte for byte


@pytest.mark.parametrize("with_opt", [False, True])
@pytest.mark.parametrize("step", [0, 17])
def test_file_is_byte_identical_to_jax(toy, tmp_path, with_opt, step):
    """The same weights (and Adam state after three port train steps) and
    step give the same bytes from both packages."""
    tr = toy["trainer"]
    params_t = tr.params
    params_j = jax.tree.map(jnp.asarray, seq2seq_params_to_jax(params_t))
    kw_t, kw_j = {}, {}
    if with_opt:
        assert tr.opt_state.step == 3
        kw_t["opt_state"] = tr.opt_state
        kw_j["opt_state"] = _jax_adam(tr.opt_state)
    save_checkpoint(str(tmp_path / "port.msgpack"), params=params_t,
                    step=step, **kw_t)
    jax_save(str(tmp_path / "jax.msgpack"), params=params_j, step=step,
             **kw_j)
    a, b = _read(tmp_path / "port.msgpack"), _read(tmp_path / "jax.msgpack")
    assert len(a) == len(b) and a == b
    assert [p.name for p in tmp_path.iterdir()
            if p.suffix == ".tmp"] == []   # the temp file went to its name


def test_jax_reads_the_ports_file_bitwise(toy, tmp_path):
    tr = toy["trainer"]
    path = str(tmp_path / "ckpt.msgpack")
    save_checkpoint(path, params=tr.params, opt_state=tr.opt_state, step=17)
    pj = toy["pj"]
    got = jax_load(path, params_like=pj, opt_like=jax_adam_init(pj))
    assert int(got["step"]) == 17
    assert int(got["opt"].step) == tr.opt_state.step
    want = seq2seq_params_to_jax(tr.params)
    for x, y in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got["params"])):
        np.testing.assert_array_equal(x, np.asarray(y))
    for part in ("mu", "nu"):
        want = seq2seq_params_to_jax(getattr(tr.opt_state, part))
        for x, y in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(getattr(got["opt"], part))):
            np.testing.assert_array_equal(x, np.asarray(y))


def test_port_reads_jaxs_file_bitwise(toy, tmp_path):
    tr = toy["trainer"]
    path = str(tmp_path / "ckpt.msgpack")
    jopt = _jax_adam(tr.opt_state)
    jparams = jax.tree.map(jnp.asarray, seq2seq_params_to_jax(tr.params))
    jax_save(path, params=jparams, opt_state=jopt, step=17)
    fresh = toy["pt"]
    got = load_checkpoint(path, params_like=fresh, opt_like=adam_init(fresh),
                          device="cpu")
    assert got["step"] == 17
    assert isinstance(got["opt"].step, int) and got["opt"].step == 3
    _assert_leaves_equal(got["params"], tr.params)
    _assert_leaves_equal(got["opt"].mu, tr.opt_state.mu)
    _assert_leaves_equal(got["opt"].nu, tr.opt_state.nu)
    # the structure is the port's, in params_like's key order (the port's
    # leaf walks pair params and moments by insertion order)
    assert isinstance(got["params"]["enc_blocks"], list)
    assert list(got["params"]) == list(fresh)
    assert list(got["opt"].mu["enc_blocks"][0]) == \
        list(fresh["enc_blocks"][0])
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in tree_leaves(got["params"]))
    # a loaded Adam state keeps training (its step is a Python int again),
    # and takes the step the saved trainer takes next
    tr2 = Trainer(tr.cfg, got["params"], make_seq2seq_train_step(
        tr.cfg, lr=1e-3, label_smoothing=0.0), device="cpu")
    tr2.opt_state = got["opt"]
    tr2.fit(toy["batches"][3:4], verbose=False)
    assert tr2.opt_state.step == 4
    tr3 = Trainer(tr.cfg, tr.params, make_seq2seq_train_step(
        tr.cfg, lr=1e-3, label_smoothing=0.0), device="cpu")
    tr3.opt_state = tr.opt_state._replace(
        mu=tree_unflatten(tr.opt_state.mu,
                          [t.clone() for t in tree_leaves(tr.opt_state.mu)]),
        nu=tree_unflatten(tr.opt_state.nu,
                          [t.clone() for t in tree_leaves(tr.opt_state.nu)]))
    tr3.fit(toy["batches"][3:4], verbose=False)
    _assert_leaves_equal(tr2.params, tr3.params)


def test_port_round_trip_with_extra(toy, tmp_path):
    """``extra`` rides along (sorted first at the top level, as in JAX)."""
    path = str(tmp_path / "ckpt.msgpack")
    extra = {"seed": np.int32(5), "loss": np.float32(0.25)}
    save_checkpoint(path, params=toy["pt"], step=3, extra=extra)
    jax_path = str(tmp_path / "jax.msgpack")
    jax_save(jax_path, params=toy["pj"], step=3, extra=extra)
    assert _read(path) == _read(jax_path)
    got = load_checkpoint(path, params_like=toy["pt"], extra_like=extra,
                          device="cpu")
    assert int(got["extra"]["seed"]) == 5
    assert float(got["extra"]["loss"]) == 0.25
    _assert_leaves_equal(got["params"], toy["pt"])


def test_pytree_round_trip_matches_jax_order(tmp_path):
    """``save_pytree`` flattens as ``jax.tree_util`` does: dict keys
    sorted, tuples and lists in order, ``None`` no leaf."""
    rng = np.random.default_rng(0)
    tree = {"b": [rng.standard_normal((2, 3)).astype(np.float32),
                  (np.arange(4, dtype=np.int32), None)],
            "a": {"z": np.asarray(True), "y": np.int64(-3)}}
    save_pytree(str(tmp_path / "port.msgpack"), tree)
    leaves = jax.tree_util.tree_leaves(tree)
    payload = msgpack.unpackb(_read(tmp_path / "port.msgpack"), raw=False)
    assert [d["dtype"] for d in payload["leaves"]] == [
        str(np.asarray(x).dtype) for x in leaves]
    got = load_pytree(str(tmp_path / "port.msgpack"), tree, device="cpu")
    assert got["b"][1][1] is None and list(got) == ["b", "a"]
    for x, y in zip(leaves, jax.tree_util.tree_leaves(
            jax.tree.map(lambda t: t.numpy(), got,
                         is_leaf=lambda t: isinstance(t, torch.Tensor)))):
        np.testing.assert_array_equal(np.asarray(x), y)


# ---------------------------------------------------------------------------
# the codec against the msgpack package


_INTS = (0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
         2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
         -2 ** 31 - 1, -2 ** 63)


def _pick(rng, options):
    return options[int(rng.integers(len(options)))]


def _random_tree(rng, depth=0):
    """A random tree of the codec's subset whose lengths straddle every
    header boundary."""
    kind = int(rng.integers(0, 7 if depth < 3 else 5))
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        return _pick(rng, _INTS + (int(rng.integers(-2 ** 62, 2 ** 62)),))
    if kind == 3:
        n = _pick(rng, (0, 5, 31, 32, 255, 256, 65535, 70000))
        return ("abcé✓C=O[]()" * (n // 12 + 1))[:n]
    if kind == 4:
        return rng.bytes(_pick(rng, (0, 3, 255, 256, 65535, 65536, 70000)))
    n = _pick(rng, (0, 1, 15, 16, 40))
    if kind == 5:
        return [_random_tree(rng, depth + 1) for _ in range(n)]
    return {f"k{i}": _random_tree(rng, depth + 1) for i in range(n)}


@pytest.mark.parametrize("seed", range(6))
def test_codec_matches_msgpack_on_random_trees(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        tree = _random_tree(rng)
        want = msgpack.packb(tree, use_bin_type=True)
        assert packb(tree) == want
        assert unpackb(want) == msgpack.unpackb(want, raw=False)


def test_codec_covers_every_length_class():
    """fixarray/array16, fixmap/map16, fixstr/str8/str16/str32 and
    bin8/bin16/bin32: a list of more than 15 leaves, a map past 15 keys, a
    bin leaf over 64 KiB, a str past 64 KiB."""
    cases = [list(range(15)), list(range(16)), list(range(70000)),
             {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
             "x" * 31, "x" * 32, "x" * 256, "x" * 70000,
             b"\0" * 255, b"\1" * 256, b"\2" * 65536 + b"\3", True, False,
             None]
    for obj in cases:
        want = msgpack.packb(obj, use_bin_type=True)
        assert packb(obj) == want, type(obj)
        assert unpackb(want) == obj
    heads = {packb(list(range(16)))[0], packb(b"\2" * 65537)[0],
             packb("x" * 70000)[0], packb({str(i): i for i in range(16)})[0]}
    assert heads == {0xDC, 0xC6, 0xDB, 0xDE}


def test_codec_refuses_what_it_does_not_carry():
    with pytest.raises(TypeError):
        packb(1.5)
    with pytest.raises(ValueError):
        unpackb(msgpack.packb(1.5))
    with pytest.raises(ValueError):
        unpackb(packb([1, 2]) + b"\0")


# ---------------------------------------------------------------------------
# errors


def test_leaf_count_and_shape_errors(toy, tmp_path):
    path = str(tmp_path / "ckpt.msgpack")
    save_checkpoint(path, params=toy["pt"], step=1)
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(path, params_like=toy["pt"],
                        opt_like=adam_init(toy["pt"]), device="cpu")
    bad = dict(toy["pt"], lm_head={"w_vocab": torch.zeros(3, 5)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(path, params_like=bad, device="cpu")
    # the JAX package raises the same two errors on the port's file
    with pytest.raises(ValueError, match="leaves"):
        jax_load(path, params_like=toy["pj"],
                 opt_like=jax_adam_init(toy["pj"]))


def test_unstorable_leaf_raises_and_writes_nothing(tmp_path):
    """A leaf the layout cannot store (an object array) raises and leaves
    no file and no temp file."""
    path = tmp_path / "ckpt.msgpack"
    with pytest.raises(TypeError):
        save_pytree(str(path), {"w": object()})
    assert not os.listdir(tmp_path)
