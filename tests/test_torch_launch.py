"""The port's launch tooling (``repro_torch.launch.{steps,train}`` and
``examples/speculative_lm_torch.py``) against the JAX package's:

- ``SHAPES``, ``MT_SHAPES``, ``SLIDING_WINDOW_LONG``, ``skip_reason`` and
  ``_dryrun_cfg`` for every arch x shape; ``input_specs`` leaf shapes and
  dtypes for every pair that is not skipped (full configs, meta tensors
  against ``ShapeDtypeStruct``s);
- ``build_step``'s in / out specs against JAX's ``PartitionSpec``s on
  (1, 1), (2, 2), (16, 16) and (2, 16, 16) meshes, every kind (LM, audio
  and VLM train and prefill, decode, verify, multi-draft, long, the MT's
  two), FSDP inference both ways; JAX's meshes repeat its host devices
  (as ``tests/test_launch.py`` builds its 16-way one), which is enough to
  build specs; a spec is normalised as ``test_torch_sharding_rules.py``
  does (JAX's scan-repeat dim dropped, padded to the leaf's rank, a
  one-axis tuple as its axis);
- each kind's ``fn`` on the CPU against JAX's at shrunk shapes (both
  packages' ``SHAPES`` / ``MT_SHAPES`` entries patched by
  ``monkeypatch.setitem``), on bridged params, fp32: logits, caches,
  train metrics, Adam's moments and the updated params within 1e-4 (the
  params where |g| > 1e-6: Adam's first step moves a param by lr times
  the sign of its gradient, and a gradient at fp32 noise has no sure
  sign);
- the outputs of ``fn`` run on meta at full ``SHAPES`` with a reduced
  config against ``jax.eval_shape(fn, *inputs)``, and ``built.outputs``;
- ``synthetic_batch`` bit for bit (dense, audio, VLM), five steps of the
  train loop against JAX's jitted loop (losses within 1e-4) with and
  without ``remat``, ``main(--device cpu)``;
- the example's greedy tokens and calls against JAX's ``greedy_decode``
  on the same bridged params and prompt, speculative == greedy, on
  SmolLM and RWKV6 reduced;
- the repairs: ``World()`` and ``synthetic_batch`` without a device
  raise the missing card's error (the world before a rank starts), and
  the job functions default to the card (the built steps run on a live
  world in ``tests/test_torch_world_steps.py`` and
  ``tests/test_torch_world_train.py``).
"""

import dataclasses
import inspect
import multiprocessing
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import greedy_decode as jax_greedy  # noqa: E402
from repro.core import transformer_handle as jax_handle  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.training.optimizer import adam_init as jax_adam  # noqa: E402
from repro.training.trainer import \
    make_lm_train_step as jax_lm_step  # noqa: E402
from repro_torch.bridge import (seq2seq_params_from_jax,  # noqa: E402
                                transformer_params_from_jax)
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import mesh_runs  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.training.optimizer import AdamState  # noqa: E402
from test_torch_sharding_rules import jax_flat, port_flat  # noqa: E402

ARCHS = [a for a in list_archs() if not a.startswith("mt-")]
TOL = dict(atol=1e-4, rtol=1e-4)
MESHES = {"1x1": (1, 1), "2x2": (2, 2), "16x16": (16, 16),
          "2x16x16": (2, 16, 16)}
_DT = {jnp.dtype(jnp.float32): torch.float32,
       jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.bool_): torch.bool}
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "speculative_lm_torch.py"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def meshes(shape):
    """(JAX mesh, port MeshShape) of ``shape``."""
    names = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                              "model")
    n = int(np.prod(shape))
    devs = np.asarray(jax.devices() * n)[:n].reshape(shape)
    return Mesh(devs, names), MeshShape(names, tuple(shape))


def port_leaves(tree) -> list:
    """A port tree's leaves in JAX's order (dict keys sorted, dataclass and
    tuple fields in order); a Python int (Adam's step) is a leaf too."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in port_leaves(tree[k])]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in port_leaves(getattr(tree, f.name))]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in port_leaves(v)]
    return [tree]


def nspec(spec, ndim: int) -> tuple:
    """A spec padded to ``ndim`` with a one-axis tuple as its axis."""
    spec = tuple(getattr(spec, "spec", spec) or ())
    spec = tuple(s[0] if isinstance(s, tuple) and len(s) == 1 else s
                 for s in spec)
    return spec + (None,) * (ndim - len(spec))


def _stacked(path) -> bool:
    return path[0] in ("blocks", "enc_blocks", "dec_blocks")


def jax_param_specs(jspecs, jparams) -> dict:
    """JAX's per-leaf specs on the port's per-layer paths (its stacked
    scan-repeat dim dropped)."""
    shapes = jax_flat(jparams)
    out = {}
    for path, spec in jax_flat(jspecs).items():
        shape = shapes[path].shape
        spec = nspec(spec, len(shape))
        if path[0] == "blocks":
            for r in range(shape[0]):
                out[("blocks", path[1], r) + path[2:]] = spec[1:]
        elif _stacked(path):
            for r in range(shape[0]):
                out[(path[0], r) + path[1:]] = spec[1:]
        else:
            out[path] = spec
    return out


def port_param_specs(params, specs) -> dict:
    return {p: nspec(s, len(_at(params, p).shape))
            for p, s in port_flat(params, specs).items()}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def assert_specs_equal(jb, tb):
    """In / out specs of a JAX and a port ``BuiltStep``: the params (and
    Adam's moments) by path, every other tree leaf by leaf."""
    jparams, tparams = jb.inputs[0], tb.inputs[0]
    train = tb.kind in ("train", "mt_train")
    for jtree, ttree, tree_in in ((jb.in_shardings, tb.in_shardings, True),
                                  (jb.out_shardings, tb.out_shardings,
                                   False)):
        if not isinstance(ttree, tuple) or not isinstance(jtree, tuple):
            jtree, ttree = (jtree,), (ttree,)    # the encoder's logits
        assert len(jtree) == len(ttree)
        for i, (js, ts) in enumerate(zip(jtree, ttree)):
            if (i == 0 and (tree_in or train)) or isinstance(ts, AdamState):
                if isinstance(ts, AdamState):
                    assert nspec(ts.step, 0) == nspec(js.step, 0)
                    pairs = ((js.mu, ts.mu), (js.nu, ts.nu))
                else:
                    pairs = ((js, ts),)
                for j, t in pairs:
                    assert port_param_specs(tparams, t) == \
                        jax_param_specs(j, jparams)
                continue
            if ts is None:
                assert js is None
                continue
            jl = jax.tree_util.tree_leaves(
                js, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
            tl = _spec_leaves(ts)
            assert len(jl) == len(tl), (i, jl, tl)
            for a, b in zip(jl, tl):
                n = max(len(a.spec), len(b))
                assert nspec(a, n) == nspec(b, n), (i, a, b)


def _spec_leaves(tree) -> list:
    """A port spec tree's specs (tuples of axis entries) in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _spec_leaves(getattr(tree, f.name))]
    if isinstance(tree, tuple) and all(
            x is None or isinstance(x, str)
            or (isinstance(x, tuple) and all(isinstance(y, str) for y in x))
            for x in tree):
        return [tree]
    return [x for v in tree for x in _spec_leaves(v)]


# ---------------------------------------------------------------------------
# constants and specs


def test_shape_tables_equal_jax():
    assert steps.SHAPES == jsteps.SHAPES
    assert steps.MT_SHAPES == jsteps.MT_SHAPES
    assert steps.SLIDING_WINDOW_LONG == jsteps.SLIDING_WINDOW_LONG


@pytest.mark.parametrize("arch", list_archs())
def test_skip_reason_and_dryrun_cfg_equal_jax(arch):
    for shape in list(steps.SHAPES) + list(steps.MT_SHAPES):
        assert steps.skip_reason(arch, shape) == \
            jsteps.skip_reason(arch, shape), shape
        if shape in steps.SHAPES:
            t, j = steps._dryrun_cfg(arch, shape), jsteps._dryrun_cfg(
                arch, shape)
            assert dataclasses.asdict(t) == dataclasses.asdict(j), shape


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_jax(arch):
    for shape in steps.SHAPES:
        if steps.skip_reason(arch, shape):
            continue
        got = port_leaves(steps.input_specs(arch, shape))
        want = jax.tree_util.tree_leaves(jsteps.input_specs(arch, shape))
        assert [(tuple(t.shape), t.dtype, t.device.type) for t in got] == \
            [(tuple(w.shape), _DT[jnp.dtype(w.dtype)], "meta")
             for w in want], shape


SPEC_CASES = [  # (arch, shape, build kwargs)
    ("smollm-135m", "train_4k", {}),
    ("smollm-135m", "prefill_32k", {}),
    ("smollm-135m", "decode_32k", {}),
    ("smollm-135m", "decode_32k", dict(verify_tokens=11)),
    ("smollm-135m", "decode_32k", dict(verify_tokens=11, multidraft=5)),
    ("smollm-135m", "long_500k", {}),
    ("hubert-xlarge", "train_4k", {}),
    ("hubert-xlarge", "prefill_32k", {}),
    ("llama-3.2-vision-11b", "train_4k", {}),
    ("llama-3.2-vision-11b", "prefill_32k", {}),
    ("jamba-v0.1-52b", "decode_32k", {}),
    ("mt-product", "mt_train", {}),
    ("mt-product", "mt_verify", {}),
]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fsdp", [True, False])
def test_build_step_specs_equal_jax(mesh, fsdp):
    jm, tm = meshes(MESHES[mesh])
    for arch, shape, kw in SPEC_CASES:
        if mesh == "2x16x16" and arch != "smollm-135m":
            continue
        jb = jsteps.build_step(arch, shape, jm, fsdp_inference=fsdp,
                               cfg_override=jax_get_config(arch,
                                                           reduced=True),
                               **kw)
        tb = steps.build_step(arch, shape, tm, fsdp_inference=fsdp,
                              cfg_override=get_config(arch, reduced=True),
                              **kw)
        assert_specs_equal(jb, tb)
        assert tb.note == jb.note


# ---------------------------------------------------------------------------
# values at shrunk shapes

SMALL = {"train_4k": dict(seq=16, batch=2, kind="train"),
         "prefill_32k": dict(seq=12, batch=2, kind="prefill"),
         "decode_32k": dict(seq=24, batch=2, kind="decode"),
         "long_500k": dict(seq=40, batch=1, kind="decode")}
SMALL_MT = {"mt_train": dict(seq=12, batch=2, kind="mt_train"),
            "mt_verify": dict(seq=16, batch=2, kind="mt_verify", verify=4)}


@pytest.fixture
def small(monkeypatch):
    for table, small_table in ((steps.SHAPES, SMALL), (jsteps.SHAPES, SMALL),
                               (steps.MT_SHAPES, SMALL_MT),
                               (jsteps.MT_SHAPES, SMALL_MT)):
        for k, v in small_table.items():
            monkeypatch.setitem(table, k, v)


def _cfgs(arch: str, window: int = 0):
    t, j = get_config(arch, reduced=True), jax_get_config(arch, reduced=True)
    if window:
        t = dataclasses.replace(t, sliding_window=window)
        j = dataclasses.replace(j, sliding_window=window)
    return t, j


def _to_jax(tree):
    """A port input tree (caches, batches) as JAX arrays and classes."""
    if isinstance(tree, torch.Tensor):   # a copy: the port writes in place
        return jnp.asarray(tree.detach().numpy().copy())
    if isinstance(tree, KVCache):
        return jattn.KVCache(k=_to_jax(tree.k), v=_to_jax(tree.v),
                             pos=_to_jax(tree.pos))
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(v) for v in tree)
    return tree


def _close(got, want, what):
    g = port_leaves(got)
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64),
                                   err_msg=f"{what} leaf {i}", **TOL)


VALUE_CASES = [  # (id, arch, shape, kwargs, window)
    ("smollm-decode", "smollm-135m", "decode_32k", {}, 0),
    ("smollm-verify", "smollm-135m", "decode_32k", dict(verify_tokens=5), 0),
    ("smollm-multidraft", "smollm-135m", "decode_32k",
     dict(verify_tokens=4, multidraft=3), 0),
    ("smollm-prefill", "smollm-135m", "prefill_32k", {}, 0),
    ("smollm-long", "smollm-135m", "long_500k", {}, 16),
    ("smollm-train", "smollm-135m", "train_4k", {}, 0),
    ("phi-verify", "phi3.5-moe-42b-a6.6b", "decode_32k",
     dict(verify_tokens=5), 0),
    ("phi-train", "phi3.5-moe-42b-a6.6b", "train_4k", {}, 0),
    ("rwkv-verify", "rwkv6-1.6b", "decode_32k", dict(verify_tokens=5), 0),
    ("rwkv-train", "rwkv6-1.6b", "train_4k", {}, 0),
    ("hubert-encode", "hubert-xlarge", "prefill_32k", {}, 0),
    ("vlm-prefill", "llama-3.2-vision-11b", "prefill_32k", {}, 0),
    ("mt-train", "mt-product", "mt_train", {}, 0),
    ("mt-verify", "mt-product", "mt_verify", {}, 0),
]


@pytest.mark.parametrize("case", VALUE_CASES, ids=[c[0] for c in VALUE_CASES])
def test_fn_matches_jax(small, case):
    _, arch, shape, kw, window = case
    tcfg, jcfg = _cfgs(arch, window)
    jm, tm = meshes((1, 1))
    jb = jsteps.build_step(arch, shape, jm, dtype=jnp.float32,
                           cfg_override=jcfg, **kw)
    tb = steps.build_step(arch, shape, tm, dtype=torch.float32,
                          cfg_override=tcfg, **kw)
    if jcfg.family == "seq2seq":
        jp = js2s.init(jax.random.PRNGKey(0), jcfg)
        tp = seq2seq_params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    else:
        jp = jtr.init(jax.random.PRNGKey(0), jcfg)
        if jcfg.family == "vlm":   # the gates init to 0 (tanh(0) hides)
            jp["blocks"] = tuple(
                dict(b, xattn_gate=jnp.full_like(b["xattn_gate"], 0.7))
                if "xattn_gate" in b else b for b in jp["blocks"])
        tp = transformer_params_from_jax(jax.tree.map(np.asarray, jp),
                                         device="cpu")
    inputs = steps.example_inputs(tb, device="cpu", seed=1, params=tp)
    if tb.kind in ("train", "mt_train"):
        jinputs = (jp, jax_adam(jp), _to_jax(inputs[2]))
    else:
        jinputs = (jp,) + tuple(_to_jax(x) for x in inputs[1:])
    want = jax.block_until_ready(jax.jit(jb.fn)(*jinputs))
    got = tb.fn(*inputs)
    if tb.kind in ("train", "mt_train"):
        for k in ("loss", "token_accuracy", "grad_norm"):
            np.testing.assert_allclose(float(got[2][k]), float(want[2][k]),
                                       err_msg=k, **TOL)
        bridge = (seq2seq_params_from_jax if tcfg.family == "seq2seq"
                  else transformer_params_from_jax)

        def leaves(tree):
            return port_leaves(bridge(jax.tree.map(np.asarray, tree),
                                      device="cpu"))

        # Adam's moments hold the gradient: m = 0.1 g, v = 0.002 g^2
        _close(port_leaves(got[1].mu), leaves(want[1].mu), "mu")
        _close(port_leaves(got[1].nu), leaves(want[1].nu), "nu")
        # Adam's first step moves a param by lr * sign(g): where |g| is at
        # the level of fp32 noise the two packages' signs may differ, so
        # the params are held where |g| > 1e-6
        for i, (a, b, m) in enumerate(zip(port_leaves(got[0]),
                                          leaves(want[0]),
                                          leaves(want[1].mu))):
            sure = np.abs(m.numpy()) > 0.1 * 1e-6
            np.testing.assert_allclose(a.detach().numpy()[sure],
                                       b.numpy()[sure],
                                       err_msg=f"params leaf {i}", **TOL)
        return
    if isinstance(want, tuple):
        _close(got[0], want[0], "logits")
        _close(got[1], want[1], "cache")
    else:
        _close(got, want, "logits")


# ---------------------------------------------------------------------------
# shapes at full size (meta), reduced configs

SHAPE_CASES = [c for c in SPEC_CASES if c[0] != "jamba-v0.1-52b"] + [
    ("rwkv6-1.6b", "decode_32k", dict(verify_tokens=11)),
    ("phi3.5-moe-42b-a6.6b", "train_4k", {})]


def _shape_dtype(x):
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    return tuple(x.shape), _DT[jnp.dtype(x.dtype)]


@pytest.mark.parametrize("case", SHAPE_CASES,
                         ids=[f"{a}-{s}-{len(k)}" for a, s, k in SHAPE_CASES])
def test_meta_outputs_equal_jax_eval_shape(case):
    arch, shape, kw = case
    tcfg, jcfg = _cfgs(arch)
    jm, tm = meshes((1, 1))
    jb = jsteps.build_step(arch, shape, jm, cfg_override=jcfg, **kw)
    tb = steps.build_step(arch, shape, tm, cfg_override=tcfg, **kw)
    want = jax.eval_shape(jb.fn, *jb.inputs)
    got = tb.fn(*tb.local_inputs)
    if tb.kind in ("train", "mt_train"):   # (params, opt, metrics)
        jshapes = {p: _shape_dtype(x)[0] for p, x in
                   jax_flat(want[0]).items()}
        n = sum(int(np.prod(s)) for s in jshapes.values())
        assert sum(t.numel() for t in port_leaves(got[0])) == n
        assert sum(t.numel() for t in port_leaves(got[1].mu)) == n
        for k in ("loss", "token_accuracy", "grad_norm"):
            assert tuple(got[2][k].shape) == tuple(want[2][k].shape) == ()
        assert got[0] is not None and tb.outputs[0] is tb.inputs[0]
        return
    g = [_shape_dtype(x) for x in port_leaves(got)]
    w = [_shape_dtype(x) for x in jax.tree_util.tree_leaves(want)]
    assert g == w
    assert [_shape_dtype(x) for x in port_leaves(tb.outputs)] == w


# ---------------------------------------------------------------------------
# the train launcher

TRAIN_ARCHS = ["smollm-135m", "hubert-xlarge", "llama-3.2-vision-11b"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_synthetic_batch_bit_for_bit(arch):
    cfg = get_config(arch, reduced=True)
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(2):   # the generator's state advances alike
        got = ttrain.synthetic_batch(cfg, a, 3, 7, device="cpu")
        want = jtrain.synthetic_batch(jax_get_config(arch, reduced=True), b,
                                      3, 7)
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].dtype == _DT[jnp.dtype(w.dtype)], k
            assert np.array_equal(got[k].numpy(), w), k


@pytest.mark.parametrize("remat", [False, True])
def test_train_loop_matches_jax(remat):
    arch, steps_n, B, S = "smollm-135m", 5, 2, 16
    tcfg, jcfg = _cfgs(arch)
    jp = jtr.init(jax.random.PRNGKey(0), jcfg)
    tp = transformer_params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    out = ttrain.train_loop(tp, tcfg, steps=steps_n, batch=B, seq=S,
                            remat=remat, device="cpu")
    step = jax.jit(jax_lm_step(jcfg, lr=3e-4, remat=remat))
    opt, rng, want = jax_adam(jp), np.random.default_rng(0), []
    for _ in range(steps_n):
        jp, opt, m = step(jp, opt, jtrain.synthetic_batch(jcfg, rng, B, S))
        want.append(float(m["loss"]))
    np.testing.assert_allclose([h["loss"] for h in out["history"]], want,
                               **TOL)


def test_train_main_on_the_cpu(capsys):
    out = ttrain.main(["--arch", "smollm-135m", "--reduced", "--steps", "2",
                       "--batch", "2", "--seq", "8", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "arch=smollm-135m-reduced layers=2" in text
    assert "step    0 loss=" in text and "done: 2 steps in" in text
    assert "steps/s:" in text and len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])


# ---------------------------------------------------------------------------
# the example


@pytest.fixture(scope="module")
def example():
    return runpy.run_path(str(EXAMPLE))


@pytest.mark.parametrize("arch", ["smollm-135m", "rwkv6-1.6b"])
def test_example_matches_jax_greedy(example, arch):
    tcfg, jcfg = _cfgs(arch)
    jp = jtr.init(jax.random.PRNGKey(0), jcfg)
    tp = transformer_params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    B, P = example["B"], example["P"]
    prompt = np.random.default_rng(5).integers(4, tcfg.vocab_size,
                                               (B, P)).astype(np.int32)
    out = example["run"](arch, device="cpu", params=tp, prompt=prompt)
    c = jtr.init_cache(jcfg, B, max_len=P + example["MAX_NEW"]
                       + example["DL"] + 4)
    _, c = jtr.prefill(jp, jcfg, c, jnp.asarray(prompt[:, :P - 1]))
    g = jax_greedy(jax_handle(jp, jcfg), c, jnp.asarray(prompt[:, P - 1]),
                   jnp.full((B,), P - 1, jnp.int32),
                   max_new=example["MAX_NEW"], eos_id=2)
    assert np.array_equal(out["greedy"].tokens.numpy(), np.asarray(g.tokens))
    assert int(out["greedy"].n_calls) == int(g.n_calls)
    assert out["identical"]
    assert np.array_equal(out["speculative"].tokens.numpy(),
                          np.asarray(g.tokens))


def test_example_main_prints_identity(example, capsys):
    example["main"](["smollm-135m", "--device", "cpu"])
    assert "outputs identical : True" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the repairs and the refusals


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_world_defaults_to_the_card():
    from repro_torch.launch.world import World

    before = multiprocessing.active_children()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        World(2)
    assert multiprocessing.active_children() == before


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_synthetic_batch_defaults_to_the_card():
    cfg = get_config("smollm-135m", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.synthetic_batch(cfg, np.random.default_rng(0), 2, 4)


@pytest.mark.parametrize("job", ["serve", "probe", "layer", "refusals",
                                 "front_door", "late_stream", "built_step"])
def test_job_functions_default_to_the_card(job):
    sig = inspect.signature(getattr(mesh_runs, job))
    assert sig.parameters["on_card"].default is True


def test_port_launch_modules_import_no_jax():
    src = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
        "launch"
    for name in ("hlo_analysis", "steps", "dryrun", "train"):
        text = (src / f"{name}.py").read_text()
        assert "import jax" not in text and "from repro." not in text
    assert "repro_torch.launch.steps" in sys.modules
