"""Sequence sharding: the decoder-only residual stream split along T over
the model axis, under ``sharding.ctx.activation_rules(mesh, batch=
("data",), seq=("model",))`` (the JAX package's switch), wherever the
model axis divides T (its rule).

On a live 4-rank CPU world (``launch.world.World``, gloo), each built
``train_4k`` and ``prefill_32k`` step run through ``mesh_runs.built_step(
seq_shard=True)`` is held, on every rank, to the one-rank step on the same
seed (metrics, every gradient leaf, params and Adam's moments within 1e-4,
each gradient leaf within ``GRAD_REL``; logits and cache within 1e-4), and
its live collectives to the plan (the same step on a ``MeshShape``, run on
meta under the same rules), kind by kind and byte for byte, with the
model-axis gathers and reduce-scatters of the whole ``(B_local, T, d)``
stream among them:

- SmolLM on ``(2, 2)`` and ``(1, 4)``, its 9 heads whole beside a split
  FFN; Phi-3.5-MoE, Llama-4, RWKV6, Jamba, the VLM and HuBERT on ``(2,
  2)``; Qwen3 and RWKV6 on ``(1, 4)``, where Qwen3's kv heads and RWKV6's
  2 heads stay whole;
- a verify pass of 4 fed tokens on ``(2, 2)`` (SmolLM, RWKV6, Jamba, the
  VLM): any stream whose T divides the axis splits, the decode path's
  recurrent checkpoints and memory K/V included;
- the ranks' SmolLM params put together equal JAX's train step, jitted on
  a ``(2, 2)`` mesh of the forced host devices inside JAX's own rules with
  ``seq=("model",)``; the ranks' prefill logits equal JAX's jitted prefill
  under the same rules.

On a planned mesh: the kinds whose T the model axis does not divide
(decode, verify 11, multi-draft 51, long_500k, the MT's) and a train step
at an odd T record the same collectives under the rules as without; a
remat'd seq-split forward whose backward runs on a fresh thread (autograd's
own thread on the card, where no context is set) gives the same gradients
and collectives as on its own thread. The dry run: ``run_one(seq_shard=
True)`` on the production mesh keeps JAX's argument bytes and lowers its
``temp_bytes`` below the same run's without the split; the CLI's
``--seq-shard`` writes a record with ``seq_shard: true``.
"""

import collections
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.sharding import ctx as jctx  # noqa: E402
from repro.training.optimizer import adam_init as jax_adam  # noqa: E402
from repro_torch.bridge import transformer_params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.launch.mesh_runs import (GRAD_REL, STEP_TOL,  # noqa: E402
                                          TINY_GRAD)
from repro_torch.launch.shardings import lay_out_params  # noqa: E402
from repro_torch.launch.world import World  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.sharding import ctx  # noqa: E402
from repro_torch.training.optimizer import tree_leaves  # noqa: E402

from test_torch_dryrun import _jax_argument_bytes  # noqa: E402
from test_torch_world_train import EXEMPT_CAP, _put_together  # noqa: E402

TOL = dict(atol=STEP_TOL, rtol=STEP_TOL)
SMALL = {"train_4k": dict(seq=16, batch=4, kind="train"),
         "prefill_32k": dict(seq=12, batch=2, kind="prefill"),
         "decode_32k": dict(seq=24, batch=4, kind="decode")}
VERIFY_T = 4    # a verify pass whose T the model axis divides: it splits
MODEL = ("model",)

FAMILIES = [  # (id, arch, mesh)
    ("phi", "phi3.5-moe-42b-a6.6b", (2, 2)),
    ("llama4", "llama4-maverick-400b-a17b", (2, 2)),
    ("rwkv6", "rwkv6-1.6b", (2, 2)),
    ("jamba", "jamba-v0.1-52b", (2, 2)),
    ("vlm", "llama-3.2-vision-11b", (2, 2)),
    ("hubert", "hubert-xlarge", (2, 2)),
    ("qwen3-kv-whole", "qwen3-8b", (1, 4)),
    ("rwkv6-heads-whole", "rwkv6-1.6b", (1, 4)),
]


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


@pytest.fixture
def small(monkeypatch):
    for table in (steps.SHAPES, jsteps.SHAPES):
        for k, v in SMALL.items():
            monkeypatch.setitem(table, k, v)


def run_step(world, arch, shape, mesh, **extra) -> list:
    return world.run("repro_torch.launch.mesh_runs:built_step", arch=arch,
                     shape=shape, mesh=mesh, seed=1,
                     shape_override=SMALL[shape], seq_shard=True,
                     on_card=False, **extra)


def check_ranks(got: list, arch: str, shape: str, mesh) -> None:
    """Every rank within the one-rank step's tolerances, its live
    collectives == the plan and the stream's gathers and reduce-scatters
    along T among them."""
    data, model = mesh
    cfg = get_config(arch, reduced=True)
    B = SMALL[shape]["batch"]
    T = VERIFY_T if shape == "decode_32k" else SMALL[shape]["seq"]
    stream = B // data * T * cfg.d_model * 4       # (B_local, T, d) fp32
    assert sorted((r["data_rank"], r["model_rank"]) for r in got) == [
        (d, m) for d in range(data) for m in range(model)]
    for r in got:
        assert r["close"], (r["rank"], r["errors"], r["grad_rel"])
        assert r["grad_rel"] <= GRAD_REL, r["grad_rel"]
        assert f"seq_shard=T/{model}" in r["note"], r["note"]
        live = collections.Counter(map(tuple, r["collectives"]))
        assert live == collections.Counter(map(tuple, r["plan"])), r["rank"]
        assert r["collectives"] == got[0]["collectives"]
        assert live[("all-gather", stream)] > 0, live
        assert live[("reduce-scatter", stream)] > 0, live
        assert not any(r["launches"].values())   # the CPU: plain versions
        for k, v in r.get("metrics", {}).items():
            np.testing.assert_allclose(v, got[0]["metrics"][k], err_msg=k,
                                       **TOL)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_smollm_train_step_splits_the_stream(world, mesh):
    check_ranks(run_step(world, "smollm-135m", "train_4k", mesh),
                "smollm-135m", "train_4k", mesh)


@pytest.mark.parametrize("case", FAMILIES, ids=[c[0] for c in FAMILIES])
def test_every_family_trains_with_the_stream_split(world, case):
    _, arch, mesh = case
    check_ranks(run_step(world, arch, "train_4k", mesh), arch, "train_4k",
                mesh)


@pytest.mark.parametrize("arch", ["smollm-135m", "rwkv6-1.6b",
                                  "jamba-v0.1-52b", "llama-3.2-vision-11b"])
def test_a_verify_pass_whose_t_divides_the_axis_splits(world, arch):
    """JAX's rule splits any stream whose T divides the model axis: a
    verify pass of 4 fed tokens on (2, 2), its recurrent checkpoints and
    memory K/V read from the gathered sequence."""
    check_ranks(run_step(world, arch, "decode_32k", (2, 2),
                         kw=dict(verify_tokens=VERIFY_T)),
                arch, "decode_32k", (2, 2))


def _jax_mesh(shape) -> Mesh:
    return Mesh(np.asarray(jax.devices()[:4]).reshape(shape),
                ("data", "model"))


def _jax_params(arch: str, tmp_path):
    """JAX's init of ``arch`` reduced, and the path of its port tree."""
    jp = jtr.init(jax.random.PRNGKey(0), jax_get_config(arch, reduced=True))
    tp = transformer_params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")
    path = tmp_path / "params.pt"
    torch.save(tp, path)
    return jp, tp, path


def _one_rank(arch: str, shape: str):
    return steps.build_step(arch, shape, MeshShape(("data", "model"),
                                                   (1, 1)),
                            dtype=torch.float32,
                            cfg_override=get_config(arch, reduced=True))


def _jax_step(arch: str, shape: str, mesh: Mesh, *inputs):
    """JAX's built step, jitted with its shardings and traced inside its
    rules with the sequence split over ``model``."""
    jb = jsteps.build_step(arch, shape, mesh, dtype=jnp.float32,
                           cfg_override=jax_get_config(arch, reduced=True))
    with jctx.activation_rules(mesh, batch=("data",), seq=MODEL):
        step = jax.jit(jb.fn, in_shardings=jb.in_shardings,
                       out_shardings=jb.out_shardings)
        return jax.block_until_ready(step(*inputs))


def test_ranks_params_put_together_equal_jax_seq_sharded_step(
        world, small, tmp_path):
    arch = "smollm-135m"
    jp, tp, path = _jax_params(arch, tmp_path)
    batch = steps.example_inputs(_one_rank(arch, "train_4k"), device="cpu",
                                 seed=1, params=tp)[2]
    jnew, jopt, jmet = _jax_step(arch, "train_4k", _jax_mesh((2, 2)), jp,
                                 jax_adam(jp), {k: jnp.asarray(v.numpy())
                                                for k, v in batch.items()})

    def leaves(tree):
        return [t.numpy() for t in tree_leaves(transformer_params_from_jax(
            jax.tree.map(np.asarray, tree), device="cpu"))]

    want, want_mu = leaves(jnew), leaves(jopt.mu)
    got = run_step(world, arch, "train_4k", (2, 2), arrays=True,
                   params=str(path))
    check_ranks(got, arch, "train_4k", (2, 2))
    for r in got:
        for k in ("loss", "token_accuracy", "grad_norm"):
            np.testing.assert_allclose(r["metrics"][k], float(jmet[k]),
                                       err_msg=k, **TOL)
    new = _put_together(got, "params", want)
    mu = _put_together(got, "mu", want_mu)
    exempt = 0
    for i, (a, b, ma, mb) in enumerate(zip(new, want, mu, want_mu)):
        # as tests/test_torch_world_train.py holds the tensor-parallel step:
        # exempt where the gradients (0.1 g in the first moments) differ in
        # sign, or both lie below 1e-7 and differ by more than 2x
        loose = (np.sign(ma) != np.sign(mb)) | (
            (np.maximum(np.abs(ma), np.abs(mb)) < 0.1 * TINY_GRAD)
            & (np.abs(ma - mb) > np.minimum(np.abs(ma), np.abs(mb))))
        exempt += int(loose.sum())
        np.testing.assert_allclose(a[~loose], b[~loose],
                                   err_msg=f"params leaf {i}", **TOL)
        np.testing.assert_allclose(ma, mb, err_msg=f"mu leaf {i}", **TOL)
    assert exempt <= EXEMPT_CAP[arch], exempt


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_prefill_splits_the_stream_and_equals_jax(world, small, tmp_path,
                                                  mesh):
    arch = "smollm-135m"
    jp, tp, path = _jax_params(arch, tmp_path)
    tokens = steps.example_inputs(_one_rank(arch, "prefill_32k"),
                                  device="cpu", seed=1, params=tp)[1]
    want = np.asarray(_jax_step(arch, "prefill_32k", _jax_mesh(mesh), jp,
                                jnp.asarray(tokens.numpy()))[0])
    got = run_step(world, arch, "prefill_32k", mesh, arrays=True,
                   params=str(path))
    check_ranks(got, arch, "prefill_32k", mesh)
    full = np.full(want.shape, np.nan, np.float32)
    for r in got:
        part = r["arrays"][0][0]                  # the rank's rows' logits
        rows, d = part.shape[0], r["data_rank"]
        full[d * rows:(d + 1) * rows] = part
    np.testing.assert_allclose(full, want, **TOL)


# ---------------------------------------------------------------------------
# a planned mesh: what the split leaves alone, autograd's thread


UNSPLIT = [  # (id, arch, shape, kwargs, shape entry)
    ("decode", "smollm-135m", "decode_32k", {},
     dict(seq=24, batch=4, kind="decode")),
    ("verify-11", "smollm-135m", "decode_32k", dict(verify_tokens=11),
     dict(seq=24, batch=4, kind="decode")),
    ("multidraft-5", "smollm-135m", "decode_32k",
     dict(verify_tokens=11, multidraft=5),
     dict(seq=64, batch=4, kind="decode")),
    ("long", "rwkv6-1.6b", "long_500k", {},
     dict(seq=40, batch=1, kind="decode")),
    ("mt_train", "mt-product", "mt_train", {},
     dict(seq=12, batch=4, kind="mt_train")),
    ("mt_verify", "mt-product", "mt_verify", {},
     dict(seq=16, batch=4, kind="mt_verify", verify=4)),
    ("train-odd-T", "smollm-135m", "train_4k", {},
     dict(seq=15, batch=4, kind="train")),
]


def _plan(arch, shape, mesh, kw, seq):
    """(note, the recorder's records, the FSDP records) of the step built
    and run on meta under the rules, ``seq`` their sequence axes."""
    with ctx.activation_rules(mesh, batch=("data",), seq=seq):
        b = steps.build_step(arch, shape, mesh, dtype=torch.float32,
                             cfg_override=get_config(arch, reduced=True),
                             **kw)
        b.fn(*b.local_inputs)
    return b.note, list(b.tp.records), list(b.fsdp_records)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("case", UNSPLIT, ids=[c[0] for c in UNSPLIT])
def test_kinds_the_split_leaves_alone_keep_their_plan(monkeypatch, case,
                                                      mesh):
    _, arch, shape, kw, entry = case
    table = steps.MT_SHAPES if shape in steps.MT_SHAPES else steps.SHAPES
    monkeypatch.setitem(table, shape, entry)
    m = MeshShape(("data", "model"), mesh)
    plain = _plan(arch, shape, m, kw, None)
    split = _plan(arch, shape, m, kw, MODEL)
    assert split == plain
    assert "seq_shard" not in split[0]
    assert plain[1], plain       # the model axis sums something


def test_the_stream_splits_only_where_the_model_axis_divides_t():
    mesh = MeshShape(("data", "model"), (1, 4))
    tp = ctx.recording_tensor_parallel(mesh)
    assert ctx.seq_shards(16) == 1            # no rules
    with ctx.activation_rules(mesh, seq=MODEL):
        assert ctx.seq_shards(16) == 1        # no tensor-parallel context
        with ctx.tensor_parallel(tp):
            assert [ctx.seq_shards(t) for t in (16, 15, 1, 11, 51)] == [
                4, 1, 1, 1, 1]
        with ctx.activation_rules(mesh, seq=("data",)), \
                ctx.tensor_parallel(tp):
            with pytest.raises(NotImplementedError, match="model axis"):
                ctx.seq_shards(16)
    with ctx.activation_rules(mesh, seq=None), ctx.tensor_parallel(tp):
        assert ctx.seq_shards(16) == 1


def _remat_grads(params, cfg, tokens, mesh, *, thread: bool):
    """Gradients of a remat'd forward on a planned rank of ``mesh`` under
    the split rules, and the collectives its backward recorded; the
    backward called on a fresh thread (``thread``), where neither the
    rules nor the context are set."""
    tp = ctx.recording_tensor_parallel(mesh)
    local = lay_out_params(params, cfg, mesh, tp, "cpu")
    leaves = tree_leaves(local)
    for t in leaves:
        t.requires_grad_(True)
    with ctx.activation_rules(mesh, batch=("data",), seq=MODEL), \
            ctx.tensor_parallel(tp):
        logits, _ = tr.apply(local, cfg, tokens, remat=True)
        loss = logits.float().square().mean()
    n_fwd = len(tp.records)
    out = {}

    def backward():
        out["grads"] = torch.autograd.grad(loss, leaves)

    if thread:
        t = threading.Thread(target=backward)
        t.start()
        t.join()
    else:
        backward()
    return out["grads"], tp.records[:n_fwd], tp.records[n_fwd:]


def test_remat_recompute_keeps_the_split_on_a_fresh_thread():
    cfg = get_config("smollm-135m", reduced=True)
    params = tr.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.randint(4, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    mesh = MeshShape(("data", "model"), (1, 2))
    same = _remat_grads(params, cfg, tokens, mesh, thread=False)
    fresh = _remat_grads(params, cfg, tokens, mesh, thread=True)
    for a, b in zip(same[0], fresh[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert same[1:] == fresh[1:]
    stream = 2 * 8 * cfg.d_model * 4
    # the recompute gathers and reduce-scatters the stream again
    for records in (same[1], same[2]):
        kinds = collections.Counter(records)
        assert kinds[("all-gather", stream)] > 0, kinds
        assert kinds[("reduce-scatter", stream)] > 0, kinds


# ---------------------------------------------------------------------------
# the dry run on the production mesh


DRY = [("smollm-135m", "train_4k"), ("qwen3-8b", "train_4k"),
       ("rwkv6-1.6b", "prefill_32k")]


@pytest.mark.parametrize("case", DRY, ids=[f"{a}-{s}" for a, s in DRY])
def test_run_one_seq_shard_lowers_temp_bytes(case):
    arch, shape = case
    split = dryrun.run_one(arch, shape, multi_pod=False, seq_shard=True,
                           verbose=False)
    plain = dryrun.run_one(arch, shape, multi_pod=False, verbose=False)
    for rec in (split, plain):
        assert rec["status"] == "ok", rec.get("traceback")
    assert split["seq_shard"] and not plain["seq_shard"]
    assert "seq_shard=T/16" in split["note"]
    nbytes, total, expert = _jax_argument_bytes(arch, shape)
    if shape == "train_4k":   # JAX's Adam step is an int32 on the device
        nbytes -= 4
    assert split["memory"]["argument_bytes"] == nbytes
    assert split["params_total"] == total
    assert split["memory"]["temp_bytes"] < plain["memory"]["temp_bytes"]
    # the split moves the stream's gathers and reduce-scatters: the
    # collective bytes differ, the flops do not
    r, p = split["roofline"], plain["roofline"]
    assert r["flops_per_device"] == pytest.approx(p["flops_per_device"],
                                                  rel=1e-3)
    assert r["collective_bytes_per_device"] != \
        p["collective_bytes_per_device"]


def test_cli_seq_shard_writes_the_record(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k",
                 "--seq-shard", "--out", str(out)])
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["status"] == "ok" and rec["seq_shard"] is True
    assert "seq_shard=T/16" in rec["note"]
    assert "× seq_shard] ok" in capsys.readouterr().out


def test_decode_dry_run_is_the_same_under_the_split():
    """T 1 does not divide the model axis: the same plan, terms and
    memory as without the split."""
    split, plain = (dryrun.run_one("smollm-135m", "decode_32k",
                                   multi_pod=False, seq_shard=s,
                                   verbose=False) for s in (True, False))
    assert split["status"] == plain["status"] == "ok"
    assert split["seq_shard"] is True and split["note"] == plain["note"]
    assert split["roofline"] == plain["roofline"]
    assert split["memory"] == plain["memory"]
