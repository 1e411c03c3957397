"""A built serving step on a live world of ranks: ``launch.steps.build_step``
on a ``DeviceMesh`` over a 4-rank CPU world (``launch.world.World``, gloo, a
file store in a temp dir) against the one-rank step on the same seed.

Every serving kind (prefill for the LM, the VLM and the audio encoder;
decode, verify and multi-draft; long_500k's windowed decode; the MT's
mt_verify) on the reduced configs at ``tests/test_torch_launch.py``'s small
shapes, on a ``(2, 2)`` and a ``(1, 4)`` mesh, with FSDP params and
without, runs through ``mesh_runs.built_step`` on every rank, which:

- draws the inputs with ``steps.example_inputs`` (the global inputs of the
  seed, cut to the rank's part) and runs the world step once;
- runs the one-rank step on the same seed and cuts its outputs as the rank
  holds them (``steps.rank_outputs``): logits and cache within 1e-4;
- logs each live collective (``TensorParallel.log``) and plans the same
  step on a ``MeshShape`` of the mesh's shape (its ``fsdp_records`` and
  the recorder's collectives, run on meta): equal, kind by kind and byte
  for byte.

The one-rank step is held to JAX by ``tests/test_torch_launch.py``'s
``test_fn_matches_jax``. Here the ranks' logits are also put back together
and held to the one-rank step run in the test process, and the MT cache's
cut by rows and heads likewise; the other decoder-only families (MoE, RWKV,
Jamba, Qwen3, Llama-4) run on the ``(2, 2)`` mesh.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.launch.world import World  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
SMALL = {"prefill_32k": dict(seq=12, batch=2, kind="prefill"),
         "decode_32k": dict(seq=24, batch=2, kind="decode"),
         "long_500k": dict(seq=40, batch=1, kind="decode")}
SMALL_MT = {"mt_verify": dict(seq=16, batch=2, kind="mt_verify", verify=4)}

KINDS = [  # (id, arch, shape, kwargs, config fields)
    ("decode", "smollm-135m", "decode_32k", {}, None),
    ("verify", "smollm-135m", "decode_32k", dict(verify_tokens=5), None),
    ("multidraft", "smollm-135m", "decode_32k",
     dict(verify_tokens=4, multidraft=3), None),
    ("prefill", "smollm-135m", "prefill_32k", {}, None),
    ("long", "smollm-135m", "long_500k", {}, dict(sliding_window=16)),
    ("audio", "hubert-xlarge", "prefill_32k", {}, None),
    ("vlm", "llama-3.2-vision-11b", "prefill_32k", {}, None),
    ("mt_verify", "mt-product", "mt_verify", {}, None),
]
FAMILIES = [
    ("phi-verify", "phi3.5-moe-42b-a6.6b", "decode_32k",
     dict(verify_tokens=5), None),
    ("rwkv-verify", "rwkv6-1.6b", "decode_32k", dict(verify_tokens=5), None),
    ("jamba-decode", "jamba-v0.1-52b", "decode_32k", {}, None),
    ("qwen3-prefill", "qwen3-8b", "prefill_32k", {}, None),
    ("llama4-decode", "llama4-maverick-400b-a17b", "decode_32k", {}, None),
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


def _small(shape: str) -> dict:
    return (SMALL_MT if shape.startswith("mt_") else SMALL)[shape]


def run_step(world, case, mesh, fsdp, **extra) -> list:
    _, arch, shape, kw, fields = case
    return world.run("repro_torch.launch.mesh_runs:built_step", arch=arch,
                     shape=shape, kw=dict(kw, fsdp_inference=fsdp),
                     mesh=mesh, seed=1, shape_override=_small(shape),
                     fields=fields, on_card=False, **extra)


def check_ranks(got: list, case, mesh, fsdp) -> None:
    _, arch, shape, _, _ = case
    data, model = mesh
    assert sorted((r["data_rank"], r["model_rank"]) for r in got) == [
        (d, m) for d in range(data) for m in range(model)]
    B = _small(shape)["batch"]
    for r in got:
        assert r["close"], (r["rank"], r["errors"])
        live = collections.Counter(map(tuple, r["collectives"]))
        assert live == collections.Counter(map(tuple, r["plan"])), r["rank"]
        assert r["collectives"] == got[0]["collectives"]
        gathers = sum(n for (k, _), n in live.items() if k == "all-gather")
        # FSDP leaves are gathered over the data axis, once a step; the MT
        # serves with its model split only (JAX's mt_verify specs)
        fsdp_gathers = fsdp and data > 1 and arch != "mt-product"
        assert (gathers > 0) == fsdp_gathers, live
        # a rank's rows: its equal part, or all of them when the batch
        # does not divide the data axis (long_500k's one row)
        assert r["rows"] == (B // data if B % data == 0 else B)
        assert not any(r["launches"].values())   # the CPU: plain versions


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no-fsdp"])
@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("case", KINDS, ids=[c[0] for c in KINDS])
def test_serving_step_on_a_world_equals_one_rank(world, case, mesh, fsdp):
    check_ranks(run_step(world, case, mesh, fsdp), case, mesh, fsdp)


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no-fsdp"])
@pytest.mark.parametrize("case", FAMILIES, ids=[c[0] for c in FAMILIES])
def test_every_family_steps_on_a_world(world, case, fsdp):
    check_ranks(run_step(world, case, (2, 2), fsdp), case, (2, 2), fsdp)


@pytest.fixture
def small(monkeypatch):
    for table, entries in ((steps.SHAPES, SMALL),
                           (steps.MT_SHAPES, SMALL_MT)):
        for k, v in entries.items():
            monkeypatch.setitem(table, k, v)


def one_rank(case):
    """The one-rank step's outputs on seed 1, run in this process."""
    import dataclasses

    _, arch, shape, kw, fields = case
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              **(fields or {}))
    built = steps.build_step(arch, shape, MeshShape(("data", "model"),
                                                    (1, 1)),
                             dtype=torch.float32, cfg_override=cfg, **kw)
    return built.fn(*steps.example_inputs(built, device="cpu", seed=1))


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("name", ["verify", "vlm", "mt_verify"])
def test_ranks_logits_put_together_equal_one_rank(world, small, name, mesh):
    case = next(c for c in KINDS if c[0] == name)
    got = run_step(world, case, mesh, True, arrays=True)
    out = one_rank(case)
    want = (out[0] if isinstance(out, tuple) else out).numpy()
    full = np.full(want.shape, np.nan, np.float32)
    for r in got:
        part = r["arrays"][0][0]
        rows = part.shape[0]
        d, m = r["data_rank"], r["model_rank"]
        sl = [slice(d * rows, (d + 1) * rows)]
        if part.shape[-1] != want.shape[-1]:   # the vocabulary cut
            V = part.shape[-1]
            sl = sl + [Ellipsis, slice(m * V, (m + 1) * V)]
        prev = full[tuple(sl)]   # ranks of one data shard: the same rows
        seen = ~np.isnan(prev)
        np.testing.assert_allclose(part[seen], prev[seen], **TOL)
        full[tuple(sl)] = part
    assert not np.isnan(full).any()
    np.testing.assert_allclose(full, want, **TOL)
    if name == "mt_verify":   # the cache: rows by data shard, heads by rank
        k = out[1]["self"].k.numpy()
        put = np.full(k.shape, np.nan, np.float32)
        for r in got:
            part = r["arrays"][0][1]          # the self-attention cache's k
            rows, heads = part.shape[1], part.shape[3]
            d, m = r["data_rank"], r["model_rank"]
            put[:, d * rows:(d + 1) * rows, :,
                m * heads:(m + 1) * heads] = part
        np.testing.assert_allclose(put, k, **TOL)
