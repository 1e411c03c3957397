"""The port's expert-parallel MoE on a serving mesh, held to the JAX
package on a 4-rank gloo world of CPU processes (one world a module,
``repro_torch.launch.world.World``), on the reduced ``phi3.5-moe-42b-a6.6b``
(4 experts, top-2) and ``llama4-maverick-400b-a17b`` (4 experts, top-1,
shared expert) configs, with the JAX package's weights carried across by
``repro_torch.bridge``:

1. the layer on a model-split ``(1, 4)`` world: every rank's ``moe_ffn``
   (its one expert, the shared expert's quarter) within 1e-5 of the
   port's unsharded layer and of JAX's, with and without drops;
2. global routing on data-split ``(4, 1)`` and ``(2, 2)`` worlds at a
   capacity factor that drops: the ranks' places, ``keep``, experts and
   capacity, concatenated, equal ``moe_route`` over the concatenated
   rows, and the outputs and the dropped and top-1 fractions equal the
   unsharded layer's;
3. the engine: reduced Phi (dropless, four modes) and Llama-4 on a
   ``(2, 2)`` mesh, dense and paged: every rank's tokens equal the port's
   unsharded engine's and JAX's unsharded engine's, log-probs within
   1e-4; with drops (capacity factor 0.5) every rank's tokens equal JAX's
   SHARDED engine on the forced host ``(2, 2)`` mesh, whose tokens differ
   from its unsharded engine's there; Phi on ``(1, 4)`` (2 kv heads do not
   divide 4: ``wk`` / ``wv`` whole beside a split ``wq``) and ``(4, 1)``
   equals the port's unsharded engine.

The JAX engines are built once a module; the port runs with one torch
thread.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.mesh import make_serving_mesh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import StreamingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import transformer_params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh_runs  # noqa: E402
from repro_torch.launch.world import World  # noqa: E402
from repro_torch.models import moe  # noqa: E402

PHI, LLAMA4 = "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"
MODES = ("greedy", "speculative", "beam", "speculative_beam")
SERVE = "repro_torch.launch.mesh_runs:serve"
LAYER = "repro_torch.launch.mesh_runs:layer"
DROPS = 0.5        # the capacity factor at which reduced Phi drops


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


def _with_cf(cfg, cf):
    if cf is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """arch -> (JAX cfg, JAX params, port model description, port params);
    ``(arch, cf)`` the same weights at capacity factor ``cf``."""
    d = tmp_path_factory.mktemp("moe_mesh")
    out = {}

    def get(arch, cf=None):
        if arch not in out:
            jcfg = jax_get_config(arch, reduced=True)
            jp = jtr.init(jax.random.PRNGKey(0), jcfg)
            pt = transformer_params_from_jax(jax.tree.map(np.asarray, jp),
                                             device="cpu")
            path = d / f"{arch}.pt"
            torch.save(pt, path)
            out[arch] = (jcfg, jp, dict(family="lm", params=str(path),
                                        cfg=get_config(arch, reduced=True)),
                         pt)
        jcfg, jp, model, pt = out[arch]
        return (_with_cf(jcfg, cf), jp, dict(model, capacity_factor=cf),
                pt)

    return get


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(4, 500, size=L).astype(np.int32).tolist()
            for L in (9, 17, 24, 5, 21, 13, 7, 11)]


def _kw(modes, paged: bool, slots: int = 2) -> dict:
    kw = dict(max_new=12, max_src=28, draft_len=3, n_drafts=4, n_beams=2,
              prefill_chunk=8, eos_id=2,
              mode_groups={m: slots for m in modes})
    if paged:
        kw.update(paged=True, page_size=8)
    return kw


def _jobs(modes):
    return [(p, modes[i % len(modes)]) for i, p in enumerate(_prompts())]


def _jax_engine(jcfg, jp, modes, *, paged=False, mesh=None):
    """The JAX package's engine (unsharded, or sharded on the forced host
    ``mesh``) on the same jobs."""
    eng = JaxEngine(jp, jcfg, None, JaxEngineConfig(
        **_kw(modes, paged), **({} if mesh is None else
                                dict(mesh=make_serving_mesh(mesh)))))
    rids = [eng.submit(np.asarray(q, np.int32), mode=m, arrival=float(i))
            for i, (q, m) in enumerate(_jobs(modes))]
    res = eng.serve()
    return [res[int(r)] for r in rids]


def _tokens(r):
    return np.asarray(r["tokens"] if isinstance(r, dict) else r.tokens)


def _same(got: list, want: list) -> None:
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_tokens(g), _tokens(w))
        np.testing.assert_allclose(
            g["logprobs"], w["logprobs"] if isinstance(w, dict)
            else w.logprobs, rtol=1e-4, atol=1e-4)


def _moe_block(cfg) -> int:
    return cfg.ffn_pattern.index("moe")


# ---------------------------------------------------------------------------
# 1. the layer on a model-split world


@pytest.mark.parametrize("cf", [None, DROPS], ids=["dropless", "drops"])
@pytest.mark.parametrize("arch", [PHI, LLAMA4], ids=["no_shared", "shared"])
def test_moe_ffn_by_expert_matches_unsharded_and_jax(world, models, arch,
                                                     cf):
    jcfg, jp, model, pt = models(arch, cf)
    cfg = _with_cf(model["cfg"], cf)
    i = _moe_block(cfg)
    x = np.random.default_rng(2).standard_normal(
        (3, 7, cfg.d_model)).astype(np.float32)
    want_jax, jaux = jmoe.moe_ffn(jax.tree.map(lambda a: a[0],
                                               jp["blocks"][i]["ffn"]),
                                  jcfg, jnp.asarray(x))
    with torch.no_grad():
        want, aux = moe.moe_ffn(pt["blocks"][i][0]["ffn"], cfg,
                                torch.from_numpy(x))
    np.testing.assert_allclose(want.numpy(), np.asarray(want_jax),
                               rtol=1e-5, atol=1e-5)
    got = world.run(LAYER, model=model, kind="moe", args={"x": x},
                    mesh=(1, 4), block=i)
    for r in got:
        np.testing.assert_allclose(r["out"], want.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["out"], np.asarray(want_jax),
                                   rtol=1e-5, atol=1e-5)
        assert float(r["dropped"]) == pytest.approx(
            float(jaux["moe_dropped_frac"]), abs=1e-7)
    assert (float(aux["moe_dropped_frac"]) > 0) == (cf is not None)


# ---------------------------------------------------------------------------
# 2. global routing on a data-split world


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_global_routing_equals_the_concatenated_call(world, models, shape):
    jcfg, jp, model, pt = models(PHI, DROPS)
    cfg = _with_cf(model["cfg"], DROPS)
    x = np.random.default_rng(3).standard_normal(
        (8, 5, cfg.d_model)).astype(np.float32)
    p = pt["blocks"][0][0]["ffn"]
    with torch.no_grad():
        tokens = torch.from_numpy(x).reshape(-1, cfg.d_model)
        want = moe.moe_route(p, cfg, tokens)
        want_out, want_aux = moe.moe_ffn(p, cfg, torch.from_numpy(x))
    assert not bool(want["keep"].all())            # the call drops
    jout, jaux = jmoe.moe_ffn(jax.tree.map(lambda a: a[0],
                                           jp["blocks"][0]["ffn"]),
                              jcfg, jnp.asarray(x))
    np.testing.assert_allclose(want_out.numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    got = world.run(LAYER, model=model, kind="moe", args={"x": x}, mesh=shape,
                    split_rows=True)
    data, n_model = shape
    # rank r sits at (r // model, r % model): model rank 0 of each shard,
    # in data order, holds the call's rows in order
    heads = [got[d * n_model] for d in range(data)]
    for key in ("gate_idx", "pos", "keep"):
        np.testing.assert_array_equal(
            np.concatenate([r[key] for r in heads]), want[key].numpy())
    np.testing.assert_allclose(np.concatenate([r["out"] for r in heads]),
                               want_out.numpy().reshape(8, 5, -1),
                               rtol=1e-5, atol=1e-5)
    for r in got:
        assert int(r["capacity"]) == want["capacity"]
        assert float(r["dropped"]) == pytest.approx(
            float(want_aux["moe_dropped_frac"]), abs=1e-7)
        assert float(r["dropped"]) == pytest.approx(
            float(jaux["moe_dropped_frac"]), abs=1e-7)
        assert float(r["top1"]) == pytest.approx(
            float(want_aux["moe_top1_frac"]), abs=1e-7)
    for d in range(data):          # a shard's model ranks agree
        for m in range(n_model):
            np.testing.assert_array_equal(got[d * n_model + m]["pos"],
                                          heads[d]["pos"])


# ---------------------------------------------------------------------------
# 3. the engine


@pytest.mark.parametrize("arch,modes", [(PHI, MODES),
                                        (LLAMA4, MODES[:2])],
                         ids=["phi-dropless", "llama4"])
def test_engine_on_the_mesh_matches_jax_unsharded(world, models, arch,
                                                  modes):
    jcfg, jp, model, _ = models(arch)
    want_jax = _jax_engine(jcfg, jp, modes)
    jobs = _jobs(modes)
    for paged in (False, True):
        kw = _kw(modes, paged)
        ref = mesh_runs.serve(model, kw, jobs, mesh=None)
        _same(ref["results"], want_jax)
        got = world.run(SERVE, model=model, engine=kw, jobs=jobs)
        for r in got:
            _same(r["results"], ref["results"])
            _same(r["results"], want_jax)
            assert r["dropped_frac"] == 0.0
            # each rank holds half of the experts and of the slots
            assert r["widths"]["experts"] == 2
            assert r["local_slots"] == [n // 2 for n in r["global_slots"]]
            assert r["loop_stats"]["data_collectives"] > 0
        assert all(r["shard_stats"] == got[0]["shard_stats"] for r in got)


def test_drops_match_jax_sharded_engine(world, models):
    """At capacity factor 0.5 a row's output depends on the other rows of
    its call: JAX's sharded engine (least-loaded placement) gives other
    tokens than its unsharded one, and every rank gives the sharded
    engine's."""
    modes = MODES[:2]
    jcfg, jp, model, _ = models(PHI, DROPS)
    want = _jax_engine(jcfg, jp, modes, paged=True, mesh=(2, 2))
    alone = _jax_engine(jcfg, jp, modes, paged=True)
    assert any(not np.array_equal(_tokens(a), _tokens(b))
               for a, b in zip(want, alone))
    got = world.run(SERVE, model=model, engine=_kw(modes, True),
                    jobs=_jobs(modes))
    for r in got:
        _same(r["results"], want)
        assert r["dropped_frac"] > 0
        assert r["dropped_frac"] == got[0]["dropped_frac"]


@pytest.mark.parametrize("shape", [(1, 4), (4, 1)], ids=["1x4", "4x1"])
def test_phi_mesh_shapes_match_unsharded(world, models, shape):
    _, _, model, _ = models(PHI)
    modes = MODES[:2]
    kw = _kw(modes, True, slots=4)      # 4 slots a mode split over 4 shards
    jobs = _jobs(modes)
    ref = mesh_runs.serve(model, kw, jobs, mesh=None)
    got = world.run(SERVE, model=model, engine=kw, jobs=jobs, mesh=shape)
    for r in got:
        _same(r["results"], ref["results"])
        w = r["widths"]
        if shape == (1, 4):
            # 8 query heads split, 2 kv heads whole: a kv head a rank
            assert (w["heads"], w["kv_heads"], w["experts"]) == (2, 1, 1)
        else:
            assert (w["heads"], w["kv_heads"], w["experts"]) == (8, 2, 4)
