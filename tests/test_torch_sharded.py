"""Sharded serving in the port: ``StreamingEngine`` on a ``(data, model)``
mesh over a 4-rank gloo world of CPU processes (one world a module,
``repro_torch.launch.world.World``), mirroring ``tests/test_sharded.py``
on the same toys (the MT ``tiny_config`` at depth 2 / d_model 64; SmolLM
``reduced()``), with the JAX package's weights carried across:

1. token identity in the four modes x dense / paged x both backends:
   every rank's tokens equal the port's unsharded engine's and the JAX
   package's unsharded engine's, log-probs within 1e-4; each rank holds a
   shard of the slots and of the weights; a realtime drive (rank 0's
   clock) gives the same tokens; reduced Qwen3 with its heads split (and,
   on a ``(1, 4)`` mesh, a whole ``wk`` beside a split ``wq``) and a
   ``(4, 1)`` mesh equal the port's unsharded engine;
2. the dispatch contract: a lone resident's iterations are one step
   each, and a mesh iteration reads the card as often as the unsharded
   engine's plus one bundle gather; jobs arriving together are admitted
   in the unsharded engine's batches;
3. shard-local exhaustion against JAX's sharded engine on the forced host
   ``(2, 2)`` mesh: the same preemptions, the same shards named, the same
   tokens, the same ``shard_stats()``;
4. placement: the least-loaded shard, and prefix affinity; a prefix
   match cut at the first page of another shard gives the unsharded
   engine's tokens;
5. the indivisible-slots and indivisible-pages errors; the MoE,
   recurrent and VLM families build on a mesh, the audio encoder gets the
   unsharded backend's refusal, and a front door over a mesh engine
   builds, starts and stops on every rank (ROADMAP item 9c is ported;
   ``tests/test_torch_sharded_server.py`` serves through it);
6. the CLI under torchrun, and its one-rank run.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.mt import tiny_config as jax_tiny  # noqa: E402
from repro.data import SyntheticReactionDataset  # noqa: E402
from repro.launch.mesh import make_serving_mesh  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import StreamingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import (seq2seq_params_from_jax,  # noqa: E402
                                transformer_params_from_jax)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.mt import tiny_config  # noqa: E402
from repro_torch.launch import mesh_runs  # noqa: E402
from repro_torch.launch.world import World  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MAX_NEW = 12
MODES = ("greedy", "speculative", "beam", "speculative_beam")
GROUPS = {m: 2 for m in MODES}   # the least that splits over data = 2
SERVE = "repro_torch.launch.mesh_runs:serve"


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


@pytest.fixture(scope="module")
def toys(tmp_path_factory):
    """The JAX toys and their port descriptions (weights saved once)."""
    d = tmp_path_factory.mktemp("mesh")
    ds = SyntheticReactionDataset(16, seed=0)
    jcfg = jax_tiny(ds.tokenizer.vocab_size, depth=2, d_model=64,
                    max_len=192)
    jp = js2s.init(jax.random.PRNGKey(0), jcfg)
    torch.save(seq2seq_params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu"), d / "mt.pt")
    lcfg = jax_get_config("smollm-135m", reduced=True)
    lp = jtr.init(jax.random.PRNGKey(0), lcfg)
    torch.save(transformer_params_from_jax(jax.tree.map(np.asarray, lp),
                                           device="cpu"), d / "lm.pt")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(4, 500, size=L).astype(np.int32).tolist()
               for L in (9, 17, 24, 5, 21, 13, 7, 11)]
    return dict(
        ds=ds, jcfg=jcfg, jp=jp, lcfg=lcfg, lp=lp, prompts=prompts,
        mt=dict(family="mt",
                cfg=tiny_config(ds.tokenizer.vocab_size, depth=2, d_model=64,
                                max_len=192),
                params=str(d / "mt.pt"), tokenizer=ds.tokenizer.to_dict()),
        lm=dict(family="lm", cfg=get_config("smollm-135m", reduced=True),
                params=str(d / "lm.pt")))


def _kw(backend: str, paged: bool) -> dict:
    kw = dict(max_new=MAX_NEW, draft_len=3, n_drafts=4, n_beams=2,
              mode_groups=dict(GROUPS))
    kw.update(dict(max_src=96) if backend == "mt" else
              dict(max_src=28, prefill_chunk=8, eos_id=2))
    if paged:
        kw.update(paged=True, page_size=8)
    return kw


def _jobs(toys, backend):
    qs = ([toys["ds"].pair(i % 8)[0] for i in range(8)] if backend == "mt"
          else toys["prompts"])
    return [(q, MODES[i % len(MODES)]) for i, q in enumerate(qs)]


def _jax_unsharded(toys, backend):
    """The JAX package's unsharded engine on the same jobs (dense)."""
    kw = _kw(backend, paged=False)
    if backend == "mt":
        eng = JaxEngine(toys["jp"], toys["jcfg"], toys["ds"].tokenizer,
                        JaxEngineConfig(**kw))
    else:
        eng = JaxEngine(toys["lp"], toys["lcfg"], None, JaxEngineConfig(**kw))
    rids = [eng.submit(np.asarray(q, np.int32) if isinstance(q, list) else q,
                       mode=m, arrival=float(i))
            for i, (q, m) in enumerate(_jobs(toys, backend))]
    res = eng.serve()
    return [res[int(r)] for r in rids]


# the loop's counts a mesh rank shares with the unsharded engine
LOOP_COUNTS = ("n_iterations", "n_dispatches", "host_reads",
               "steady_iterations_one_dispatch", "admit_batches",
               "admit_batch_queries")


def _same(got: list, want: list) -> None:
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g["tokens"]),
                                      np.asarray(w["tokens"] if isinstance(
                                          w, dict) else w.tokens))
        np.testing.assert_allclose(
            g["logprobs"], w["logprobs"] if isinstance(w, dict)
            else w.logprobs, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# 1. token identity, 2. the dispatch contract


@pytest.mark.parametrize("backend", ["mt", "lm"])
def test_sharded_token_identity(world, toys, backend):
    jobs = _jobs(toys, backend)
    want_jax = _jax_unsharded(toys, backend)
    for paged in (False, True):
        kw = _kw(backend, paged)
        ref = mesh_runs.serve(toys[backend], kw, jobs, on_card=False,
                              mesh=None)
        _same(ref["results"], want_jax)
        got = world.run(SERVE, on_card=False,
                        model=toys[backend], engine=kw, jobs=jobs)
        for r in got:
            _same(r["results"], ref["results"])
            _same(r["results"], want_jax)
            assert r["shard_stats"]["n_shards"] == 2
            assert all(n > 0 for n in r["shard_stats"]["admitted_by_shard"])
            # the session genuinely spans the mesh: each rank holds half
            # of every group's slots and a shard of the weights
            assert r["local_slots"] == [n // 2 for n in r["global_slots"]]
            assert r["param_elems"] < ref["param_elems"]
        assert all(r["shard_stats"] == got[0]["shard_stats"] for r in got)
        # the same iterations, host reads and steps as unsharded, plus one
        # bundle gather an iteration
        ls, lr = got[0]["loop_stats"], ref["loop_stats"]
        for k in LOOP_COUNTS:
            assert ls[k] == lr[k], (k, ls, lr)
        assert ls["bundle_gathers"] == got[0]["steps"] == ref["steps"]
        assert ref["shard_stats"]["admitted_by_shard"] == [0]
    if backend == "lm":
        # a realtime drive: every rank reads rank 0's clock
        got = world.run(SERVE, on_card=False,
                        model=toys[backend], engine=kw, jobs=jobs,
                        realtime=True, arrivals=False)
        ref = mesh_runs.serve(toys[backend], kw, jobs, on_card=False,
                              mesh=None,
                              realtime=True, arrivals=False)
        for r in got:
            _same(r["results"], ref["results"])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_sharded_batched_admission(world, toys, paged):
    """Every job arriving at once: a pass's admissions are one flush on
    every rank, each rank writing its own shard's; the tokens equal the
    unsharded engine's, and so do the loop's counts, the admission
    batches and the requests in them among them, on every rank."""
    jobs = _jobs(toys, "mt")
    kw = _kw("mt", paged)
    ref = mesh_runs.serve(toys["mt"], kw, jobs, on_card=False, mesh=None,
                          arrivals=False)
    got = world.run(SERVE, on_card=False, model=toys["mt"], engine=kw,
                    jobs=jobs, arrivals=False)
    lr = ref["loop_stats"]
    assert lr["admit_batch_queries"] == len(jobs) > lr["admit_batches"]
    for r in got:
        _same(r["results"], ref["results"])
        assert all(n > 0 for n in r["shard_stats"]["admitted_by_shard"])
        for k in LOOP_COUNTS:
            assert r["loop_stats"][k] == lr[k], (k, r["loop_stats"], lr)


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-8b", (2, 2)),       # wq, wk, wv split: 4 / 1 heads a rank
    ("qwen3-8b", (1, 4)),       # wq split, wk / wv whole: a kv head a rank
    ("smollm-135m", (4, 1)),    # data parallel only
], ids=["qwen3-2x2", "qwen3-1x4", "smollm-4x1"])
def test_sharded_heads_and_mesh_shapes(world, toys, arch, shape):
    """Split heads (GQA with qk-norm), a whole ``wk`` beside a split
    ``wq``, and pure data or model parallelism: tokens equal the port's
    unsharded engine's."""
    model = dict(family="lm", cfg=get_config(arch, reduced=True), seed=0)
    kw = dict(max_new=MAX_NEW, max_src=28, draft_len=3, n_drafts=4,
              prefill_chunk=8, eos_id=2, paged=True, page_size=8,
              mode_groups={"greedy": 4, "speculative": 4})
    jobs = [(p, ("greedy", "speculative")[i % 2])
            for i, p in enumerate(toys["prompts"])]
    ref = mesh_runs.serve(model, kw, jobs, on_card=False, mesh=None)
    got = world.run(SERVE, on_card=False,
                    model=model, engine=kw, jobs=jobs, mesh=shape)
    for r in got:
        _same(r["results"], ref["results"])
        assert r["shard_stats"]["n_shards"] == shape[0]
        if shape[1] > 1:
            assert r["param_elems"] < ref["param_elems"]


def test_lone_resident_one_step_an_iteration(world, toys):
    kw = dict(mode="speculative", draft_len=3, n_drafts=4, max_new=MAX_NEW,
              max_src=28, n_slots=4, prefill_chunk=8, eos_id=2, paged=True,
              page_size=8)
    got = world.run(SERVE, on_card=False, model=toys["lm"], engine=kw,
                    jobs=[(toys["prompts"][0], "speculative")])
    stats = got[0]["loop_stats"]
    assert stats["n_iterations"] >= 3
    # the admission iteration adds its admit, the activation its finish;
    # every other iteration of the lone resident is the one step
    assert (stats["steady_iterations_one_dispatch"]
            >= stats["n_iterations"] - 2), stats
    assert stats["dispatches_per_iteration"] <= 2.0, stats
    assert stats["bundle_gathers"] == stats["n_iterations"]
    # a paged iteration reads the plan's flag and the bundle
    assert stats["host_reads"] == 2 * stats["n_iterations"], stats
    assert stats["model_collectives"] > 0


# ---------------------------------------------------------------------------
# 3. shard-local exhaustion against JAX's sharded engine


def test_sharded_exhaustion_matches_jax(world, toys):
    ds = toys["ds"]
    queries = [ds.pair(i % 8)[0] for i in range(8)]
    kw = dict(mode="speculative", draft_len=4, n_drafts=6, max_new=24,
              max_src=96, n_slots=4)
    # 26 usable pages a shard: above one slot's worst case, below two
    # slots' growth, so each shard's segment runs dry mid-decode
    pkw = dict(paged=True, page_size=8, n_pages=52)
    jeng = JaxEngine(toys["jp"], toys["jcfg"], ds.tokenizer, JaxEngineConfig(
        mesh=make_serving_mesh((2, 2)), **pkw, **kw))
    seen = []
    orig = jeng.scheduler._preempt_youngest

    def spy(prefer=None, shard=None):
        seen.append(shard)
        return orig(prefer=prefer, shard=shard)

    jeng.scheduler._preempt_youngest = spy
    want = [p.smiles[0] for p in jeng.predict(queries)]
    ref = mesh_runs.serve(toys["mt"], kw, [(q, "speculative")
                                           for q in queries],
                          on_card=False, mesh=None, predict=True)
    assert [r["smiles"][0] for r in ref["results"]] == want
    got = world.run(SERVE, on_card=False,
                    model=toys["mt"], engine=dict(kw, **pkw),
                    jobs=[(q, "speculative") for q in queries], predict=True)
    assert jeng.scheduler.n_preemptions > 0
    for r in got:
        assert [x["smiles"][0] for x in r["results"]] == want
        assert r["preemptions"] == jeng.scheduler.n_preemptions
        # every exhaustion names its shard, the same as JAX's
        assert r["preempt_shards"] == seen and None not in seen
        assert r["shard_stats"] == jeng.shard_stats()


# ---------------------------------------------------------------------------
# 4. placement


def test_placement_prefers_least_loaded_shard(world, toys):
    lm = toys["lm"]
    kw = dict(mode="speculative", draft_len=3, n_drafts=4, max_new=MAX_NEW,
              max_src=28, n_slots=4, prefill_chunk=8, eos_id=2, paged=True,
              page_size=8)
    q = toys["prompts"][0]
    payload = ("payload", q, "speculative")
    free = [0, 1, 2, 3]          # slots 0-1: shard 0, slots 2-3: shard 1
    got = world.run("repro_torch.launch.mesh_runs:probe", on_card=False,
                    model=lm,
                    engine=kw, calls=[
                        (dict(_booked=[], _mirror_free_sh=[2, 500]),
                         "_place_slot", ["speculative", free, payload]),
                        (dict(_booked=[], _mirror_free_sh=[500, 2]),
                         "_place_slot", ["speculative", free, payload])])
    assert all(r == [2, 0] for r in got), got
    # dense engines rank by resident count instead of pool headroom
    dense = dict(mode="greedy", max_new=MAX_NEW, max_src=28, n_slots=4,
                 prefill_chunk=8, eos_id=2)
    got = world.run("repro_torch.launch.mesh_runs:probe", on_card=False,
                    model=lm,
                    engine=dense, calls=[
                        ({}, "_place_slot", ["greedy", free,
                                             ("payload", q, "greedy")]),
                        ({}, "_shard_order", ["speculative",
                                              ("payload", q, "greedy"),
                                              {0, 1}])])
    assert all(r == [0, [0, 1]] for r in got), got


def test_placement_prefix_affinity_routes_to_parent_shard(world, toys):
    kw = dict(mode="speculative", draft_len=3, n_drafts=4, max_new=8,
              max_src=40, n_slots=4, prefill_chunk=8, eos_id=2, paged=True,
              page_size=8, prefix_cache=True)
    parent = np.random.default_rng(7).integers(4, 500, size=33).astype(
        np.int32).tolist()            # a prompt body of 4 pages
    calls = [({}, "radix_shard", [parent])]
    for bias in ((5, 40), (40, 5)):
        calls.append((dict(_booked=[], _mirror_free_sh=list(bias)),
                      "_shard_order", ["speculative",
                                       ("payload", parent, "speculative"),
                                       {0, 1}]))
    got = world.run("repro_torch.launch.mesh_runs:probe", on_card=False,
                    model=toys["lm"],
                    engine=kw, calls=calls, serve_first=[parent])
    for r in got:
        shard = r[0]
        assert shard in (0, 1), "the parent's prefix never reached the tree"
        # whichever shard least-loaded alone would pick, the cached prefix
        # wins
        assert r[1][0] == shard and r[2][0] == shard, r
    assert all(r == got[0] for r in got)


def test_prefix_match_cut_at_foreign_shard_matches_unsharded(world, toys):
    """A radix match over pages of another shard: two children fill the
    shard that holds their parent's pages (prefix affinity), so the third
    goes to the other shard, where a rank reads only its own segment: its
    match is cut at the first foreign page and its whole prompt prefilled.
    Every token and log-prob equals the unsharded engine's (which aliases
    all three), and the hit count loses the third child's match."""
    kw = dict(mode="speculative", draft_len=3, n_drafts=4, max_new=8,
              max_src=40, n_slots=4, prefill_chunk=8, eos_id=2, paged=True,
              page_size=8, prefix_cache=True)
    rng = np.random.default_rng(7)
    parent = rng.integers(4, 500, size=33).astype(np.int32).tolist()
    jobs = [(parent + rng.integers(4, 500, size=n).astype(np.int32)
             .tolist(), "speculative") for n in (5, 3, 6)]
    first = [(parent, "speculative")]   # a prompt body of 4 pages
    ref = mesh_runs.serve(toys["lm"], kw, jobs, on_card=False,
                          mesh=None, arrivals=False,
                          serve_first=first)
    got = world.run(SERVE, on_card=False,
                    model=toys["lm"], engine=kw, jobs=jobs,
                    arrivals=False, serve_first=first)
    match = 4 * kw["page_size"]         # each child matches the 4 pages
    assert ref["prefix_stats"]["hit_tokens"] == 3 * match, ref
    for r in got:
        _same(r["results"], ref["results"])
        a, b, c = r["prefix_shards"]
        assert a == b != c, r["prefix_shards"]
        assert r["prefix_stats"]["hit_tokens"] == 2 * match, r
        assert r["prefix_stats"]["lookups"] == 4   # the parent's, too
    assert all(r["prefix_stats"] == got[0]["prefix_stats"] for r in got)


# ---------------------------------------------------------------------------
# 5. construction errors and refusals


def test_mesh_rejects_indivisible_slots_and_pages_and_refuses(world, toys,
                                                             tmp_path):
    """The indivisible-slots and indivisible-pages errors; every
    decoder-only family builds on a mesh (ROADMAP item 9b is ported); the
    audio encoder gets the unsharded backend's refusal; a front door over
    a mesh engine builds on every rank, rank 0 binds a port, and the door
    stops on every rank when rank 0 stops it (item 9c is ported)."""
    lm, mt = toys["lm"], toys["mt"]
    base = dict(mode="greedy", max_new=8, max_src=28, prefill_chunk=8,
                eos_id=2)
    red = {a: dict(family="lm", cfg=get_config(a, reduced=True), seed=0)
           for a in ("phi3.5-moe-42b-a6.6b", "rwkv6-1.6b",
                     "llama-3.2-vision-11b", "jamba-v0.1-52b")}
    cases = [
        (lm, dict(base, n_slots=3), "ValueError", "divide"),
        (lm, dict(base, n_slots=4, paged=True, page_size=8, n_pages=31),
         "ValueError", "divide"),
        *((model, dict(base, n_slots=2), "", "") for model in red.values()),
        (dict(family="lm", cfg=get_config("hubert-xlarge", reduced=True),
              seed=0), dict(base, n_slots=2), "ValueError",
         "encoder-only architecture: no decode step"),
    ]
    for model, kw, kind, text in cases:
        got = world.run("repro_torch.launch.mesh_runs:refusals", on_card=False,
                        model=model, engine=kw)
        for msg in got:
            if not kind:                  # the engine builds
                assert msg == "", msg
                continue
            assert msg.startswith(kind) and text in msg, msg
    port_file, stop_file = tmp_path / "port", tmp_path / "stop"
    world.start("repro_torch.launch.mesh_runs:front_door", on_card=False,
                model=mt, engine=dict(mode="greedy", max_new=8, max_src=96,
                                      n_slots=2),
                port_file=str(port_file), stop_file=str(stop_file),
                server=dict(realtime=False))
    try:
        deadline = time.monotonic() + 60
        while not port_file.exists() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert int(port_file.read_text()) > 0
    finally:
        stop_file.write_text("stop")
        got = world.collect()
    for r in got:
        assert r["error"] is None, r
        assert r["stats"]["accepted"] == 0 and r["steps"] == 0
        assert r["stats"]["shard_stats"]["n_shards"] == 2


# ---------------------------------------------------------------------------
# 6. the CLI


def _cli(args: list, timeout: int = 240) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, env=env, timeout=timeout, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_cli_mesh_and_one_rank():
    flags = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
             "--requests", "4", "--prompt-len", "24", "--max-new", "16",
             "--paged"]
    out = _cli(["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "4", "-m", "repro_torch.launch.serve",
                *flags, "--mesh", "2", "2"])
    assert "continuous == one-shot speculative: True" in out, out
    assert "mesh (2, 2), 2 data shards" in out, out
    assert out.count("outputs identical: True") == 1   # rank 0 prints
    out = _cli(["-m", "repro_torch.launch.serve", *flags])
    assert "continuous == one-shot speculative: True" in out, out
