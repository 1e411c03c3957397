"""The port's Mamba, RWKV and cross-attention layers on a serving mesh,
held to the JAX package on a 4-rank gloo world of CPU processes (one world
a module, ``repro_torch.launch.world.World``), on the reduced
``jamba-v0.1-52b`` (Mamba, attention and MoE), ``rwkv6-1.6b`` and
``llama-3.2-vision-11b`` configs, with the JAX package's weights carried
across by ``repro_torch.bridge``:

1. the layers on model-split worlds, ``(2, 2)`` and ``(1, 4)``: every
   rank's ``mamba_mixer`` / ``mamba_step`` (its ``d_inner`` channels, its
   x- and z-columns of the fused ``w_in``), ``rwkv_mixer`` /
   ``rwkv_channel_mix`` (its heads, ``ln_x`` over the gathered width; on
   ``(1, 4)`` the 2 heads do not divide 4: ``wk`` / ``wv`` stay whole and
   the split ``r`` / ``g`` are gathered, every rank runs both heads) and
   ``memory_kv`` + ``cached_cross_attention`` (its heads) within 1e-5 of
   the port's unsharded layer and of JAX's: outputs whole, states and
   memory K/V the rank's own slice;
2. the engine on a ``(2, 2)`` mesh, greedy and speculative at 2 slots a
   mode, dense and paged where the family pages: every rank's tokens
   equal the port's unsharded engine's and JAX's unsharded engine's,
   log-probs within 1e-4;
3. the CLI under torchrun on Jamba, ``--mesh 2 2 --paged``.

The JAX engines are built once a module; the port runs with one torch
thread.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import StreamingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import transformer_params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh_runs  # noqa: E402
from repro_torch.launch.world import World  # noqa: E402
from repro_torch.models import attention, mamba, rwkv  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JAMBA, RWKV, VLM = "jamba-v0.1-52b", "rwkv6-1.6b", "llama-3.2-vision-11b"
MODES = ("greedy", "speculative")
SERVE = "repro_torch.launch.mesh_runs:serve"
LAYER = "repro_torch.launch.mesh_runs:layer"
SHAPES = [(2, 2), (1, 4)]


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
def models(tmp_path_factory):
    """arch -> (JAX cfg, JAX params, port model description, port
    params)."""
    d = tmp_path_factory.mktemp("recurrent_mesh")
    out = {}

    def get(arch):
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
        return out[arch]

    return get


def _block(jp, pt, i: int, name: str):
    """Repeat 0 of pattern position ``i``'s ``name`` sub-tree: JAX's and
    the port's."""
    return (jax.tree.map(lambda a: a[0], jp["blocks"][i][name]),
            pt["blocks"][i][0][name])


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _part(t, dim: int, rank: int, n: int):
    """Model rank ``rank``'s ``n`` channels of ``t`` on ``dim``."""
    t = np.asarray(t)
    return np.take(t, np.arange(rank * n, (rank + 1) * n), axis=dim)


# ---------------------------------------------------------------------------
# 1. the layers


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
def test_mamba_by_channel_matches_unsharded_and_jax(world, models, shape):
    jcfg, jp, model, pt = models(JAMBA)
    cfg = model["cfg"]
    i = cfg.layer_pattern.index("mamba")
    jm, tm = _block(jp, pt, i, "mamba")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 9, cfg.d_model)).astype(np.float32)
    x2 = rng.standard_normal((3, 3, cfg.d_model)).astype(np.float32)
    lengths = np.array([9, 4, 1], np.int32)
    jout, jc = jmamba.mamba_mixer(jm, jcfg, jnp.asarray(x),
                                  lengths=jnp.asarray(lengths),
                                  return_state=True)
    jstep, js = jmamba.mamba_step(jm, jcfg, jc, jnp.asarray(x2))
    with torch.no_grad():
        tout, tc = mamba.mamba_mixer(tm, cfg, torch.from_numpy(x),
                                     lengths=torch.from_numpy(lengths),
                                     return_state=True)
        tstep, ts = mamba.mamba_step(tm, cfg, tc, torch.from_numpy(x2))
    got = world.run(LAYER, model=model, kind="mamba", mesh=shape, block=i,
                    args=dict(x=x, lengths=lengths, x_step=x2,
                              conv=tc["conv"].numpy(),
                              ssm=tc["ssm"].numpy()))
    n = tm["conv_b"].shape[0] // shape[1]
    for rank, r in enumerate(got):
        m = rank % shape[1]
        for b, L in enumerate(lengths):
            _close(r["out"][b, :L], tout[b, :L])
            _close(r["out"][b, :L], jout[b, :L])
        for want in (tstep, jstep):
            _close(r["step"], want)
        for key, dim in (("conv", 2), ("ssm", 1)):
            for st in (tc, jc):
                _close(r[key], _part(st[key], dim, m, n))
            for st in (ts, js):
                _close(r[f"step_{key}"], _part(st[key], dim, m, n))


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
def test_rwkv_by_head_matches_unsharded_and_jax(world, models, shape):
    jcfg, jp, model, pt = models(RWKV)
    cfg = model["cfg"]
    jr, trw = _block(jp, pt, 0, "rwkv")
    jcm, tcm = _block(jp, pt, 0, "cmix")
    H, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 6, cfg.d_model)).astype(np.float32)
    S = 0.1 * rng.standard_normal((3, H, hd, hd)).astype(np.float32)
    x_tm, x_cm = (rng.standard_normal((3, cfg.d_model)).astype(np.float32)
                  for _ in range(2))
    jout, (jS, _) = jrwkv.rwkv_mixer(jr, jcfg, jnp.asarray(x),
                                     state=jnp.asarray(S),
                                     x_last=jnp.asarray(x_tm))
    jcmo, _ = jrwkv.rwkv_channel_mix(jcm, jnp.asarray(x),
                                     x_last=jnp.asarray(x_cm))
    with torch.no_grad():
        tout, (tS, _) = rwkv.rwkv_mixer(trw, cfg, torch.from_numpy(x),
                                        state=torch.from_numpy(S),
                                        x_last=torch.from_numpy(x_tm))
        tcmo, _ = rwkv.rwkv_channel_mix(tcm, torch.from_numpy(x),
                                        x_last=torch.from_numpy(x_cm))
    got = world.run(LAYER, model=model, kind="rwkv", mesh=shape,
                    args=dict(x=x, S=S, x_tm=x_tm, x_cm=x_cm))
    # the heads split where they divide the model axis, else every rank
    # runs them all
    n = H // shape[1] if H % shape[1] == 0 else H
    for rank, r in enumerate(got):
        m = rank % shape[1] if n < H else 0
        for want in (tout, jout):
            _close(r["out"], want)
        for want in (tcmo, jcmo):
            _close(r["cmix"], want)
        for want in (tS, jS):
            _close(r["S"], _part(want, 1, m, n))


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "1x4"])
def test_cross_attention_by_head_matches_unsharded_and_jax(world, models,
                                                          shape):
    jcfg, jp, model, pt = models(VLM)
    cfg = model["cfg"]
    i = cfg.layer_pattern.index("xattn")
    ja, ta = _block(jp, pt, i, "attn")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, cfg.d_model)).astype(np.float32)
    memory = rng.standard_normal(
        (3, cfg.memory_tokens, cfg.memory_dim)).astype(np.float32)
    mask = np.ones((3, cfg.memory_tokens), bool)
    mask[1, 9:] = False
    mask[2, :3] = False
    jkv = jattn.memory_kv(ja, jcfg, jnp.asarray(memory))
    jout = jattn.cached_cross_attention(ja, jcfg, jnp.asarray(x), jkv,
                                        memory_mask=jnp.asarray(mask))
    with torch.no_grad():
        tkv = attention.memory_kv(ta, cfg, torch.from_numpy(memory))
        tout = attention.cached_cross_attention(
            ta, cfg, torch.from_numpy(x), tkv,
            memory_mask=torch.from_numpy(mask))
    got = world.run(LAYER, model=model, kind="xattn", mesh=shape, block=i,
                    args=dict(x=x, memory=memory, memory_mask=mask))
    n = cfg.n_heads // shape[1]
    for rank, r in enumerate(got):
        m = rank % shape[1]
        for want in (tout, jout):
            _close(r["out"], want)
            _close(r["full"], want)
        for k in ("mk", "mv"):
            for want in (tkv, jkv):
                _close(r[k], _part(want[k], 2, m, n))


# ---------------------------------------------------------------------------
# 2. the engine


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(4, 500, size=L).astype(np.int32).tolist()
            for L in (9, 17, 24, 5, 21, 13, 7, 11)]


def _kw(paged: bool) -> dict:
    kw = dict(max_new=12, max_src=28, draft_len=3, n_drafts=4,
              prefill_chunk=8, eos_id=2, mode_groups={m: 2 for m in MODES})
    if paged:
        kw.update(paged=True, page_size=8)
    return kw


def _same(got: list, want: list) -> None:
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            np.asarray(g["tokens"]),
            np.asarray(w["tokens"] if isinstance(w, dict) else w.tokens))
        np.testing.assert_allclose(
            g["logprobs"], w["logprobs"] if isinstance(w, dict)
            else w.logprobs, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,pagings,widths", [
    (JAMBA, (False, True), dict(heads=4, kv_heads=1, d_inner=256,
                                experts=2)),
    (RWKV, (False,), dict(rwkv_heads=1)),
    (VLM, (False, True), dict(heads=4, kv_heads=1, xattn_heads=4)),
], ids=["jamba", "rwkv", "vlm"])
def test_engine_on_the_mesh_matches_jax_unsharded(world, models, arch,
                                                  pagings, widths):
    jcfg, jp, model, _ = models(arch)
    jobs = [(p, MODES[i % 2]) for i, p in enumerate(_prompts())]
    jeng = JaxEngine(jp, jcfg, None, JaxEngineConfig(**_kw(False)))
    rids = [jeng.submit(np.asarray(q, np.int32), mode=m, arrival=float(i))
            for i, (q, m) in enumerate(jobs)]
    res = jeng.serve()
    want_jax = [res[int(r)] for r in rids]
    for paged in pagings:
        kw = _kw(paged)
        ref = mesh_runs.serve(model, kw, jobs, mesh=None)
        _same(ref["results"], want_jax)
        got = world.run(SERVE, model=model, engine=kw, jobs=jobs)
        for r in got:
            _same(r["results"], ref["results"])
            _same(r["results"], want_jax)
            assert r["widths"] == widths, r["widths"]
            assert r["local_slots"] == [n // 2 for n in r["global_slots"]]
            assert r["param_elems"] < ref["param_elems"]
        assert all(r["shard_stats"] == got[0]["shard_stats"] for r in got)


# ---------------------------------------------------------------------------
# 3. the CLI


def test_cli_serves_jamba_on_the_mesh():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.serve",
         "--arch", JAMBA, "--reduced", "--device", "cpu", "--mesh", "2",
         "2", "--paged", "--requests", "4", "--prompt-len", "16",
         "--max-new", "12", "--draft-len", "4", "--n-drafts", "4",
         "--page-size", "8"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    out = res.stdout
    assert res.returncode == 0, out + res.stderr
    assert "continuous == one-shot speculative: True" in out, out
    assert "mesh (2, 2), 2 data shards" in out, out
    assert "moe         : dropped fraction 0.0000" in out, out
    for r in range(4):
        assert (f"mesh widths : rank {r} {{'heads': 4, 'kv_heads': 1, "
                f"'d_inner': 256, 'experts': 2}}") in out, out
