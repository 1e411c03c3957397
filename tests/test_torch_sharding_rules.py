"""The port's sharding specs and sharded page accounting against the JAX
package's, in one process (no world of ranks):

- ``param_pspecs`` (``param_shardings`` with and without FSDP),
  ``serving_param_shardings`` and ``opt_shardings`` on every reduced arch
  of JAX's list and on the MT, with JAX's scan-repeat dim dropped, on a
  ``(2, 2)`` mesh and on ``(1, 16)`` (the divisibility fallback, JAX's
  mesh built as ``tests/test_launch.py`` builds it);
- ``cache_shardings``, ``batch_shardings`` and ``serving_state_shardings``
  on the same meshes;
- ``ShardedPageAllocator`` against JAX's on hypothesis op sequences, its
  two construction errors included;
- ``device_free_pages_by_shard`` and ``device_page_plan(shards=)`` against
  JAX's on drawn block tables, every plan field; ``apply_page_plan_segment``
  on each shard against JAX's ``apply_page_plan`` (the replicated tables,
  and the shard's pool segment page for page);
- ``kv_heads_for`` and ``shard_tensor``; ``activation_rules`` /
  ``constrain_activation`` against JAX's outside a mesh, and the port's
  identity under its rules.

A port spec is a tuple with one entry per dim; JAX's ``PartitionSpec`` is
padded with None to the leaf's rank before the comparison.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st  # noqa: E402
except ImportError:  # hermetic env: the in-repo fallback
    from repro.testing import given, settings, strategies as st  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.mt import product_config as jax_product  # noqa: E402
from repro.core import session as jsession  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.launch.mesh import make_serving_mesh as jax_mesh  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro.training.optimizer import adam_init as jax_adam  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.mt import product_config  # noqa: E402
from repro_torch.core import session as tsession  # noqa: E402
from repro_torch.launch import shardings as tsh  # noqa: E402
from repro_torch.launch.mesh import (MeshShape, data_shards,  # noqa: E402
                                     dp_axes, make_production_mesh)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import seq2seq as ts2s  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.sharding import ctx, rules  # noqa: E402
from repro_torch.training.optimizer import adam_init  # noqa: E402

ARCHS = [
    "command-r-35b", "qwen3-8b", "llama-3.2-vision-11b", "jamba-v0.1-52b",
    "llama4-maverick-400b-a17b", "starcoder2-15b", "smollm-135m",
    "rwkv6-1.6b", "phi3.5-moe-42b-a6.6b", "hubert-xlarge", "mt-product",
]
MESHES = {"2x2": (2, 2), "1x16": (1, 16)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jmesh(shape):
    if shape == (2, 2):
        return jax_mesh((2, 2))
    return Mesh(np.asarray(jax.devices() * 16)[:16].reshape(shape),
                ("data", "model"))


def tmesh(shape):
    return MeshShape(("data", "model"), shape)


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def jax_flat(tree):
    """{path: leaf} of a JAX tree (``PartitionSpec`` / ``NamedSharding``
    leaves kept whole)."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (P, jax.sharding.Sharding)))
    return {tuple(_key(k) for k in path): leaf for path, leaf in leaves}


def port_flat(params, specs):
    """{path: spec} of a port spec tree, walked along ``params``."""
    out = {}

    def one(path, leaf):
        s = specs
        for k in path:
            s = s[k]
        out[path] = tuple(s)
        return leaf

    rules.tree_map_with_path(one, params)
    return out


def norm(spec, ndim):
    spec = spec.spec if isinstance(spec, jax.sharding.Sharding) else spec
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def jax_to_port(jspecs, jshapes):
    """JAX's per-leaf specs laid out on the port's paths: a stacked layer
    group (``blocks``, ``enc_blocks``, ``dec_blocks``) becomes one entry a
    layer, its leading scan-repeat dim dropped."""
    out = {}
    for path, spec in jax_flat(jspecs).items():
        shape = jshapes[path].shape
        spec = norm(spec, len(shape))
        if path[0] == "blocks":
            for r in range(shape[0]):
                out[("blocks", path[1], r) + path[2:]] = spec[1:]
        elif path[0] in ("enc_blocks", "dec_blocks"):
            for r in range(shape[0]):
                out[(path[0], r) + path[1:]] = spec[1:]
        else:
            out[path] = spec
    return out


def models(arch):
    """(JAX cfg, JAX param shapes, port cfg, port params)."""
    if arch == "mt-product":
        jcfg, cfg = jax_product(), product_config()
        jp = jax.eval_shape(lambda: js2s.init(jax.random.PRNGKey(0), jcfg))
        pt = ts2s.init(torch.Generator().manual_seed(0), cfg, device="cpu")
        return jcfg, jp, cfg, pt
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jp = jax.eval_shape(lambda: jtr.init(jax.random.PRNGKey(0), jcfg))
    pt = ttr.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    return jcfg, jp, cfg, pt


# ---------------------------------------------------------------------------
# params


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch):
    jcfg, jp, cfg, pt = models(arch)
    jshapes = jax_flat(jp)
    for shape in MESHES.values():
        jm, tm = jmesh(shape), tmesh(shape)
        cases = {
            "tp": (jrules.param_pspecs(jp, jm),
                   rules.param_pspecs(pt, tm)),
            "fsdp": (jsh.param_shardings(jp, jm),
                     tsh.param_shardings(pt, tm)),
            "tp only": (jsh.param_shardings(jp, jm, fsdp=False),
                        tsh.param_shardings(pt, tm, fsdp=False)),
            "serving": (jsh.serving_param_shardings(jp, jcfg, jm),
                        tsh.serving_param_shardings(pt, cfg, tm)),
            "adam mu": (jsh.opt_shardings(jax.eval_shape(jax_adam, jp), jp,
                                          jm).mu,
                        tsh.opt_shardings(adam_init(pt), pt, tm).mu),
        }
        for name, (jspecs, tspecs) in cases.items():
            want = jax_to_port(jspecs, jshapes)
            got = port_flat(pt, tspecs)
            assert got == want, (name, shape,
                                 {k: (got.get(k), want.get(k))
                                  for k in set(got) | set(want)
                                  if got.get(k) != want.get(k)})
    # the serving layout splits whole heads only
    specs = tsh.serving_param_shardings(pt, cfg, tmesh((2, 2)))
    flat = port_flat(pt, specs)
    for path, spec in flat.items():
        if len(path) >= 2 and path[-2] == "wq" and cfg.n_heads % 2:
            assert rules.MODEL not in spec


def test_meshes_and_axes():
    prod, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert dp_axes(prod) == ("data",) and dp_axes(multi) == ("pod", "data")
    assert data_shards(prod) == 16 and data_shards(multi) == 32
    assert rules.axes_size(multi, ("pod", "data")) == 32
    assert rules.axis_sizes({"data": 2, "model": 2}) == {"data": 2,
                                                         "model": 2}


# ---------------------------------------------------------------------------
# caches, batches, a serving session's state


@pytest.mark.parametrize("shape", list(MESHES.values()), ids=list(MESHES))
def test_cache_and_batch_specs_match_jax(shape):
    jm, tm = jmesh(shape), tmesh(shape)
    for arch in ARCHS[:9]:
        jcfg = jax_get_config(arch, reduced=True)
        cfg = get_config(arch, reduced=True)
        jc = jax.eval_shape(lambda: jtr.init_cache(jcfg, 4, 32))
        tc = ttr.init_cache(cfg, 4, 32, device="meta")
        jsp, tsp = jsh.cache_shardings(jc, jcfg, jm), tsh.cache_shardings(
            tc, cfg, tm)
        for kind, j, t, c in zip(cfg.layer_pattern, jsp, tsp, tc):
            if isinstance(t, tattn.KVCache):
                for f in ("k", "v", "pos"):
                    assert getattr(t, f) == norm(
                        getattr(j, f), getattr(c, f).ndim), (arch, f)
            else:
                for f in t:
                    assert t[f] == norm(j[f], c[f].ndim), (arch, kind, f)
    batch = {"tokens": np.zeros((8, 12), np.int32),
             "lengths": np.zeros((8,), np.int32),
             "odd": np.zeros((3, 5), np.float32),
             "step": np.zeros((), np.int32)}
    jb = jsh.batch_shardings(batch, jm)
    tb = tsh.batch_shardings({k: torch.from_numpy(v) for k, v in
                              batch.items()}, tm)
    for k, v in batch.items():
        assert tb[k] == norm(jb[k], v.ndim), k


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_serving_state_specs_match_jax(paged):
    specs = (tsession.SessionSpec(n_slots=4, n_beams=1, n_drafts=3,
                                  draft_len=3, max_new=12, eos_id=2),
             tsession.SessionSpec(n_slots=2, n_beams=2, n_drafts=1,
                                  draft_len=0, max_new=12, eos_id=2))
    jspecs = tuple(jsession.SessionSpec(**s._asdict()) for s in specs)
    n_rows = sum(s.n_rows for s in specs)
    pg = (24, 8) if paged else None
    jcfg, cfg = jax_product(), product_config()
    lcfg = jax_get_config("qwen3-8b", reduced=True)
    tlcfg = get_config("qwen3-8b", reduced=True)
    for shape in MESHES.values():
        jm, tm = jmesh(shape), tmesh(shape)
        for jc, tc in (
                (jax.eval_shape(lambda: js2s.init_cache(
                    jcfg, n_rows, 20, memory_len=16, paged=pg)),
                 ts2s.init_cache(cfg, n_rows, 20, memory_len=16, paged=pg,
                                 device="meta")),
                (jax.eval_shape(lambda: jtr.init_cache(lcfg, n_rows, 20,
                                                       paged=pg)),
                 ttr.init_cache(tlcfg, n_rows, 20, paged=pg,
                                device="meta"))):
            jg = jax.eval_shape(lambda: jsession.grouped_init_state(
                jspecs, jc))
            tg = tsession.grouped_init_state(specs, tc)
            js = jsh.serving_state_shardings(jg, jm)
            ts = tsh.serving_state_shardings(tg, tm)
            for gj, gt, gs in zip(js.groups, ts.groups, tg.groups):
                for f in gs._fields:
                    if f == "cache":
                        continue
                    assert getattr(gt, f) == norm(
                        getattr(gj, f), getattr(gs, f).ndim), f
            want = jax_flat(js.cache)
            shapes = jax_flat(jc)

            def walk(node, spec, path=()):
                if isinstance(node, (tattn.KVCache, tattn.PagedKVCache)):
                    for f in node.__dataclass_fields__:
                        p = path + (f,)
                        assert getattr(spec, f) == norm(
                            want[p], len(shapes[p].shape)), p
                elif isinstance(node, dict):
                    for k in node:
                        walk(node[k], spec[k], path + (k,))
                elif isinstance(node, (tuple, list)):
                    for i, (n, s) in enumerate(zip(node, spec)):
                        walk(n, s, path + (i,))
                else:
                    assert spec == norm(want[path], node.ndim), path

            walk(tc, ts.cache)


# ---------------------------------------------------------------------------
# the sharded allocator


def _specs(draw_groups):
    out = {}
    for i, (kind, K, N_d, DL) in enumerate(draw_groups):
        out[f"g{i}"] = tsession.SessionSpec(
            n_slots=2, n_beams=K, n_drafts=N_d, draft_len=DL, max_new=10,
            eos_id=2, kind=kind)
    return out


def _first(e) -> str:
    """An error's message up to its explanation in parentheses."""
    return str(e).split(" (")[0]


_GROUPS = st.lists(st.sampled_from([("greedy", 1, 1, 0), ("greedy", 1, 3, 3),
                                    ("beam", 2, 1, 0), ("beam", 2, 2, 2)]),
                   min_size=1, max_size=3)


@settings(max_examples=25, deadline=None)
@given(_GROUPS, st.integers(1, 4), st.integers(2, 120), st.integers(2, 8),
       st.lists(st.tuples(st.integers(0, 3), st.integers(0, 200)),
                min_size=1, max_size=30))
def test_sharded_allocator_matches_jax(groups, n_shards, n_pages, ps, ops):
    tspecs = _specs(groups)
    jspecs = {k: jsession.SessionSpec(**s._asdict())
              for k, s in tspecs.items()}
    kw = dict(n_pages=n_pages, page_size=ps, n_shards=n_shards,
              prefill_blocks={k: 2 for k in tspecs})
    try:
        ja = jsession.ShardedPageAllocator(jspecs, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tsession.ShardedPageAllocator(tspecs, **kw)
        assert _first(got.value) == _first(e)
        return
    ta = tsession.ShardedPageAllocator(tspecs, **kw)
    assert ta.pages_per_shard == ja.pages_per_shard
    keys = list(tspecs)
    for op, x in ops:
        if op == 0:
            assert ta.shard_of_page(x % n_pages) == ja.shard_of_page(
                x % n_pages)
        elif op == 1:
            s = x % n_shards
            assert ta.shard_capacity(s) == ja.shard_capacity(s)
        elif op == 2:
            free = [(x * (s + 3)) % (ta.shard_capacity(s) + 1)
                    for s in range(n_shards)]
            ta.note_peak(free)
            ja.note_peak(free)
        else:
            k = keys[x % len(keys)]
            assert ta.admit_pages_for(k) == ja.admit_pages_for(k)
            assert list(ta.window_blocks(x, k)) == list(ja.window_blocks(x,
                                                                         k))
        assert ta.peak_pages_by_shard == ja.peak_pages_by_shard


def test_sharded_allocator_construction_errors():
    spec = {"g": tsession.SessionSpec(n_slots=2, n_beams=1, n_drafts=1,
                                      draft_len=0, max_new=10, eos_id=2)}
    jspec = {"g": jsession.SessionSpec(**spec["g"]._asdict())}
    for kw in (dict(n_pages=31, page_size=8, n_shards=2),   # indivisible
               dict(n_pages=4, page_size=2, n_shards=2)):   # shard 0 short
        with pytest.raises(ValueError) as je:
            jsession.ShardedPageAllocator(jspec, **kw)
        with pytest.raises(ValueError) as te:
            tsession.ShardedPageAllocator(spec, **kw)
        assert _first(te.value) == _first(je.value)


# ---------------------------------------------------------------------------
# the sharded page plan


def _plan_case(seed, n_sh=2):
    """Two groups over a paged cache, rows mapped to pages of their own
    shard's segment (shared within a slot, as winner sync leaves them), a
    few index rows pinning pages of every shard; some slots inactive."""
    rng = np.random.default_rng(seed)
    specs = (tsession.SessionSpec(n_slots=2, n_beams=1, n_drafts=1,
                                  draft_len=0, max_new=12, eos_id=1),
             tsession.SessionSpec(n_slots=2, n_beams=1, n_drafts=3,
                                  draft_len=3, max_new=12, eos_id=1))
    ps, P = 4, 36
    pps = P // n_sh
    n_rows = sum(s.n_rows for s in specs)
    n_index = 2
    nb = -(-max(s.cache_len for s in specs) // ps)
    row_shard = np.zeros((n_rows + n_index,), np.int32)
    lo = 0
    for spec in specs:
        per = spec.n_slots // n_sh
        for i in range(spec.n_slots):
            row_shard[lo + i * spec.rows_per_slot:
                      lo + (i + 1) * spec.rows_per_slot] = i // per
        lo += spec.n_rows
    pools = [list(rng.permutation(np.arange(max(1, s * pps), (s + 1) * pps)))
             for s in range(n_sh)]
    bt = np.full((n_rows + n_index, nb), -1, np.int32)
    for r in range(n_rows):
        for j in range(int(rng.integers(0, 3))):
            bt[r, j] = pools[row_shard[r]].pop()
    bt[3:5, :2] = bt[2, :2]       # slot 0's drafts share its row 0's pages
    for j in range(3):            # index cells pin a page of each shard
        bt[n_rows + j % n_index, j] = pools[j % n_sh].pop()
    pos = [rng.integers(0, 10, (2, 1)), rng.integers(0, 10, (2, 1))]
    active = [rng.random(2) < 0.8, rng.random(2) < 0.8]
    k_pool = rng.standard_normal((1, P, ps, 2, 4)).astype(np.float32)
    pos_pool = rng.integers(-1, 12, (1, P, ps)).astype(np.int32)
    blocks = tuple(-(-s.cache_len // ps) for s in specs)
    return dict(specs=specs, blocks=blocks, ps=ps, P=P, bt=bt, pos=pos,
                active=active, k_pool=k_pool, pos_pool=pos_pool,
                row_shard=row_shard, n_sh=n_sh, pps=pps)


def _states(c):
    jspecs = tuple(jsession.SessionSpec(**s._asdict()) for s in c["specs"])
    tcache = {"self": tattn.PagedKVCache(
        *(torch.from_numpy(a.copy()) for a in
          (c["k_pool"], c["k_pool"], c["pos_pool"], c["bt"][None])))}
    jcache = {"self": jattn.PagedKVCache(
        *(jnp.asarray(a) for a in
          (c["k_pool"], c["k_pool"], c["pos_pool"], c["bt"][None])))}
    tg = tsession.grouped_init_state(c["specs"], tcache)
    jg = jsession.grouped_init_state(jspecs, jcache)
    tg = tsession.GroupedState(groups=tuple(
        gs._replace(pos=torch.from_numpy(p.astype(np.int32)),
                    active=torch.from_numpy(a))
        for gs, p, a in zip(tg.groups, c["pos"], c["active"])), cache=tcache)
    jg = jsession.GroupedState(groups=tuple(
        gs._replace(pos=jnp.asarray(p, jnp.int32), active=jnp.asarray(a))
        for gs, p, a in zip(jg.groups, c["pos"], c["active"])), cache=jcache)
    return jspecs, tg, jg


@pytest.mark.parametrize("seed", range(6))
def test_sharded_page_plan_matches_jax(seed):
    c = _plan_case(seed)
    jspecs, tg, jg = _states(c)
    P, n_sh, pps = c["P"], c["n_sh"], c["pps"]
    np.testing.assert_array_equal(
        tsession.device_free_pages_by_shard(tg.cache, P, n_sh).numpy(),
        np.asarray(jsession.device_free_pages_by_shard(jg.cache, P, n_sh)))
    prefill = ((( [0, 1], torch.tensor([0, 4], dtype=torch.int32),
                  torch.tensor([4, 0], dtype=torch.int32), 4),
                ([2, 5], torch.tensor([8, 0], dtype=torch.int32),
                 torch.tensor([3, 2], dtype=torch.int32), 4))
               if seed % 2 else None)
    jpre = (None if prefill is None else tuple(
        (r, jnp.asarray(p.numpy()), jnp.asarray(n.numpy()), C)
        for r, p, n, C in prefill))
    pt = tsession.device_page_plan(c["specs"], c["blocks"], c["ps"], P, tg,
                                   prefill=prefill,
                                   shards=(n_sh, c["row_shard"]))
    pj = jsession.device_page_plan(jspecs, c["blocks"], c["ps"], P, jg,
                                   prefill=jpre,
                                   shards=(n_sh, c["row_shard"]))
    for f in ("exhausted", "n_free", "need_by_group", "rows", "blocks",
              "need", "copy", "cur", "need_by_shard", "n_free_by_shard",
              "exhausted_by_shard"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                      np.asarray(getattr(pj, f)), err_msg=f)
    need = pt.need.numpy()
    np.testing.assert_array_equal(pt.new.numpy()[need],
                                  np.asarray(pj.new)[need])
    if bool(pt.exhausted):
        return
    cj = jsession.apply_page_plan(jg.cache, pj)["self"]
    for shard in range(n_sh):
        tables = tattn.PagedKVCache(None, None, None,
                                    torch.from_numpy(c["bt"][None].copy()))
        lo = shard * pps
        seg = np.concatenate([np.zeros_like(c["k_pool"][:, :1]),
                              c["k_pool"][:, lo:lo + pps]], axis=1)
        spos = np.concatenate([np.full_like(c["pos_pool"][:, :1], -1),
                               c["pos_pool"][:, lo:lo + pps]], axis=1)
        pools = tattn.PagedKVCache(torch.from_numpy(seg.copy()),
                                   torch.from_numpy(seg.copy()),
                                   torch.from_numpy(spos.copy()),
                                   torch.zeros((1, 1, 1), dtype=torch.int32))
        mine = (pt.need & pt.copy
                & (tsession.segment_pages(pt.new, shard, pps) > 0))
        tsession.apply_page_plan_segment(tables, pools, pt, shard, pps,
                                         int(mine.sum()))
        np.testing.assert_array_equal(tables.block_tables.numpy(),
                                      np.asarray(cj.block_tables))
        keep = slice(1 + (shard == 0), None)   # JAX's trash page aside
        np.testing.assert_array_equal(
            pools.pos.numpy()[:, keep],
            np.asarray(cj.pos)[:, lo:lo + pps][:, keep.start - 1:])
        np.testing.assert_array_equal(
            pools.k_pool.numpy()[:, keep],
            np.asarray(cj.k_pool)[:, lo:lo + pps][:, keep.start - 1:])
        # the rank's view: its segment's pages at 1 .. pps, the rest -1
        g = torch.from_numpy(np.array(cj.block_tables)[0])
        local = tsession.segment_pages(g, shard, pps)
        back = tsession.global_pages(local, shard, pps).numpy()
        ours = (g.numpy() >= lo) & (g.numpy() < lo + pps)
        np.testing.assert_array_equal(back[ours], g.numpy()[ours])
        assert (local.numpy()[~ours] == -1).all()


# ---------------------------------------------------------------------------
# the tensor-parallel helpers


def test_kv_heads_and_tensor_shards():
    assert ctx.kv_heads_for(0, 9, 9, 3) == (0, 3)       # wq whole
    assert ctx.kv_heads_for(1, 4, 8, 2) == (1, 2)       # whole groups
    assert ctx.kv_heads_for(3, 2, 8, 2) == (1, 2)       # inside one group
    with pytest.raises(ValueError, match="equal groups"):
        ctx.kv_heads_for(0, 6, 12, 3)                   # 4 + 2 heads
    t = torch.arange(24.0).reshape(4, 6)
    for m in range(2):
        assert torch.equal(rules.shard_tensor(t, (None, "model"), "model",
                                              m, 2), t[:, 3 * m:3 * m + 3])
        assert torch.equal(rules.shard_tensor(t, ("model", None), "model",
                                              m, 2), t[2 * m:2 * m + 2])
    assert torch.equal(rules.shard_tensor(t, (None, None), "model", 1, 2), t)
    assert ctx.current() is None


def test_activation_rules_and_constraint():
    """Outside any rules both packages' constraint is the identity; the
    port's rules nest and restore like JAX's, and under them its
    constraint stays the identity (a rank holds its own rows already)."""
    from repro.sharding import ctx as jctx

    x = torch.arange(24.0).reshape(2, 3, 4)
    jx = jnp.asarray(x.numpy())
    assert jctx.constrain_activation(jx) is jx
    assert ctx.constrain_activation(x) is x
    mesh = MeshShape(("data", "model"), (2, 2))
    assert ctx._rules() is None and jctx._current() is None
    with ctx.activation_rules(mesh, batch=("data",), seq=("model",)):
        assert ctx._rules() == {"mesh": mesh, "batch": ("data",),
                                "seq": ("model",)}
        with ctx.activation_rules(mesh, batch=None):
            assert ctx._rules()["batch"] is None
            assert ctx.constrain_activation(x) is x
        assert ctx._rules()["seq"] == ("model",)
        assert ctx.constrain_activation(x) is x
    assert ctx._rules() is None
