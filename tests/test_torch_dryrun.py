"""The port's analysis tooling (``repro_torch.launch.{hlo_analysis,
dryrun}``, the kernels' meta branches and the recording
``TensorParallel``) against the JAX package's and against shape formulas:

- ``collective_bytes`` and ``roofline_terms`` on ``tests/test_launch.py``'s
  collective and bottleneck cases, in the record form and at the H100's
  data-sheet rates (no TPU figure); ``model_flops`` and ``count_params``
  equal JAX's for every arch (JAX's params from ``jax.eval_shape``, the
  port's on meta);
- ``count_cost``: a small dense step's flops and bytes equal their
  analytic counts; each kernel's meta record equals its shape formula; a
  shape-only init equals the real init's leaf shapes;
- the recorder's model-axis collectives for one ``decode_step`` on a
  (1, 2) mesh equal ``n_collectives`` of the same step on a 2-rank CPU
  ``World``;
- ``run_one`` on the (16, 16) production ``MeshShape``: ok for SmolLM's
  decode_32k (also verify 11 and multi-draft 5), Qwen3-8B's long_500k
  (window 8192) and mt-product's mt_verify, JAX's skip reason for
  HuBERT's decode_32k; its ``params_total`` / ``params_expert`` equal the
  counts of JAX's ``eval_shape`` params and its ``argument_bytes`` the
  per-device shard sizes of JAX's specs (``NamedSharding.shard_shape`` on
  a 256-device mesh of repeated host devices). ``--seq-shard`` is
  held in ``tests/test_torch_seq_shard.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import (decode_gqa_attention,  # noqa: E402
                                 draft_verify, flash_attention_bshd,
                                 paged_decode_gqa_attention)
from repro_torch.launch import dryrun, hlo_analysis as hlo  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.launch.shardings import (lay_out_params,  # noqa: E402
                                          local_cache_cfg)
from repro_torch.models import seq2seq as ts2s  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.sharding import ctx  # noqa: E402

META = dict(device="meta")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, **META)


# ---------------------------------------------------------------------------
# hlo_analysis


def test_collective_bytes_from_records():
    records = [("all-gather", 16 * 512 * 2), ("all-reduce", 256 * 4),
               ("reduce-scatter", 32 * 128 * 4),   # the operand, the larger
               ("collective-permute", 16)]
    got = hlo.collective_bytes(records)
    assert got["all-gather"] == 16 * 512 * 2
    assert got["all-reduce"] == 256 * 4
    assert got["reduce-scatter"] == 32 * 128 * 4
    assert got["collective-permute"] == 16
    assert got["total"] == sum(got[k] for k in
                               ("all-gather", "all-reduce", "reduce-scatter",
                                "all-to-all", "collective-permute"))
    assert got["counts"] == {"all-gather": 1, "all-reduce": 1,
                             "reduce-scatter": 1, "all-to-all": 0,
                             "collective-permute": 1}
    with pytest.raises(ValueError, match="unknown collective"):
        hlo.collective_bytes([("broadcast", 4)])


def test_roofline_terms_bottleneck():
    cost = {"flops": hlo.BF16_FLOPS * 2.0, "bytes accessed": hlo.HBM_BW * 0.5}
    t = hlo.roofline_terms(cost, [])
    assert abs(t["compute_s"] - 2.0) < 1e-9
    assert t["bottleneck"] == "compute"
    assert set(t) == set(jhlo.roofline_terms(
        {"flops": 1.0, "bytes accessed": 1.0}, ""))
    # the peak follows the dtype: fp32 without TF32 on the CUDA cores
    t32 = hlo.roofline_terms({"flops": hlo.FP32_FLOPS}, [],
                             dtype=torch.float32)
    assert abs(t32["compute_s"] - 1.0) < 1e-9
    t = hlo.roofline_terms({"flops": 1.0, "bytes accessed": 3 * hlo.HBM_BW},
                           [("all-reduce", hlo.NVLINK_BW)])
    assert t["bottleneck"] == "memory" and t["collective_s"] == 1.0


def test_trace_roofline_flags_a_share_above_one():
    """Two device kernels of 1 ms each over a 4 ms span: busy 0.5; a
    memory term of 3 ms over 2 ms of kernels is no result (its count is
    wrong) and is flagged, not reported as achieved."""
    from types import SimpleNamespace as NS

    def event(start, end, device="DeviceType.CUDA"):
        return NS(device_type=device, time_range=NS(
            start=start, end=end, elapsed_us=lambda: end - start))

    prof = NS(events=lambda: [event(0, 1000), event(3000, 4000),
                              event(0, 9000, "DeviceType.CPU")])
    terms = dict(compute_s=1e-3, memory_s=3e-3, collective_s=0.0)
    tr_ = hlo.trace_roofline(prof, terms)
    assert (tr_["kernel_ms"], tr_["span_ms"], tr_["busy"],
            tr_["n_kernels"]) == (2.0, 4.0, 0.5, 2)
    assert tr_["achieved"] == dict(compute=0.5, memory=None, collective=0.0)
    assert tr_["over"] == dict(memory=1.5)


def test_card_constants_not_tpu():
    assert (hlo.BF16_FLOPS, hlo.FP32_FLOPS, hlo.HBM_BW) == (
        989.4e12, 66.9e12, 3.35e12)
    assert hlo.NVLINK_BW == 450e9
    assert not {197e12, 819e9, 50e9} & {hlo.BF16_FLOPS, hlo.FP32_FLOPS,
                                        hlo.HBM_BW, hlo.NVLINK_BW}


def _jax_params(cfg):
    if cfg.family == "seq2seq":
        return jax.eval_shape(lambda: js2s.init(jax.random.PRNGKey(0), cfg))
    return jax.eval_shape(lambda: jtr.init(jax.random.PRNGKey(0), cfg))


def _port_params(cfg):
    if cfg.family == "seq2seq":
        return ts2s.init(None, cfg, device="meta")
    return tr.init(None, cfg, device="meta")


@pytest.mark.parametrize("arch", list_archs())
def test_count_params_and_model_flops_equal_jax(arch):
    tcfg, jcfg = get_config(arch), jax_get_config(arch)
    total, active = hlo.count_params(_port_params(tcfg))
    assert (total, active) == jhlo.count_params(_jax_params(jcfg))
    expert = total // 3
    kw = dict(tokens=4096, train=True, top_k=2, n_experts=16)
    assert hlo.model_flops(tcfg, total, expert, **kw) == \
        jhlo.model_flops(jcfg, total, expert, **kw)


@pytest.mark.parametrize("arch", ["smollm-135m", "jamba-v0.1-52b",
                                  "rwkv6-1.6b", "llama-3.2-vision-11b",
                                  "phi3.5-moe-42b-a6.6b", "mt-product"])
def test_meta_init_leaf_shapes_equal_real_init(arch):
    cfg = get_config(arch, reduced=True)
    init = ts2s.init if cfg.family == "seq2seq" else tr.init
    real = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    meta = init(None, cfg, device="meta")
    flat = []
    for tree in (real, meta):
        out = []
        steps._map_named(tree, lambda t, _: out.append(
            (tuple(t.shape), t.dtype)) or t)
        flat.append(out)
    assert flat[0] == flat[1]
    devices = set()
    steps._map_named(meta, lambda t, _: devices.add(t.device.type) or t)
    assert devices == {"meta"}


# ---------------------------------------------------------------------------
# counting


def test_count_cost_small_dense_step():
    B, d, h = 8, 32, 64

    def step(x, w1, w2):
        return torch.relu(x @ w1) @ w2

    cost, out = hlo.count_cost(step, _meta(B, d), _meta(d, h), _meta(h, d))
    assert tuple(out.shape) == (B, d)
    assert cost["flops"] == 2 * B * d * h + 2 * B * h * d
    f = 4   # fp32 bytes: mm reads x, w1 and writes x@w1; relu; mm
    assert cost["bytes accessed"] == f * ((B * d + d * h + B * h)
                                          + 2 * B * h
                                          + (B * h + h * d + B * d))
    # x @ w1 and its relu live together, then the relu and the output
    assert cost["temp_bytes"] == f * max(2 * B * h, B * h + B * d)
    assert cost["kernels"] == {}


def test_kernel_meta_records_equal_shape_formulas():
    B, T, H, Kv, S, hd, V = 2, 3, 4, 2, 40, 16, 50
    P, ps, nb = 9, 8, 5

    def call():
        decode_gqa_attention(_meta(B, T, H, hd), _meta(B, S, Kv, hd),
                             _meta(B, S, Kv, hd),
                             _meta(B, S, dtype=torch.int32),
                             _meta(B, T, dtype=torch.int32))
        paged_decode_gqa_attention(
            _meta(B, T, H, hd), _meta(P, ps, Kv, hd), _meta(P, ps, Kv, hd),
            _meta(P, ps, dtype=torch.int32),
            _meta(B, nb, dtype=torch.int32), _meta(B, T, dtype=torch.int32))
        draft_verify(_meta(B, T, V), _meta(B, T - 1, dtype=torch.int32),
                     _meta(B, dtype=torch.bool))
        q = _meta(B, S, H, hd).requires_grad_(True)
        k = _meta(B, S, Kv, hd).requires_grad_(True)
        out = flash_attention_bshd(q, k, k, causal=True)
        out.sum().backward()

    cost, _ = hlo.count_cost(call)
    got = cost["kernels"]
    f = 4
    assert got["decode_gqa"] == dict(
        launches=1, flops=4 * hd * H * B * T * S,
        bytes=2 * B * S * Kv * hd * f + 2 * B * T * H * hd * f
        + B * S * 4 + B * T * 4)
    keys = B * nb * ps
    assert got["paged_decode_gqa"] == dict(
        launches=1, flops=4 * hd * H * T * keys,
        bytes=2 * keys * Kv * hd * f + 2 * B * T * H * hd * f + keys * 4
        + B * nb * 4 + B * T * 4)
    assert got["draft_verify"] == dict(
        launches=1, flops=B * T * V,
        bytes=B * T * V * f + B * (T - 1) * 4 + B + (B * T + B) * 4)
    pairs = B * H * S * (S + 1) // 2
    rows, kv = B * S * H * hd, B * S * Kv * hd
    assert got["flash_attention"] == dict(
        launches=1, flops=4 * hd * pairs,
        bytes=(2 * rows + 2 * kv) * f + B * H * S * 4)
    assert got["flash_attention_bwd"] == dict(
        launches=1, flops=10 * hd * pairs,
        bytes=(4 * rows + 4 * kv) * f + B * H * S * 4)


def test_count_cost_writes_only_the_cache_rows_fed():
    """An in-place scatter moves its values, indices and the region it
    writes: a decode step's bytes grow with the cache length only by the
    kernel's cache read (K, V and the stored positions of every slot), not
    by its cache writes, which move T rows a layer."""
    cfg = get_config("smollm-135m", reduced=True)
    B, T = 2, 3
    params = tr.init(None, cfg, device="meta")

    def step_bytes(S):
        cache = tr.init_cache(cfg, B, S, device="meta")
        tok, pos = (_meta(B, T, dtype=torch.int32) for _ in range(2))
        with torch.no_grad():
            cost, _ = hlo.count_cost(
                lambda: tr.decode_step(params, cfg, cache, tok, pos))
        return cost

    small, big = step_bytes(64), step_bytes(64 + 40)
    layers = cfg.n_layers
    Kv, hd = cfg.n_kv_heads, cfg.head_dim
    read = 40 * B * (2 * Kv * hd * 4 + 4)      # K, V, stored position
    assert big["bytes accessed"] - small["bytes accessed"] == layers * read
    assert (big["kernels"]["decode_gqa"]["bytes"]
            - small["kernels"]["decode_gqa"]["bytes"]) == layers * read

    # one layer's write on its own, at two cache lengths: the values and
    # the indices read once, the rows fed written once
    from repro_torch.models.attention import _write_cache, init_kv_cache

    kv, pos = _meta(B, T, Kv, hd), _meta(B, T, dtype=torch.int32)
    rows, idx, p32 = B * T * Kv * hd * 4, B * 8 + B * T * 8, B * T * 4
    for S in (64, 1000):
        cost, _ = hlo.count_cost(_write_cache,
                                 init_kv_cache(cfg, B, S, device="meta"),
                                 kv, kv, pos)
        # arange; positions % S; .long(); the K, V and position writes
        assert cost["bytes accessed"] == (B * 8 + 2 * p32 + 3 * p32
                                          + 2 * (idx + 2 * rows)
                                          + idx + 2 * p32)


def test_recorder_counts_equal_a_world_of_two_ranks():
    from repro_torch.launch.world import World

    cfg = get_config("smollm-135m", reduced=True)
    B, T, S = 2, 3, 16
    rng = np.random.default_rng(0)
    tokens = rng.integers(4, cfg.vocab_size, (B, T)).astype(np.int32)
    positions = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    with World(2, device="cpu") as w:
        live = w.run("repro_torch.launch.mesh_runs:step_collectives",
                     model=dict(family="lm", cfg=cfg, seed=0), tokens=tokens,
                     positions=positions, cache_len=S, mesh=(1, 2),
                     on_card=False)
    mesh = MeshShape(("data", "model"), (1, 2))
    tp = ctx.recording_tensor_parallel(mesh)
    params = lay_out_params(tr.init(None, cfg, device="meta"), cfg, mesh, tp,
                            "meta")
    cache = tr.init_cache(local_cache_cfg(cfg, tp), B, S,
                          device="meta", widths=tr.local_widths(params, cfg))
    with torch.no_grad(), ctx.tensor_parallel(tp):
        tr.decode_step(params, cfg, cache, _meta(B, T, dtype=torch.int32),
                       _meta(B, T, dtype=torch.int32))
    assert live == [tp.n_collectives] * 2
    assert len(tp.records) == tp.n_collectives > 0
    assert {k for k, _ in tp.records} == {"all-reduce"}


def test_recorder_records_the_conjugate_in_a_backward():
    """A forward sum's backward is the identity; the conjugate of a tensor
    held whole entering the rank's own computation (``ctx.enter``) is
    recorded in the backward, where the live context issues it."""
    mesh = MeshShape(("data", "model"), (2, 4))
    tp = ctx.recording_tensor_parallel(mesh)
    assert (tp.size, tp.data_size, tp.group) == (4, 2, None)
    x = _meta(3, 5).requires_grad_(True)
    with ctx.tensor_parallel(tp):
        y = ctx.model_sum(ctx.enter(x) * 2)
        prefix, total, n = ctx.data_prefix_counts(
            _meta(6, dtype=torch.int64), 10)
    assert n == 20 and tuple(total.shape) == (6,)
    y.sum().backward()
    assert tp.records == [("all-reduce", 60), ("all-reduce", 2 * 7 * 8),
                          ("all-reduce", 60)]
    assert (tp.n_collectives, tp.n_data_collectives) == (2, 1)


# ---------------------------------------------------------------------------
# the dry run


def _jax_mesh():
    return Mesh(np.asarray(jax.devices() * 256)[:256].reshape(16, 16),
                ("data", "model"))


def _jax_argument_bytes(arch, shape, **kw) -> tuple[int, int, int]:
    """(argument bytes a device holds, params, expert params) from JAX's
    step at full size on the (16, 16) mesh."""
    b = jsteps.build_step(arch, shape, _jax_mesh(), **kw)
    leaves = jax.tree_util.tree_leaves(b.inputs)
    shards = jax.tree_util.tree_leaves(
        b.in_shardings, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    assert len(leaves) == len(shards)
    nbytes = sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
                 for x, s in zip(leaves, shards))
    total = expert = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(b.inputs[0])[0]:
        n = int(np.prod(leaf.shape))
        total += n
        if "experts" in [str(getattr(k, "key", k)) for k in path]:
            expert += n
    return nbytes, total, expert


RUNS = [("smollm-135m", "train_4k", {}),
        ("qwen3-8b", "train_4k", {}),
        ("mt-product", "mt_train", {}),
        ("smollm-135m", "decode_32k", {}),
        ("smollm-135m", "decode_32k", dict(verify_tokens=11)),
        ("smollm-135m", "decode_32k", dict(verify_tokens=11, multidraft=5)),
        ("qwen3-8b", "long_500k", {}),
        ("mt-product", "mt_verify", {}),
        ("rwkv6-1.6b", "prefill_32k", {})]


@pytest.mark.parametrize("case", RUNS, ids=[f"{a}-{s}-{len(k)}"
                                            for a, s, k in RUNS])
def test_run_one_on_the_production_mesh(case):
    arch, shape, kw = case
    rec = dryrun.run_one(arch, shape, multi_pod=False, verbose=False, **kw)
    assert rec["status"] == "ok", rec.get("traceback")
    for key in ("arch", "shape", "mesh", "seq_shard", "fsdp_inference",
                "verify_tokens", "multidraft", "note", "compile_s",
                "params_total", "params_expert", "memory", "roofline",
                "model_flops_total", "hlo_flops_total",
                "useful_flops_ratio"):
        assert key in rec, key
    r = rec["roofline"]
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    nbytes, total, expert = _jax_argument_bytes(arch, shape, **kw)
    assert (rec["params_total"], rec["params_expert"]) == (total, expert)
    if "train" in shape:   # JAX's Adam step is an int32 on the device, the
        nbytes -= 4        # port's a host int
    assert rec["memory"]["argument_bytes"] == nbytes
    if shape == "long_500k":
        assert "window=8192" in rec["note"]


def test_short_recurrences_run_two_steps_and_restore():
    """The dry run's recurrent loops run their first two tokens, the last
    output standing for the rest; the models' loops come back on exit."""
    from repro_torch.models import mamba, rwkv

    rng = np.random.default_rng(0)
    B, T, H, hd, di, ds = 2, 6, 2, 4, 5, 3

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    r, k, v, u = t(B, T, H, hd), t(B, T, H, hd), t(B, T, H, hd), t(1, H, hd, 1)
    decay, S0 = torch.sigmoid(t(B, T, H, hd)), t(B, H, hd, hd)
    a, b, C = torch.sigmoid(t(B, T, di, ds)), t(B, T, di, ds), t(B, T, ds)
    wkv, scan = rwkv._wkv_recurrence, mamba._recurrence
    o_full, _ = wkv(r, k, v, decay, u, S0)
    y_full, _ = scan(a, b, C)
    _, S2 = wkv(r[:, :2], k[:, :2], v[:, :2], decay[:, :2], u, S0)
    _, h2 = scan(a[:, :2], b[:, :2], C[:, :2])
    with dryrun.short_recurrences():
        o, S = rwkv._wkv_recurrence(r, k, v, decay, u, S0)
        y, h = mamba._recurrence(a, b, C)
    assert (rwkv._wkv_recurrence, mamba._recurrence) == (wkv, scan)
    for got, full, state, want in ((o, o_full, S, S2), (y, y_full, h, h2)):
        assert got.shape == full.shape
        torch.testing.assert_close(got[:, :2], full[:, :2], rtol=0, atol=0)
        torch.testing.assert_close(
            got[:, 2:], got[:, 1:2].expand_as(got[:, 2:]), rtol=0, atol=0)
        torch.testing.assert_close(state, want, rtol=0, atol=0)


def test_run_one_skips_with_jax_reason():
    rec = dryrun.run_one("hubert-xlarge", "decode_32k", multi_pod=False)
    assert rec["status"] == "skipped"
    assert rec["reason"] == jsteps.skip_reason("hubert-xlarge", "decode_32k")


def test_moe_dryrun_counts_router_collectives():
    """Phi-3.5-MoE's verify pass on the production mesh: its experts split
    over the model axis, its router's global counts over the data axis
    (one record an MoE layer, with no host read on meta)."""
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"), n_layers=1)
    b = steps.build_step("phi3.5-moe-42b-a6.6b", "decode_32k",
                         MeshShape(("data", "model"), (16, 16)),
                         cfg_override=cfg, verify_tokens=11)
    b.fn(*b.local_inputs)
    assert b.tp.n_data_collectives == 1
    assert b.local_inputs[0]["blocks"][0][0]["ffn"]["experts"]["w_in"][
        "w"].shape[0] == 1
