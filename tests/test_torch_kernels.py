"""The port's kernels against the JAX package's (``decode_gqa``, its paged
variant ``paged_decode_gqa``, ``draft_verify``, ``flash_attention`` with
the port's backward).

On the CPU the port's wrappers run their plain versions; these are held to
the JAX Pallas kernels (``interpret=True``, as ``tests/test_kernels.py``
runs them) and to their JAX oracles, on inputs made from a seed with numpy
and fed to both packages (the sweeps and builders of
``repro_torch.kernels.cases``, which ``chip_smoke.py`` uses too). Tolerances: 2e-5 in fp32 and 2e-2 in bf16 (the
reduction order differs between the packages), exact for ``draft_verify``.

The kernel-vs-plain cases need the card: they carry the ``gpu`` marker and
skip here. The card's machine has no JAX, so this module imports JAX and
the JAX package only inside the tests that compare with them; run the card
cases there with
``PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_kernels.py``
(``chip_smoke.py`` makes the same comparisons).
"""

import sys
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.session import _accept_lengths  # noqa: E402
from repro_torch.kernels import (decode_gqa_attention, draft_verify,  # noqa: E402
                                 flash_attention, flash_attention_bshd,
                                 paged_decode_gqa_attention)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cases import (  # noqa: E402
    DECODE_CARD_ONLY, DECODE_LM, DECODE_MOE, DECODE_SWEEP, FLASH_GQA,
    FLASH_MASKS, FLASH_PLAIN_LOADS, FLASH_SWEEP, PAGED_ALIASED,
    PAGED_CARD_ONLY, PAGED_LM, PAGED_MOE, PAGED_SWEEP,
    VERIFY_CARD_ONLY, VERIFY_LM, VERIFY_SWEEP, aliased_paged_inputs,
    decode_inputs, flash_inputs, paged_inputs, permuted_positions,
    ragged_lengths, ring_inputs, verify_inputs)
from repro_torch.kernels.decode_gqa import kernel as decode_kernel  # noqa: E402
from repro_torch.kernels.draft_verify import kernel as verify_kernel  # noqa: E402
from repro_torch.kernels.decode_gqa.ref import (  # noqa: E402
    decode_gqa_ref, paged_decode_gqa_ref)
from repro_torch.kernels.draft_verify.ref import draft_verify_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref, visible_mask)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def jx():
    """The JAX package's kernels and oracles (imported only where used)."""
    jax = pytest.importorskip("jax")
    from repro.kernels.decode_gqa.ops import (decode_gqa_attention,
                                              paged_decode_gqa_attention)
    from repro.kernels.decode_gqa.ref import (decode_gqa_ref,
                                              paged_decode_gqa_ref)
    from repro.kernels.draft_verify.ops import draft_verify
    from repro.kernels.draft_verify.ref import draft_verify_ref
    from repro.kernels.flash_attention.ops import flash_attention
    from repro.kernels.flash_attention.ref import flash_attention_ref
    return dict(jax=jax, jnp=jax.numpy, decode=decode_gqa_attention,
                decode_ref=decode_gqa_ref, paged=paged_decode_gqa_attention,
                paged_ref=paged_decode_gqa_ref, verify=draft_verify,
                verify_ref=draft_verify_ref, flash=flash_attention,
                flash_ref=flash_attention_ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run chip_smoke.py on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype("float32"))


def _decode_inputs(cfg):
    return decode_inputs(*(cfg[k] for k in ("B", "T", "H", "Kv", "S", "hd")))


def _torch(arrays, dtype):
    """numpy inputs as torch tensors (floats in ``dtype``)."""
    return [torch.from_numpy(a).to(TDT[dtype]) if a.dtype == np.float32
            else torch.from_numpy(a) for a in arrays]


def _both(jx, arrays, dtype):
    """The same numpy inputs as JAX and torch arrays (floats in ``dtype``)."""
    jnp = jx["jnp"]
    return ([jnp.asarray(a, getattr(jnp, dtype)) if a.dtype == np.float32
             else jnp.asarray(a) for a in arrays], _torch(arrays, dtype))


@pytest.mark.parametrize("cfg", DECODE_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_gqa_plain_matches_jax(jx, cfg, dtype):
    (jq, jk, jv, jkp, jqp), (tq, tk, tv, tkp, tqp) = _both(
        jx, _decode_inputs(cfg), dtype)
    w = cfg["window"]
    out = decode_gqa_attention(tq, tk, tv, tkp, tqp, window=w)
    assert out.dtype == TDT[dtype] and out.shape == tq.shape
    for ref in (jx["decode"](jq, jk, jv, jkp, jqp, window=w, bk=32),
                jx["decode_ref"](jq, jk, jv, jkp, jqp, window=w)):
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=TOL[dtype],
                                   rtol=TOL[dtype])


def test_decode_gqa_ring_buffer_plain_matches_jax(jx):
    (jq, jk, jv, jkp, jqp), (tq, tk, tv, tkp, tqp) = _both(
        jx, ring_inputs(), "float32")
    out = decode_gqa_attention(tq, tk, tv, tkp, tqp, window=32)
    ref = jx["decode"](jq, jk, jv, jkp, jqp, window=32, bk=32)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-5, rtol=2e-5)


def test_decode_gqa_fully_masked_row_is_zero(jx):
    """A query with no visible key outputs 0, as the JAX oracle does."""
    q, kc, vc, k_pos, q_pos = _decode_inputs(DECODE_SWEEP[0])
    q_pos[0, 0] = -1
    (jq, jk, jv, jkp, jqp), (tq, tk, tv, tkp, tqp) = _both(
        jx, (q, kc, vc, k_pos, q_pos), "float32")
    out = decode_gqa_attention(tq, tk, tv, tkp, tqp)
    assert not out[0, 0].any()
    np.testing.assert_allclose(_f32(out), _f32(jx["decode_ref"](
        jq, jk, jv, jkp, jqp)), atol=2e-5, rtol=2e-5)


PAGED_KEYS = ("B", "T", "H", "Kv", "P", "ps", "nb", "hd")


def _paged_inputs(cfg):
    return paged_inputs(*(cfg[k] for k in PAGED_KEYS))


@pytest.mark.parametrize("cfg", PAGED_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_gqa_plain_matches_jax(jx, cfg, dtype):
    """Unmapped blocks, ragged page fills, a window and MQA: the port's
    plain paged read against the JAX Pallas kernel (interpret mode) and the
    JAX oracle."""
    jargs, targs = _both(jx, _paged_inputs(cfg), dtype)
    w = cfg["window"]
    out = paged_decode_gqa_attention(*targs, window=w)
    assert out.dtype == TDT[dtype] and out.shape == targs[0].shape
    for ref in (jx["paged"](*jargs, window=w, interpret=True),
                jx["paged_ref"](*jargs, window=w)):
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=TOL[dtype],
                                   rtol=TOL[dtype])


def test_paged_decode_gqa_matches_dense():
    """A paged cache holding the same tokens as a dense row attends
    identically (the case of the JAX package's paged == dense kernel test):
    dense rows scattered into a shuffled pool whose page 0 is the trash."""
    B, T, H, Kv, hd, ps, nb = 2, 4, 8, 2, 32, 8, 4
    S, L = ps * nb, 19
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, T, H, hd), np.float32)
    kc = rng.standard_normal((B, S, Kv, hd), np.float32)
    vc = rng.standard_normal((B, S, Kv, hd), np.float32)
    k_pos = np.where(np.arange(S)[None] < L, np.arange(S)[None], -1).repeat(
        B, 0).astype(np.int32)
    q_pos = (L - 1 + np.arange(T))[None].repeat(B, 0).astype(np.int32)
    bt = rng.permutation(np.arange(1, B * nb + 1)).reshape(B, nb).astype(
        np.int32)
    P = B * nb + 1
    k_pool = np.zeros((P, ps, Kv, hd), np.float32)
    v_pool = np.zeros((P, ps, Kv, hd), np.float32)
    pos_pool = np.full((P, ps), -1, np.int32)
    k_pool[bt.reshape(-1)] = kc.reshape(B * nb, ps, Kv, hd)
    v_pool[bt.reshape(-1)] = vc.reshape(B * nb, ps, Kv, hd)
    pos_pool[bt.reshape(-1)] = k_pos.reshape(B * nb, ps)
    t = [torch.from_numpy(a) for a in (q, kc, vc, k_pos, q_pos, k_pool,
                                       v_pool, pos_pool, bt)]
    dense = decode_gqa_attention(*t[:5])
    paged = paged_decode_gqa_attention(t[0], t[5], t[6], t[7], t[8], t[4])
    np.testing.assert_allclose(paged.numpy(), dense.numpy(), atol=2e-5,
                               rtol=2e-5)


def _aliased_inputs(cfg):
    return aliased_paged_inputs(*(cfg[k] for k in (
        "B", "T", "H", "Kv", "ps", "nb", "hd", "n_shared", "n_private")))


@pytest.mark.parametrize("name", list(PAGED_ALIASED))
def test_paged_decode_gqa_aliased_table_plain_matches_jax(jx, name):
    """Rows whose leading blocks alias the same pages (a prefix served
    from the radix page cache): the port's plain paged read against the
    JAX oracle, at the prefix-sharing phase's shapes."""
    jargs, targs = _both(jx, _aliased_inputs(PAGED_ALIASED[name]), "float32")
    out = paged_decode_gqa_attention(*targs)
    np.testing.assert_allclose(_f32(out), _f32(jx["paged_ref"](*jargs)),
                               atol=2e-5, rtol=2e-5)


def test_paged_decode_gqa_inactive_row_is_zero():
    """An inactive streaming row (every query at -1, its table all -1)
    returns 0 with no NaN, beside rows that still attend."""
    arrays = list(_paged_inputs(PAGED_SWEEP[0]))
    arrays[4][0] = -1
    arrays[5][0] = -1
    out = paged_decode_gqa_attention(*(torch.from_numpy(a) for a in arrays))
    assert torch.isfinite(out).all()
    assert not out[0].any() and out[1].abs().sum() > 0


def test_paged_wrapper_refuses_other_devices_and_bad_shapes():
    x = [torch.from_numpy(a) for a in _paged_inputs(PAGED_SWEEP[0])]
    with pytest.raises(ValueError):
        paged_decode_gqa_attention(*(t.to("meta") for t in x))
    with pytest.raises(ValueError):
        paged_decode_gqa_attention(*x[:4], x[4][:1], x[5])
    with pytest.raises(ValueError):
        paged_decode_gqa_attention(*x[:3], x[3][:, :-1], *x[4:])


def _assert_verify_matches_jax(jx, logits, drafts, mask):
    t_tok, t_acc = draft_verify(torch.from_numpy(logits),
                                torch.from_numpy(drafts),
                                torch.from_numpy(mask))
    assert t_tok.dtype == torch.int32 and t_acc.dtype == torch.int32
    jl, jd, jm = (jx["jnp"].asarray(a) for a in (logits, drafts, mask))
    for j_tok, j_acc in (jx["verify"](jl, jd, jm, bv=128),
                         jx["verify_ref"](jl, jd, jm)):
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
        np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))


@pytest.mark.parametrize("N,T,V", VERIFY_SWEEP)
def test_draft_verify_plain_matches_jax(jx, N, T, V):
    _assert_verify_matches_jax(jx, *verify_inputs(N, T, V))


def test_draft_verify_ties_first_index_wins(jx):
    """Exact ties across the vocab (in one and in different 128-wide JAX
    tiles) go to the lowest index, in both packages."""
    N, T, V = 4, 3, 300
    logits, drafts, mask = verify_inputs(N, T, V, seed=9)
    logits[0, 0, [5, 7, 250]] = 100.0       # tie inside / across tiles
    logits[1, :, :] = 0.0                   # a whole row tied
    logits[2, 1, [129, 130]] = 7.5
    logits[3, 2, [0, 299]] = 9.0
    drafts[:, 0] = [5, 0, 1, 2]             # accept through the tie
    mask[:] = True
    _assert_verify_matches_jax(jx, logits, drafts, mask)
    tok, _ = draft_verify_ref(torch.from_numpy(logits),
                              torch.from_numpy(drafts), torch.from_numpy(mask))
    assert tok[0, 0] == 5 and tok[1].tolist() == [0, 0, 0]
    assert tok[2, 1] == 129 and tok[3, 2] == 0


def test_draft_verify_long_drafts_match_jax(jx):
    """T 40 (DL 39): positions past one warp's 32 lanes, and an accepted
    prefix past 32 drafts (the last row matches its first 35)."""
    _assert_verify_matches_jax(jx, *verify_inputs(6, 40, 27))
    logits, drafts, mask = verify_inputs(5, 40, 320, special=True)
    logits[-1] = np.random.default_rng(0).standard_normal((40, 320))
    drafts[-1] = logits[-1, :39].argmax(-1)
    drafts[-1, 35] = (drafts[-1, 35] + 1) % 320
    _assert_verify_matches_jax(jx, logits, drafts, mask)
    _, acc = draft_verify(*(torch.from_numpy(a) for a in (logits, drafts,
                                                          mask)))
    assert acc[-1] == 35


@pytest.mark.parametrize("N,T,V", [(3, 5, 27), (2, 40, 27), (2, 11, 300)])
def test_draft_verify_nan_and_inf_rows_match_jax_ref(jx, N, T, V):
    """NaN is above every number and the first NaN wins; a row of nothing
    but -inf gives index 0; the first of two +inf wins: the port's plain
    version gives what JAX's ``draft_verify_ref`` (jnp.argmax, the JAX
    main path's argmax) gives. The Pallas body passes over a NaN, so it is
    not held to these rows."""
    logits, drafts, mask = verify_inputs(N, T, V, special=True)
    tok, acc = draft_verify(*(torch.from_numpy(a) for a in (logits, drafts,
                                                            mask)))
    j_tok, j_acc = jx["verify_ref"](*(jx["jnp"].asarray(a)
                                      for a in (logits, drafts, mask)))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
    last = tok[-1].tolist()
    assert last[0] == V // 2 and last[1] == 0 and last[2] == V // 4
    assert acc[-1] == (35 if T > 36 else T - 1)


def test_draft_verify_matches_core_acceptance():
    """The port's fused op implements exactly the session's accept rule."""
    rng = np.random.default_rng(5)
    B, N_d, DL, V = 2, 6, 4, 90
    logits = torch.from_numpy(
        rng.standard_normal((B * N_d, DL + 1, V)).astype(np.float32))
    drafts = torch.from_numpy(rng.integers(0, V, (B, N_d, DL)).astype(np.int32))
    mask = torch.ones((B, N_d), dtype=torch.bool)
    toks, acc = draft_verify(logits, drafts.reshape(B * N_d, DL),
                             mask.reshape(-1))
    expected = _accept_lengths(toks.reshape(B, N_d, DL + 1), drafts, mask)
    np.testing.assert_array_equal(acc.reshape(B, N_d).numpy(),
                                  expected.numpy())


def test_wrappers_refuse_other_devices_and_bad_shapes():
    """A tensor neither on the CPU nor on the card never silently takes the
    plain version; mismatched shapes raise before any launch."""
    q, kc, vc, k_pos, q_pos = (torch.from_numpy(a) for a in
                               _decode_inputs(DECODE_SWEEP[0]))
    meta = [t.to("meta") for t in (q, kc, vc, k_pos, q_pos)]
    with pytest.raises(ValueError):
        decode_gqa_attention(*meta)
    with pytest.raises(ValueError):
        decode_gqa_attention(q, kc, vc, k_pos[:, :-1], q_pos)
    logits, drafts, mask = (torch.from_numpy(a) for a in
                            verify_inputs(3, 4, 20))
    with pytest.raises(ValueError):
        draft_verify(logits.to("meta"), drafts.to("meta"), mask.to("meta"))
    with pytest.raises(ValueError):
        draft_verify(logits, drafts[:, :-1], mask)


# ---------------------------------------------------------------------------
# the Python around the decode kernels: split plan, copy mode, build cache

# (B, Kv, keys a row, T*G, hd): the main path's shapes (the verify pass of
# 8 slots, trained serving at B 1 and B 24, the paged verify pass), then
# long rows at B 1 and a card-filling batch of long rows
SPLIT_CASES = [(200, 8, 108, 11, 32), (1, 8, 74, 1, 32), (24, 8, 84, 11, 32),
               (192, 8, 96, 11, 32), (1, 8, 600, 1, 32), (1, 4, 600, 22, 32),
               (1, 1, 4096, 1, 128), (34, 4, 700, 22, 32), (3, 2, 33, 5, 6)]


@pytest.mark.parametrize("B,Kv,n_keys,TG,hd", SPLIT_CASES)
def test_plan_splits_bounds(B, Kv, n_keys, TG, hd):
    """At least one block a (row, kv head), never more splits than key
    tiles, every split holds keys, and the splits cover the row."""
    n = decode_kernel.plan_splits(B, Kv, n_keys, TG, hd)
    chunk = decode_kernel.split_chunk(n_keys, n)
    tiles = -(-n_keys // decode_kernel.KEY_TILE)
    assert 1 <= n <= tiles
    assert chunk % decode_kernel.KEY_TILE == 0
    assert (n - 1) * chunk < n_keys <= n * chunk


def test_plan_splits_where_the_grid_fills_the_card_or_the_row_is_short():
    """One block a (row, kv head) at the verify pass of 8 slots (B 200) and
    at the trained shapes, whose rows a block's warps take at once; several
    for a long row at B 1, whose blocks would leave most SMs idle."""
    plan = decode_kernel.plan_splits
    assert plan(200, 8, 108, 11, 32) == 1      # 1600 blocks
    assert plan(24, 8, 84, 11, 32) == 1        # 192 blocks
    assert plan(1, 8, 74, 1, 32) == 1          # 3 key tiles: one block
    assert plan(1, 8, 600, 1, 32) > 1
    assert plan(1, 1, 4096, 1, 128) > plan(1, 8, 4096, 1, 128) > 1


@pytest.mark.parametrize("hd,itemsize,ptrs,strides,expected", [
    (32, 4, (256, 512), (8192, 256, 32), True),     # fp32 cache, hd 32
    (8, 2, (256, 512), (2048, 64, 8), True),         # bf16, hd 8 = 16 bytes
    (6, 4, (256, 512), (1536, 48, 6), False),        # rows of 24 bytes
    (4, 2, (256, 512), (512, 16, 4), False),         # bf16 rows of 8 bytes
    (32, 4, (260, 512), (8192, 256, 32), False),     # a base off 16 bytes
    (32, 4, (256, 512), (8192, 258, 32), False),     # a stride off 16 bytes
])
def test_vector_loads_choice(hd, itemsize, ptrs, strides, expected):
    assert decode_kernel.vector_loads(hd, itemsize, ptrs, strides) is expected


def test_vector_loads_from_tensors():
    """The wrappers' choice on real tensors: a contiguous cache copies by
    16-byte chunks; a view that starts one element in, or whose rows are 6
    floats, takes plain loads."""
    k = torch.zeros((2, 16, 4, 32))
    assert decode_kernel._vec(k, k.clone()) == 1
    wide = torch.zeros((2, 16, 4, 33))
    assert decode_kernel._vec(wide[..., 1:], wide[..., 1:]) == 0
    narrow = torch.zeros((2, 16, 4, 6))
    assert decode_kernel._vec(narrow, narrow) == 0


def test_lib_path_covers_headers(tmp_path, monkeypatch):
    """A library is named by its source, every csrc header and the flags: a
    changed header builds anew; a file that is no header does not."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._lib_path("k")
    (tmp_path / "notes.txt").write_text("not a header")
    assert _build._lib_path("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = _build._lib_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// another header\n")
    assert _build._lib_path("k") != second
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// changed\n')
    assert _build._lib_path("k") not in (first, second)


def _race(fn, n_threads: int = 8):
    """Run ``fn(i)`` on ``n_threads`` threads released together, with a
    short switch interval; returns their results in thread order."""
    barrier = threading.Barrier(n_threads)
    out = [None] * n_threads

    def run(i):
        barrier.wait(timeout=10)
        out[i] = fn(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    return out


def test_first_launch_from_threads_builds_and_loads_once(monkeypatch):
    """Threads that reach a kernel's first launch together (a server's
    drive thread, two replicas' engines) run one build and one load, and
    all get the same launch function."""
    builds, loads = [], []

    def build_all(names=_build.KERNELS):
        builds.append(tuple(names))
        time.sleep(0.05)   # a slow nvcc: the window a racing thread needs
        return 0.0

    class CDLL:
        def __init__(self, path):
            loads.append(path)
            self.draft_verify_launch = types.SimpleNamespace()

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_all", build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", CDLL)
    fns = _race(lambda i: _build.load("draft_verify"))
    assert builds == [("draft_verify",)] and len(loads) == 1
    assert all(f is fns[0] for f in fns)
    assert fns[0].restype is _build.ctypes.c_int


def test_ticket_buffers_grow_under_a_lock():
    """Threads asking for ticket buffers of different sizes at once: every
    one gets at least what it asked for, and the buffer kept is the
    largest (no thread swaps a smaller one in over a larger)."""
    store = {}

    def zeros(n):
        time.sleep(0.01)
        return torch.zeros(n, dtype=torch.int32)

    sizes = [1000 * (i + 1) + 7 for i in range(8)]
    got = _race(lambda i: _build.tickets(store, "cpu", sizes[i], zeros))
    assert all(t.numel() >= n for t, n in zip(got, sizes))
    assert store["cpu"].numel() >= max(sizes)


def test_launch_counts_lose_no_update_across_threads(monkeypatch):
    """Two engines' threads launching at once: every launch is counted."""
    monkeypatch.setattr(_build, "launch_counts",
                        dict.fromkeys(_build.launch_counts, 0))

    def launch(i):
        for _ in range(2000):
            _build.count_launch("draft_verify")

    _race(launch)
    assert _build.launch_counts["draft_verify"] == 8 * 2000


# ---------------------------------------------------------------------------
# the Python around the draft_verify kernel: row or split path, load width

# (N, T, V): the main path at the MT's vocab (verify pass, trained greedy
# and verify, one-shot N 400), T 40, the USPTO-MIT vocab, a language
# model's verify pass and greedy step, and no rows
VERIFY_PLAN_CASES = [(200, 11, 27), (1, 1, 27), (24, 11, 28), (400, 11, 27),
                     (6, 40, 27), (200, 11, 320), (4, 40, 320),
                     (24, 11, 49_152), (1, 1, 151_936), (1, 40, 151_936),
                     (2, 3, 50_257), (0, 11, 27), (40, 11, 32_064),
                     (8, 1, 32_064), (40, 11, 65_536), (100, 11, 65_536),
                     (4, 1, 65_536)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("N,T,V", VERIFY_PLAN_CASES)
def test_draft_verify_plan_bounds(N, T, V, itemsize):
    """The greedy kernel takes T 1 rows of at most GREEDY_V entries, one
    warp a row; the row path fits its rows in a block's shared memory and
    its warps in a block, and shares a position among a power of two of
    lanes; the split path's splits are whole CHUNK_ALIGN multiples, cover
    the vocab, none empty, and are split only while the grid is under
    SPLIT_BLOCKS, each at least SPLIT_BYTES."""
    k = verify_kernel
    p = k.plan(N, T, V, itemsize)
    if p.rows and p.lanes == 0:
        assert T == 1 and V <= k.GREEDY_V and p.warps == 1
        assert 1 <= p.rows <= k.MAX_WARPS
        return
    if p.rows:
        assert V * itemsize <= k.ROW_VOCAB_BYTES
        assert 1 <= p.warps and p.rows * p.warps <= k.MAX_WARPS
        assert p.rows * k.row_bytes(T, V, itemsize) <= k.SMEM_LIMIT
        assert p.lanes in (1, 2, 4, 8, 16, 32)
        assert p.rows == 1 or N // p.rows >= k.N_SMS
        return
    assert p.chunk % k.CHUNK_ALIGN == 0
    assert (p.n_split - 1) * p.chunk < V <= p.n_split * p.chunk
    if p.n_split > 1:
        assert N * T * (p.n_split - 1) < k.SPLIT_BLOCKS
        assert V * itemsize >= (p.n_split - 1) * k.SPLIT_BYTES


def test_draft_verify_plan_choices():
    """Greedy rows (T 1) of the MT's vocab take the greedy kernel. Its
    verify pass takes the row path, one warp a row and one row a block up
    to N 264 (the verify pass of 8 slots: 200 blocks), three rows at the
    one-shot N 400, two lanes a position at T 11, three warps at T 40; the
    USPTO-MIT vocab seven warps a row, 16 lanes a position (one warp at T
    1). A language model's vocab takes the split path: two splits at 24 x
    11 (528 blocks), 38 of 4,000 entries for one greedy row of 151,936 in
    fp32 (19 in bf16), one where the rows fill the card. T 40 at V 320
    overflows the shared memory in fp32, not in bf16."""
    plan = verify_kernel.plan
    assert plan(1, 1, 27, 4) == (1, 1, 0, 1, 27)
    assert plan(16, 1, 27, 2) == (1, 1, 0, 1, 27)
    assert plan(200, 11, 27, 4) == (1, 1, 2, 1, 27)
    assert plan(400, 11, 27, 4) == (3, 1, 2, 1, 27)
    assert plan(24, 11, 28, 4)[:3] == (1, 1, 2)
    assert plan(6, 40, 27, 4)[:3] == (1, 3, 2)
    assert plan(200, 11, 320, 4) == (1, 7, 16, 1, 320)
    assert plan(1, 1, 320, 4) == (1, 1, 32, 1, 320)
    assert plan(4, 40, 320, 4) == (0, 0, 0, 1, 320)
    assert plan(4, 40, 320, 2).rows == 1
    assert plan(24, 11, 49_152, 4) == (0, 0, 0, 2, 24_576)
    assert plan(1, 1, 151_936, 4) == (0, 0, 0, 38, 4_000)
    assert plan(1, 1, 151_936, 2) == (0, 0, 0, 19, 8_000)
    assert plan(1024, 1, 151_936, 4).n_split == 1
    # Phi-3.5-MoE's 32,064 and RWKV6's 65,536 (the MoE and recurrent
    # phases): two splits at 40 x 11, eight of 4,016 for the greedy step of
    # 8 slots (four in bf16), one where 100 x 11 rows fill the card, 16 of
    # 4,096 for the greedy step of 4 slots
    assert plan(40, 11, 32_064, 4) == (0, 0, 0, 2, 16_032)
    assert plan(8, 1, 32_064, 4) == (0, 0, 0, 8, 4_016)
    assert plan(8, 1, 32_064, 2) == (0, 0, 0, 4, 8_016)
    assert plan(40, 11, 65_536, 4) == (0, 0, 0, 2, 32_768)
    assert plan(100, 11, 65_536, 4) == (0, 0, 0, 1, 65_536)
    assert plan(4, 1, 65_536, 4) == (0, 0, 0, 16, 4_096)


@pytest.mark.parametrize("ptr,itemsize,run,expected", [
    (256, 4, 27, False),          # one row of V 27 fp32: 108 bytes
    (256, 4, 11 * 27, False),     # the verify pass's T 11 run: 1,188 bytes
    (256, 4, 16 * 27, True),      # T 16: 1,728 bytes, whole chunks
    (256, 4, 11 * 320, True),     # the USPTO-MIT vocab
    (256, 2, 8 * 27, True),       # bf16, 432 bytes
    (256, 2, 27, False),          # bf16, 54 bytes
    (256, 4, 49_152, True),
    (256, 4, 151_936, True),
    (256, 4, 50_257, False),      # GPT-2's vocab: 201,028-byte rows
    (260, 4, 11 * 320, False),    # a base off 16 bytes
])
def test_draft_verify_vector_loads(ptr, itemsize, run, expected):
    assert verify_kernel.vector_loads(ptr, itemsize, run) is expected


@pytest.mark.parametrize("T,V,warps,lanes", [
    (2, 27, 1, 4), (5, 27, 1, 4), (11, 27, 1, 2), (40, 27, 3, 2),
    (11, 320, 7, 16), (1, 1024, 2, 32), (11, 1024, 8, 16)])
def test_draft_verify_warps_and_lanes(T, V, warps, lanes):
    """One warp a row at the MT's T 11 x V 27, more as T*V grows; few
    lanes a position where the positions fill the row's lanes and the
    vocab is short, more as the vocab grows."""
    assert verify_kernel.warps_per_row(T, V) == warps
    assert verify_kernel.lanes_per_position(T, V, warps) == lanes


# ---------------------------------------------------------------------------
# flash_attention (full-sequence attention, forward and backward)

FLASH_KEYS = ("B", "S", "H", "hd")
MASK_IDS = ["causal", "bidirectional", "window24"]


def _flash(cfg, *, ragged=False, seed=4):
    """numpy q, k, v, dO (B, S, H, hd) and a key mask (ragged rows or
    None) for a sweep case."""
    lengths = ragged_lengths(cfg["B"], cfg["S"]) if ragged else None
    return flash_inputs(*(cfg[k] for k in FLASH_KEYS), lengths=lengths,
                        seed=seed)


def _bhsd(a):
    """(B, S, H, hd) -> the Pallas wrapper's (B, H, S, hd)."""
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("cfg", FLASH_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", FLASH_MASKS, ids=MASK_IDS)
def test_flash_attention_plain_matches_jax(jx, cfg, dtype, causal, window):
    """The Pallas contract (no key mask) on the JAX kernel test's sweep:
    the port's (B, H, S, hd) wrapper against the JAX Pallas kernel
    (interpret mode, 32-row blocks) and the JAX oracle."""
    q, k, v, _, _ = _flash(cfg)
    (jq, jk, jv), (tq, tk, tv) = _both(jx, [_bhsd(a) for a in (q, k, v)],
                                       dtype)
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == TDT[dtype] and out.shape == tq.shape
    for ref in (jx["flash"](jq, jk, jv, causal=causal, window=window, bq=32,
                            bk=32),
                jx["flash_ref"](jq, jk, jv, causal=causal, window=window)):
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
def test_flash_key_mask_matches_jax_attention(causal):
    """The key-mask extension: the port's ``attention()`` (projections,
    then ``flash_attention_bshd`` with the padding mask as key mask)
    against the JAX model's einsum ``attention(..., padding_mask=)`` on
    ragged rows, pad query rows included, at 1e-5."""
    jax = pytest.importorskip("jax")
    from repro.configs.mt import tiny_config as jax_tiny_config
    from repro.models.attention import attention as jax_attention
    from repro_torch.configs.mt import tiny_config
    from repro_torch.models.attention import attention

    cfg_j, cfg_t = jax_tiny_config(48, d_model=64), tiny_config(48,
                                                                d_model=64)
    rng = np.random.default_rng(6)
    p = {n: {"w": rng.standard_normal((64, 64)).astype(np.float32) / 8,
             "b": 0.1 * rng.standard_normal(64).astype(np.float32)}
         for n in ("wq", "wk", "wv", "wo")}
    x = rng.standard_normal((3, 21, 64)).astype(np.float32)
    pad = np.arange(21)[None] < np.array([21, 9, 1])[:, None]
    out = attention({n: {a: torch.from_numpy(b) for a, b in d.items()}
                     for n, d in p.items()}, cfg_t, torch.from_numpy(x),
                    causal=causal, padding_mask=torch.from_numpy(pad))
    ref = jax_attention(jax.tree.map(jax.numpy.asarray, p), cfg_j,
                        jax.numpy.asarray(x), causal=causal,
                        padding_mask=jax.numpy.asarray(pad))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("cfg", FLASH_SWEEP[:2] + FLASH_SWEEP[3:])
@pytest.mark.parametrize("causal,window", FLASH_MASKS, ids=MASK_IDS)
def test_flash_backward_plain_matches_jax_grad(jx, cfg, causal, window):
    """The explicit backward (P from the saved lse) against ``jax.grad``
    of the JAX oracle, at 1e-4."""
    jax, jnp = jx["jax"], jx["jnp"]
    q, k, v, do, _ = _flash(cfg)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    grads = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal,
                                    window=window)

    def f(jq, jk, jv):
        out = jx["flash_ref"](jq, jk, jv, causal=causal, window=window)
        return jnp.sum(out * jnp.asarray(_bhsd(do)))

    jgrads = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(_bhsd(a)) for a in (q, k, v)))
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(_bhsd(g.numpy()), np.asarray(jg),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cfg", FLASH_SWEEP[:2] + FLASH_SWEEP[3:])
@pytest.mark.parametrize("causal,window", FLASH_MASKS, ids=MASK_IDS)
def test_flash_backward_plain_matches_autograd(cfg, causal, window):
    """With ragged key masks: the explicit backward against torch autograd
    through the plain forward (1e-4), and the autograd Function (what the
    model differentiates) equal to the explicit backward."""
    q, k, v, do, km = _flash(cfg, ragged=True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    km = torch.from_numpy(km)
    kw = dict(causal=causal, window=window, key_mask=km)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o, lse = flash_attention_ref(*leaves, **kw)
    auto = torch.autograd.grad(o, leaves, tdo)
    grads = flash_attention_bwd_ref(tq, tk, tv, o.detach(), lse.detach(),
                                    tdo, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    fn = torch.autograd.grad(flash_attention_bshd(*leaves, **kw), leaves, tdo)
    for a, g, f in zip(auto, grads, fn):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=1e-4,
                                   rtol=1e-4)
        assert torch.equal(f, g)


def test_flash_fully_masked_row_is_zero_with_zero_gradient():
    """A query row with no visible key (a source row of padding only)
    outputs 0 and gets zero gradient, with lse -inf and no NaN; the JAX
    einsum gives the mean of V there. The other rows are untouched."""
    cfg = FLASH_SWEEP[0]
    q, k, v, do, _ = _flash(cfg)
    km = np.ones((cfg["B"], cfg["S"]), bool)
    km[1] = False
    tq, tk, tv, tdo, tkm = (torch.from_numpy(a) for a in (q, k, v, do, km))
    o, lse = flash_attention_ref(tq, tk, tv, causal=False, key_mask=tkm)
    assert not o[1].any() and torch.isinf(lse[1]).all() and (lse[1] < 0).all()
    dq, dk, dv = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo,
                                         causal=False, key_mask=tkm)
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))
    assert not (dq[1].any() or dk[1].any() or dv[1].any())
    o0, _ = flash_attention_ref(tq[:1], tk[:1], tv[:1], causal=False)
    assert torch.equal(o[0], o0[0])


GQA_IDS = [f"H{c['H']}_Kv{c['Kv']}_hd{c['hd']}" for c in FLASH_GQA]


def _gqa(cfg, ragged, pos, seed=4):
    """numpy q, dO (B, S, H, hd), k, v (B, S, Kv, hd), a key mask (ragged
    rows or None) and positions (``permuted_positions`` or None) for a
    GQA sweep case."""
    lengths = ragged_lengths(cfg["B"], cfg["S"]) if ragged else None
    q, k, v, do, km = flash_inputs(cfg["B"], cfg["S"], cfg["H"], cfg["hd"],
                                   lengths=lengths, seed=seed, Kv=cfg["Kv"])
    positions = permuted_positions(cfg["B"], cfg["S"]) if pos else None
    return q, k, v, do, km, positions


def _jax_masked_attend(jnp, q, k, v, km, positions, causal, window):
    """The JAX model's full-sequence attention core (``_masked_attend``:
    GQA einsum, masks on positions) on (B, S, H, hd) / (B, S, Kv, hd)."""
    from repro.models.attention import _masked_attend

    B, S, H = q.shape[:3]
    pos = (np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
           if positions is None else positions)
    valid = np.ones((B, S), bool) if km is None else km
    return _masked_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(pos), jnp.asarray(valid),
                          jnp.asarray(pos), causal=causal, window=window,
                          q_per_kv=H // k.shape[2])


def _seen(B, S, km, positions, causal, window):
    """(B, S) bool: rows with a visible key (JAX gives a row without one
    the mean of V, the port 0; those rows are left out)."""
    t = None if positions is None else torch.from_numpy(positions)
    vis = visible_mask(S, causal=causal, window=window,
                       key_mask=None if km is None else torch.from_numpy(km),
                       q_pos=t, k_pos=t)
    return np.broadcast_to(vis.any(-1)[:, 0].numpy(), (B, S))


@pytest.mark.parametrize("cfg", FLASH_GQA, ids=GQA_IDS)
@pytest.mark.parametrize("causal,window", FLASH_MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("ragged,pos", [(False, False), (True, False),
                                        (False, True), (True, True)],
                         ids=["plain", "ragged", "positions",
                              "ragged_positions"])
def test_flash_gqa_plain_matches_jax_attention(jx, cfg, causal, window,
                                               ragged, pos):
    """Grouped K/V heads and position masks: the plain forward against the
    JAX model's ``_masked_attend`` (1e-5), and the explicit backward (dK,
    dV summed over each kv head's query heads) against ``jax.grad`` of it
    (1e-4), at every row that sees a key (dO is 0 on the others)."""
    jax, jnp = jx["jax"], jx["jnp"]
    q, k, v, do, km, positions = _gqa(cfg, ragged, pos)
    seen = _seen(cfg["B"], cfg["S"], km, positions, causal, window)
    do = do * seen[:, :, None, None]
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    kw = dict(causal=causal, window=window,
              key_mask=None if km is None else torch.from_numpy(km),
              q_pos=None if positions is None else torch.from_numpy(positions),
              k_pos=None if positions is None else torch.from_numpy(positions))
    out, lse = flash_attention_ref(*t[:3], **kw)
    ref = _jax_masked_attend(jnp, q, k, v, km, positions, causal, window)
    np.testing.assert_allclose(out.numpy()[seen], np.asarray(ref)[seen],
                               atol=1e-5, rtol=1e-5)
    grads = flash_attention_bwd_ref(*t[:3], out, lse, t[3], **kw)

    def f(jq, jk, jv):
        o = _jax_masked_attend(jnp, jq, jk, jv, km, positions, causal,
                               window)
        return jnp.sum(o * jnp.asarray(do))

    jgrads = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    for g, jg in zip(grads, jgrads):
        assert g.shape == jg.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-4,
                                   rtol=1e-4)


def test_flash_gqa_autograd_matches_explicit_backward():
    """The autograd Function over GQA heads and positions (what the model
    differentiates) equals the explicit backward, and autograd through the
    plain forward within 1e-4."""
    q, k, v, do, km, positions = _gqa(FLASH_GQA[1], True, True)
    tp = torch.from_numpy(positions)
    kw = dict(causal=True, window=0, key_mask=torch.from_numpy(km),
              q_pos=tp, k_pos=tp)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o, lse = flash_attention_ref(*leaves, **kw)
    auto = torch.autograd.grad(o, leaves, tdo)
    grads = flash_attention_bwd_ref(tq, tk, tv, o.detach(), lse.detach(),
                                    tdo, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    fn = torch.autograd.grad(flash_attention_bshd(
        *leaves, causal=True, window=0, key_mask=kw["key_mask"],
        positions=tp), leaves, tdo)
    for a, g, f in zip(auto, grads, fn):
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=1e-4,
                                   rtol=1e-4)
        assert torch.equal(f, g)


def test_flash_lse_asked_for_only_when_a_gradient_is_needed(monkeypatch):
    """Inference (no grad, or no input that requires one) asks the forward
    for no lse, so the kernel writes none; the autograd path asks for it.
    On the CPU ``_forward`` runs the plain version, so the flag is recorded
    by wrapping it."""
    from repro_torch.kernels.flash_attention import ops

    asked = []

    def recording(*args, with_lse, **positions):
        asked.append(with_lse)
        return forward(*args, with_lse=with_lse, **positions)

    forward = ops._forward
    monkeypatch.setattr(ops, "_forward", recording)
    q, k, v, do, km = (torch.from_numpy(a) for a in _flash(FLASH_SWEEP[0],
                                                           ragged=True))
    kw = dict(causal=False, key_mask=km)
    ref, _ = flash_attention_ref(q, k, v, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with torch.no_grad():
        out = flash_attention_bshd(*leaves, **kw)
    assert asked == [False] and torch.equal(out, ref)
    assert torch.equal(flash_attention_bshd(q, k, v, **kw), ref)
    assert asked == [False, False]
    out = flash_attention_bshd(*leaves, **kw)
    assert asked == [False, False, True] and torch.equal(out.detach(), ref)
    torch.autograd.grad(out, leaves, do)
    assert asked == [False, False, True]


def test_flash_wrappers_refuse_other_devices_bad_shapes_and_gqa():
    """A tensor neither on the CPU nor on the card, mismatched shapes (k
    and v apart, another B or S or head_dim than q, query heads no
    multiple of the kv heads), a bad key mask, positions or window raise.
    Grouped K/V heads are taken: the wrapper, and ``attention()`` with a
    GQA config and positions (the decoder-only families' training path),
    run; ``attention()`` with positions equal to the indices computes
    exactly what it computes without them."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.configs.mt import tiny_config
    from repro_torch.models.attention import attention

    q, k, v, _, km = (None if a is None else torch.from_numpy(a)
                      for a in _flash(FLASH_SWEEP[0], ragged=True))
    with pytest.raises(ValueError):
        flash_attention_bshd(*(t.to("meta") for t in (q, k, v)), causal=True)
    with pytest.raises(ValueError):
        flash_attention_bshd(q, k[:, :-1], v, causal=True)
    with pytest.raises(ValueError):
        flash_attention_bshd(q, k, v[:, :, :1], causal=True)
    with pytest.raises(ValueError):
        flash_attention_bshd(q, k[:, :, :2], v[:, :, :2], causal=True)
    with pytest.raises(ValueError):
        flash_attention_bshd(q, k[..., :-1], v[..., :-1], causal=True)
    with pytest.raises(ValueError):
        flash_attention_bshd(q, k, v, causal=False, key_mask=km[:, :-1])
    with pytest.raises(ValueError):
        flash_attention_bshd(q, k, v, causal=True,
                             positions=torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        flash_attention_bshd(q, k, v, causal=True, window=-1)
    out = flash_attention_bshd(q, k[:, :, :1], v[:, :, :1], causal=True)
    assert out.shape == q.shape
    gqa = ModelConfig(name="gqa", family="dense", n_layers=1, d_model=32,
                      n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=16)
    rng = np.random.default_rng(1)
    p = {n: {"w": torch.from_numpy(rng.standard_normal(
             (32, w)).astype(np.float32) / 6)}
         for n, w in (("wq", 32), ("wk", 16), ("wv", 16), ("wo", 32))}
    x = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32))
    idx = torch.arange(5, dtype=torch.int32).expand(2, 5)
    assert torch.equal(attention(p, gqa, x), attention(p, gqa, x,
                                                       positions=idx))
    assert attention(p, gqa, x, positions=idx + 3).shape == x.shape
    cfg = tiny_config(16, d_model=32)
    p = {n: {"w": torch.zeros((32, 32))} for n in ("wq", "wk", "wv", "wo")}
    assert attention(p, cfg, x).shape == x.shape


# (B, Kv, n_split, TG, hd, itemsize) -> (q_groups, group_rows): the main
# paths' shapes keep one group (MT verify pass and trained rows, the
# SmolLM verify pass, greedy and beam steps and SBS verify pass); the
# SmolLM prefill lanes (96 rows on 96 blocks at 8 slots, on 24 at 2) and
# the card-only T*G 22 row at B 1 take groups; a one-shot prefill of 447
# positions (1,341 rows on 12 blocks) takes groups that fit shared memory,
# as it must at hd 256
GROUP_CASES = [((200, 8, 1, 11, 32, 4), (1, 11)),
               ((24, 8, 1, 11, 32, 4), (1, 11)),
               ((200, 3, 1, 33, 64, 4), (1, 33)),
               ((250, 3, 1, 33, 64, 4), (1, 33)),
               ((8, 3, 4, 3, 64, 4), (1, 3)),
               ((10, 3, 4, 3, 64, 4), (1, 3)),
               ((8, 3, 4, 96, 64, 4), (3, 32)),
               ((2, 3, 4, 96, 64, 4), (6, 16)),
               ((1, 4, 4, 22, 32, 4), (2, 16)),
               ((1, 3, 4, 1341, 64, 4), (21, 64)),
               ((1, 3, 4, 1341, 64, 2), (21, 64)),
               ((600, 1, 1, 1341, 256, 4), (17, 80)),
               # Phi-3.5-MoE at hd 128, G 4: the prefill lane of 8 slots
               # (T*G 128 on 8 x 8 x 3 blocks) takes two groups; the verify
               # passes (T*G 44), greedy and beam steps keep one
               ((8, 8, 3, 128, 128, 4), (2, 64)),
               ((40, 8, 1, 44, 128, 4), (1, 44)),
               ((50, 8, 1, 44, 128, 4), (1, 44)),
               ((8, 8, 3, 4, 128, 4), (1, 4)),
               ((10, 8, 2, 4, 128, 4), (1, 4))]


@pytest.mark.parametrize("args,expected", GROUP_CASES)
def test_plan_groups(args, expected):
    """Whole passes of 16 rows a group, every row in one group, and a
    group's query rows within ``Q_ROW_BYTES`` of shared memory."""
    B, Kv, n_split, TG, hd, itemsize = args
    n, rows = decode_kernel.plan_groups(*args)
    assert (n, rows) == expected
    assert (n - 1) * rows < TG <= n * rows
    assert n == 1 or rows % decode_kernel.ROW_PASS == 0
    bucket = next(b for b in (16, 32, 64, 128, 256) if hd <= b)
    assert rows * (bucket + 16 // itemsize) * itemsize <= max(
        decode_kernel.Q_ROW_BYTES, 16 * (bucket + 16 // itemsize) * itemsize)


# ---------------------------------------------------------------------------
# on the card: kernel against its plain version


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", DECODE_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_gqa_kernel_matches_plain(cuda, cfg, dtype):
    tx = [t.to(cuda) for t in _torch(_decode_inputs(cfg), dtype)]
    out = decode_gqa_attention(*tx, window=cfg["window"])
    ref = decode_gqa_ref(*tx, window=cfg["window"])
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(out.cpu()), _f32(ref.cpu()),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(DECODE_LM) + list(DECODE_MOE))
def test_decode_gqa_kernel_lm_shapes(cuda, name):
    """The decoder-only phase's shapes: T*G 96 at hd 64 (the prefill
    lanes of 8 and 2 slots, in query groups over 4 splits), the verify
    passes at B 200 and 250, the greedy and beam steps, and a feed of 447
    positions (1,341 query rows in 21 groups); and the MoE phase's at
    Phi-3.5-MoE's hd 128 and GQA group of 4."""
    cfg = {**DECODE_LM, **DECODE_MOE}[name]
    tx = [t.to(cuda) for t in _torch(_decode_inputs(cfg), "float32")]
    out = decode_gqa_attention(*tx)
    ref = decode_gqa_ref(*tx)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(PAGED_LM) + list(PAGED_MOE))
def test_paged_decode_gqa_kernel_lm_shapes(cuda, name):
    cfg = {**PAGED_LM, **PAGED_MOE}[name]
    tx = [t.to(cuda) for t in _torch(
        paged_inputs(*(cfg[k] for k in ("B", "T", "H", "Kv", "P", "ps", "nb",
                                        "hd")), n_mapped=cfg["n_mapped"]),
        "float32")]
    out = paged_decode_gqa_attention(*tx)
    ref = paged_decode_gqa_ref(*tx)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(PAGED_ALIASED))
def test_paged_decode_gqa_kernel_aliased_table(cuda, name):
    """Block tables whose rows share their leading 24 pages, then own
    private ones: the kernel against its plain version."""
    tx = [t.to(cuda) for t in _torch(_aliased_inputs(PAGED_ALIASED[name]),
                                     "float32")]
    out = paged_decode_gqa_attention(*tx)
    ref = paged_decode_gqa_ref(*tx)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("N,T,V", list(VERIFY_LM.values()))
def test_draft_verify_kernel_lm_shapes(cuda, N, T, V):
    _assert_verify_kernel_matches_plain(cuda, N, T, V, "float32")


@pytest.mark.gpu
def test_decode_gqa_kernel_ring_buffer(cuda):
    tx = [t.to(cuda) for t in _torch(ring_inputs(), "float32")]
    out = decode_gqa_attention(*tx, window=32)
    ref = decode_gqa_ref(*tx, window=32)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", PAGED_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_gqa_kernel_matches_plain(cuda, cfg, dtype):
    tx = [t.to(cuda) for t in _torch(_paged_inputs(cfg), dtype)]
    out = paged_decode_gqa_attention(*tx, window=cfg["window"])
    ref = paged_decode_gqa_ref(*tx, window=cfg["window"])
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(out.cpu()), _f32(ref.cpu()),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _assert_verify_kernel_matches_plain(cuda, N, T, V, dtype):
    """Bitwise equal to the plain version, the NaN / -inf / +inf row of
    ``verify_inputs(special=True)`` included, in one launch (none at N 0)."""
    tx = [t.to(cuda) for t in _torch(verify_inputs(N, T, V, special=True),
                                     dtype)]
    before = _build.launch_counts["draft_verify"]
    tok, acc = draft_verify(*tx)
    rtok, racc = draft_verify_ref(*tx)
    torch.cuda.synchronize()
    assert torch.equal(tok, rtok) and torch.equal(acc, racc)
    assert _build.launch_counts["draft_verify"] - before == (1 if N else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,T,V", VERIFY_SWEEP)
def test_draft_verify_kernel_matches_plain(cuda, N, T, V, dtype):
    _assert_verify_kernel_matches_plain(cuda, N, T, V, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,T,V", VERIFY_CARD_ONLY)
def test_draft_verify_kernel_card_only_shapes(cuda, N, T, V, dtype):
    """The main path's launch groups (greedy kernel and row path), the
    row path's several warps a row (V 320, T 40), the split path at
    language-model vocabs, at rows of no whole 16-byte chunks and at T 40
    x V 320 in fp32, and N 0."""
    _assert_verify_kernel_matches_plain(cuda, N, T, V, dtype)


@pytest.mark.gpu
def test_draft_verify_split_tickets_reset(cuda):
    """The split path's combining blocks leave the ticket counters at 0, so
    two calls agree bitwise and a third at another shape is right."""
    runs = []
    for N, T, V in ((1, 1, 151_936), (1, 1, 151_936), (24, 11, 49_152)):
        tx = [torch.from_numpy(a).to(cuda) for a in verify_inputs(N, T, V)]
        runs.append((draft_verify(*tx), draft_verify_ref(*tx)))
    torch.cuda.synchronize()
    assert not verify_kernel._tickets[tx[0].device].any()
    for (tok, acc), (rtok, racc) in runs:
        assert torch.equal(tok, rtok) and torch.equal(acc, racc)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", FLASH_SWEEP + FLASH_PLAIN_LOADS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", FLASH_MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("ragged", [False, True])
def test_flash_attention_kernel_matches_plain(cuda, cfg, dtype, causal,
                                              window, ragged):
    q, k, v, _, km = _flash(cfg, ragged=ragged)
    tx = [t.to(cuda) for t in _torch((q, k, v), dtype)]
    km = None if km is None else torch.from_numpy(km).to(cuda)
    kw = dict(causal=causal, window=window, key_mask=km)
    out = flash_attention_bshd(*tx, **kw)
    ref, _ = flash_attention_ref(*tx, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(out.cpu()), _f32(ref.cpu()),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", FLASH_SWEEP + FLASH_PLAIN_LOADS)
@pytest.mark.parametrize("causal,window", FLASH_MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("ragged", [False, True])
def test_flash_backward_kernel_matches_plain(cuda, cfg, causal, window,
                                             ragged):
    q, k, v, do, km = _flash(cfg, ragged=ragged)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(cuda) for a in (q, k, v, do))
    km = None if km is None else torch.from_numpy(km).to(cuda)
    kw = dict(causal=causal, window=window, key_mask=km)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    grads = torch.autograd.grad(flash_attention_bshd(*leaves, **kw), leaves,
                                tdo)
    o, lse = flash_attention_ref(tq, tk, tv, **kw)
    ref = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, **kw)
    torch.cuda.synchronize()
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_flash_kernels_are_deterministic(cuda):
    """No atomics: two forward calls, and two backward calls, on the same
    inputs at the train encoder's shape (B 24, S 96, H 8, hd 32, ragged key
    mask) are bitwise equal."""
    B, S = 24, 96
    q, k, v, do, km = flash_inputs(B, S, 8, 32,
                                   lengths=ragged_lengths(B, S))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(cuda) for a in (q, k, v, do))
    kw = dict(causal=False, key_mask=torch.from_numpy(km).to(cuda))
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        out = flash_attention_bshd(*leaves, **kw)
        runs.append((out.detach(), *torch.autograd.grad(out, leaves, tdo)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", FLASH_GQA, ids=GQA_IDS)
@pytest.mark.parametrize("causal,window", FLASH_MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("pos", [False, True])
def test_flash_gqa_kernels_match_plain(cuda, cfg, causal, window, ragged,
                                       pos):
    """The kv-head mapping and the position masks, forward (fp32, and bf16
    without positions) and both backward kernels, against the plain
    versions on the card."""
    q, k, v, do, km, positions = _gqa(cfg, ragged, pos)
    on = (lambda a: None if a is None
          else torch.from_numpy(a).to(cuda))
    kw = dict(causal=causal, window=window, key_mask=on(km),
              q_pos=on(positions), k_pos=on(positions))
    kern_kw = dict(causal=causal, window=window, key_mask=on(km),
                   positions=on(positions))
    for dtype in ("float32",) if pos else ("float32", "bfloat16"):
        tx = [t.to(cuda) for t in _torch((q, k, v), dtype)]
        out = flash_attention_bshd(*tx, **kern_kw)
        ref, _ = flash_attention_ref(*tx, **kw)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_f32(out.cpu()), _f32(ref.cpu()),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    tq, tk, tv, tdo = (on(a) for a in (q, k, v, do))
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    grads = torch.autograd.grad(flash_attention_bshd(*leaves, **kern_kw),
                                leaves, tdo)
    o, lse = flash_attention_ref(tq, tk, tv, **kw)
    ref = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, **kw)
    torch.cuda.synchronize()
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_flash_gqa_kernels_are_deterministic(cuda):
    """dK/dV summed over the group in registers, no atomics: two calls at
    SmolLM's training heads (9 over 3, hd 64), causal, are bitwise equal."""
    q, k, v, do, _ = flash_inputs(4, 191, 9, 64, Kv=3)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(cuda) for a in (q, k, v, do))
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        out = flash_attention_bshd(*leaves, causal=True)
        runs.append((out.detach(), *torch.autograd.grad(out, leaves, tdo)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", DECODE_CARD_ONLY)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_gqa_kernel_card_only_shapes(cuda, cfg, dtype):
    """Several splits with a ragged last one, two row passes, plain loads
    (hd 6) and the two-stage ring."""
    tx = [t.to(cuda) for t in _torch(_decode_inputs(cfg), dtype)]
    out = decode_gqa_attention(*tx, window=cfg["window"])
    ref = decode_gqa_ref(*tx, window=cfg["window"])
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(out.cpu()), _f32(ref.cpu()),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", PAGED_CARD_ONLY)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_gqa_kernel_card_only_shapes(cuda, cfg, dtype):
    tx = [t.to(cuda) for t in _torch(_paged_inputs(cfg), dtype)]
    out = paged_decode_gqa_attention(*tx, window=cfg["window"])
    ref = paged_decode_gqa_ref(*tx, window=cfg["window"])
    torch.cuda.synchronize()
    np.testing.assert_allclose(_f32(out.cpu()), _f32(ref.cpu()),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("split", [False, True], ids=["one_block", "split"])
def test_decode_kernels_are_deterministic(cuda, split):
    """No float atomics: two calls on the same inputs are bitwise equal,
    dense and paged, with one block a (row, kv head) (B 24, the trained
    verify pass) and split over several (the B 1 long rows)."""
    dense = (DECODE_CARD_ONLY[0] if split else
             dict(B=24, T=11, H=8, Kv=8, S=84, hd=32, window=0))
    paged = (PAGED_CARD_ONLY[0] if split else
             dict(B=24, T=11, H=8, Kv=8, P=97, ps=16, nb=6, hd=32, window=0))
    n = decode_kernel.plan_splits(dense["B"], dense["Kv"], dense["S"],
                                  dense["T"] * dense["H"] // dense["Kv"],
                                  dense["hd"])
    assert (n > 1) == split
    tx = [t.to(cuda) for t in _torch(_decode_inputs(dense), "float32")]
    px = [t.to(cuda) for t in _torch(_paged_inputs(paged), "float32")]
    runs = [(decode_gqa_attention(*tx), paged_decode_gqa_attention(*px))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_paged_inactive_row_is_zero_when_split(cuda):
    """A row whose queries and table are all -1 gives 0, no NaN, when its
    keys are split over several blocks too."""
    arrays = list(_paged_inputs(PAGED_CARD_ONLY[0]))
    arrays[4][0] = -1
    arrays[5][0] = -1
    out = paged_decode_gqa_attention(*(torch.from_numpy(a).to(cuda)
                                       for a in arrays))
    assert torch.isfinite(out).all() and not out.any()
