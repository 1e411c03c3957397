"""The kernels' check cases: the shape sweeps and the seeded input builders
that the CPU parity tests (``tests/test_torch_kernels.py``) and the card's
check (``chip_smoke.py``) both use, so the two cannot drift apart.

Inputs are numpy arrays made from a seed (floats fp32, positions int32);
the caller moves them to its device and dtype.
"""

from __future__ import annotations

import numpy as np

# (B, T, H, Kv, S, hd, window): the sweep of the JAX package's kernel tests
DECODE_SWEEP = [
    dict(B=2, T=5, H=8, Kv=2, S=64, hd=32, window=0),
    dict(B=1, T=1, H=4, Kv=4, S=100, hd=16, window=0),   # plain greedy step
    dict(B=2, T=11, H=8, Kv=4, S=96, hd=64, window=24),  # verify + window
    dict(B=3, T=3, H=6, Kv=1, S=40, hd=8, window=0),     # MQA
]
# (B, T, H, Kv, P, ps, nb, hd, window): the paged sweep of the JAX package's
# kernel tests (pool of P pages of ps tokens, nb logical blocks per row)
PAGED_SWEEP = [
    dict(B=2, T=5, H=8, Kv=2, P=23, ps=16, nb=5, hd=32, window=0),
    dict(B=1, T=1, H=4, Kv=4, P=9, ps=8, nb=4, hd=16, window=0),    # greedy
    dict(B=2, T=11, H=8, Kv=4, P=31, ps=16, nb=6, hd=64, window=24),
    dict(B=3, T=3, H=6, Kv=1, P=16, ps=8, nb=4, hd=8, window=0),    # MQA
]
# card-only (the CPU suite's JAX interpret-mode time stays as it is): rows
# that reach the kernels' other paths. A long row split over several blocks
# with a ragged last split (B 1, T 1, S 600), the same with T*G = 22 query
# rows (two row passes a block) and a window; a head_dim whose rows are no
# whole 16-byte chunks (hd 6: plain loads); and a long row at a batch that
# fills the card (one block a (row, kv head)), whose keys stream through
# the two-stage ring, with two row passes re-reading it
DECODE_CARD_ONLY = [
    dict(B=1, T=1, H=8, Kv=8, S=600, hd=32, window=0),
    dict(B=1, T=11, H=8, Kv=4, S=600, hd=32, window=48),
    dict(B=2, T=3, H=4, Kv=2, S=40, hd=6, window=0),
    dict(B=34, T=11, H=8, Kv=4, S=700, hd=32, window=0),
]
# their paged twins (nb * ps keys a row, all but the last block mapped)
PAGED_CARD_ONLY = [
    dict(B=1, T=1, H=8, Kv=8, P=40, ps=16, nb=38, hd=32, window=0),
    dict(B=1, T=11, H=8, Kv=4, P=40, ps=16, nb=38, hd=32, window=48),
    dict(B=2, T=3, H=4, Kv=2, P=12, ps=8, nb=5, hd=6, window=0),
    dict(B=34, T=11, H=8, Kv=4, P=1 + 34 * 43, ps=16, nb=44, hd=32,
         window=0),
]
# the decoder-only serving phase's shapes at SmolLM-135M's width (H 9 over
# Kv 3, hd 64; a row holds max_src 512 + max_new 64 + DL 10 + 2 = 588
# slots): the prefill lane of 8 slots x a chunk of 32 (T*G 96), the verify
# pass of 8 slots x 25 drafts (T 11), the greedy step of 8 slots; the
# 2-slot modes' prefill lane (B 2 x T 32: few blocks, so its query rows
# spread over groups), beam step (2 slots x 5 beams) and SBS verify pass
# (2 x 5 x 25 drafts); and a one-shot prefill of 447 tokens (T*G 1,341
# query rows, in groups)
LM_ROW = 588
DECODE_LM = {
    name: dict(B=B, T=T, H=9, Kv=3, S=LM_ROW, hd=64, window=0)
    for name, B, T in (("smollm_prefill_lane", 8, 32),
                       ("smollm_verify", 200, 11), ("smollm_greedy", 8, 1),
                       ("smollm_prefill_lane_2slot", 2, 32),
                       ("smollm_beam", 10, 1), ("smollm_sbs_verify", 250, 11),
                       ("smollm_oneshot_prefill", 1, 447))}
# their paged twins: 37 blocks of 16 a row, the first 18 mapped (as
# ``decode_inputs`` half fills a row; all 37 for the one-shot feed), one page
# per mapped block
PAGED_LM = {name: dict(B=c["B"], T=c["T"], H=9, Kv=3, ps=16, nb=37, hd=64,
                       window=0, P=1 + c["B"] * mapped, n_mapped=mapped)
            for name, c in DECODE_LM.items()
            for mapped in [37 if name == "smollm_oneshot_prefill" else 18]}
# the MoE phase's shapes at Phi-3.5-MoE's width (H 32 over Kv 8, hd 128: a
# GQA group of 4; a row holds max_src 512 + max_new 32 + DL 10 + 2 = 556
# slots): the prefill lane of 8 slots x a chunk of 32 (T*G 128, in query
# groups over 3 splits), the verify pass of 8 slots x 5 drafts (T 11), the
# greedy step of 8 slots, the beam step of 2 slots x 5 beams and the SBS
# verify pass of 2 x 5 x 5 drafts
MOE_ROW = 556
DECODE_MOE = {
    name: dict(B=B, T=T, H=32, Kv=8, S=MOE_ROW, hd=128, window=0)
    for name, B, T in (("phi_prefill_lane", 8, 32), ("phi_verify", 40, 11),
                       ("phi_greedy", 8, 1), ("phi_beam", 10, 1),
                       ("phi_sbs_verify", 50, 11))}
# their paged twins: 35 blocks of 16 a row, the first 17 mapped
PAGED_MOE = {name: dict(B=c["B"], T=c["T"], H=32, Kv=8, ps=16, nb=35,
                        hd=128, window=0, P=1 + c["B"] * 17, n_mapped=17)
             for name, c in DECODE_MOE.items()}
# the prefix-sharing phase's read at SmolLM-135M's heads: 8 rows whose
# leading 24 blocks alias the same 24 pages (a 384-token prefix served from
# the radix cache), then each row's own pages, the last one part filled;
# the greedy step (T 1) and the 8-slot prefill lane of a suffix chunk (T
# 32, the chunk's own keys read causally)
PAGED_ALIASED = {
    name: dict(B=8, T=T, H=9, Kv=3, ps=16, nb=37, hd=64, window=0,
               n_shared=24, n_private=n_private,
               P=1 + 24 + 8 * n_private)
    for name, T, n_private in (("smollm_shared_greedy", 1, 4),
                               ("smollm_shared_prefill_lane", 32, 3))}
# (N, T, V): rows, fed positions (DL + 1), vocab
VERIFY_SWEEP = [(6, 5, 700), (12, 11, 1024), (3, 1, 64), (4, 6, 50),
                (25, 11, 320)]
# card-only draft_verify shapes: where the main path launches it (the
# verify pass of 8 slots x 25 drafts, one-shot 16 x 25; trained greedy at
# B 1, trained DL 4 / 10 at 24 drafts, trained streaming 8 x 24 at DL 10;
# greedy of 16 queries and of 8 slots), the USPTO-MIT vocab (320; its
# greedy step past the greedy kernel's 256 entries), a
# decoder-only verify pass and greedy step at language-model vocabs (split
# path), T 40 (DL 39: positions past one warp), a vocab whose rows are no
# whole 16-byte chunks on the split path (50,257), the split path at a
# small vocab (T 40 at V 320 fits no one pass of the row path) and no rows
VERIFY_CARD_ONLY = [(200, 11, 27), (400, 11, 27), (1, 1, 27), (24, 5, 28),
                    (24, 11, 28), (192, 11, 28), (16, 1, 27), (8, 1, 27),
                    (200, 11, 320), (16, 1, 320), (24, 11, 49_152),
                    (1, 1, 151_936),
                    (6, 40, 27), (2, 3, 50_257), (4, 40, 320), (0, 11, 27)]
# draft_verify on the decoder-only phases' main paths: SmolLM's vocab at
# the verify pass of 8 slots x 25 drafts and the greedy step of 8 slots;
# Phi-3.5-MoE's 32,064 at the verify pass of 8 slots x 5 drafts and the
# greedy step of 8 slots; RWKV6's 65,536 at 40 x 11, and at its phase's
# verify pass of 4 slots x 25 drafts and greedy step of 4 slots;
# Llama-3.2-Vision's 128,256 at the expanded verify pass of 4 prompts x 5
# drafts and the greedy step of 4 prompts
VERIFY_LM = {"smollm_verify": (200, 11, 49_152),
             "smollm_greedy": (8, 1, 49_152),
             "phi_verify": (40, 11, 32_064), "phi_greedy": (8, 1, 32_064),
             "rwkv_40x11": (40, 11, 65_536),
             "rwkv_verify": (100, 11, 65_536), "rwkv_greedy": (4, 1, 65_536),
             "vlm_verify": (20, 11, 128_256), "vlm_greedy": (4, 1, 128_256)}
# (B, H, S, hd) x (causal, window): the flash sweep of the JAX package's
# kernel tests (shapes in its (B, H, S, hd) order), then the largest
# head_dim (MAX_HD) at an S that is no multiple of 16, and a head_dim that
# runs zero-padded in the next bucket up
FLASH_SWEEP = [dict(B=2, H=3, S=64, hd=32), dict(B=1, H=2, S=96, hd=16),
               dict(B=2, H=2, S=128, hd=64), dict(B=1, H=1, S=33, hd=8),
               dict(B=1, H=2, S=72, hd=128), dict(B=2, H=1, S=50, hd=24)]
FLASH_MASKS = [(True, 0), (False, 0), (True, 24)]
# card-only: a head_dim whose rows are no whole 16-byte chunks, which the
# kernels copy by plain loads instead of cp.async
FLASH_PLAIN_LOADS = [dict(B=2, H=2, S=40, hd=6)]
# (B, S, H, Kv, hd): grouped-query full-sequence attention, the
# decoder-only families' training path: q_per_kv 1 at HuBERT's hd 80 (the
# 128 bucket, zero-padded), 3 at SmolLM's hd 64 and 4 at the largest
# bucket, each x FLASH_MASKS x (a ragged key mask or none) x (positions
# from ``permuted_positions`` or none)
FLASH_GQA = [dict(B=2, S=45, H=4, Kv=4, hd=80),
             dict(B=2, S=70, H=6, Kv=2, hd=64),
             dict(B=1, S=96, H=8, Kv=2, hd=128)]


def decode_inputs(B, T, H, Kv, S, hd, *, seed=1, prefix=None):
    """q, k/v cache, k_pos, q_pos for one cached-attention call laid out as
    the verify feed: a prefix of ``prefix`` positions (default S // 2; 0
    for a prefill), then the T fed tokens at positions prefix .. prefix +
    T - 1, each token's own key already written; the remaining slots are
    empty (position -1)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, hd), np.float32)
    kc = rng.standard_normal((B, S, Kv, hd), np.float32)
    vc = rng.standard_normal((B, S, Kv, hd), np.float32)
    prefix = S // 2 if prefix is None else prefix
    filled = prefix + T
    slots = np.arange(S)
    k_pos = np.where(slots < filled, slots, -1)[None].repeat(B, 0)
    q_pos = (prefix + np.arange(T))[None].repeat(B, 0)
    return q, kc, vc, k_pos.astype(np.int32), q_pos.astype(np.int32)


def ring_inputs():
    """A sliding-window ring buffer that has wrapped: slot s holds position
    48 - ((48 - s) % 32); use with ``window=32``."""
    rng = np.random.default_rng(2)
    B, T, H, Kv, S, hd = 1, 3, 4, 2, 32, 16
    q = rng.standard_normal((B, T, H, hd), np.float32)
    kc = rng.standard_normal((B, S, Kv, hd), np.float32)
    vc = rng.standard_normal((B, S, Kv, hd), np.float32)
    k_pos = (48 - ((48 - np.arange(S)) % S))[None].astype(np.int32)
    q_pos = np.asarray([[48, 49, 50]], np.int32)
    return q, kc, vc, k_pos, q_pos


def verify_inputs(N, T, V, *, seed=3, special=False):
    """logits (N, T, V), drafts (N, T - 1) that mostly follow the argmax,
    and a draft mask; row 0 position 0 holds an exact tie between tokens 1
    and V - 1 (the first index must win). ``special``: the last row's
    positions hold, in turn, two NaNs (the first wins over every number),
    nothing but -inf (index 0 wins), +inf at two tokens (the first wins)
    and -inf beside numbers (the greatest number wins), and its drafts
    follow those tokens up to the 36th, where T > 36, which misses."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((N, T, V)).astype(np.float32)
    if N:
        logits[0, 0, [1, V - 1]] = 50.0
    if special and N:
        row = logits[N - 1]
        for t in range(T):
            kind = t % 4
            if kind == 0:
                row[t, [V // 2, V - 1, V // 3]] = [np.nan, np.nan, 1e30]
            elif kind == 1:
                row[t] = -np.inf
            elif kind == 2:
                row[t, [V - 1, V // 4]] = np.inf
            else:
                row[t, ::2] = -np.inf
    greedy = logits.argmax(-1)   # numpy's order is torch.argmax's
    drafts = np.where(rng.random((N, T - 1)) < 0.7, greedy[:, :T - 1],
                      rng.integers(0, V, (N, T - 1))).astype(np.int32)
    mask = rng.random(N) < 0.8
    if special and N:
        drafts[N - 1] = greedy[N - 1, :T - 1]
        if T > 36:   # the first miss past the first 32 drafts
            drafts[N - 1, 35] = (greedy[N - 1, 35] + 1) % V
        mask[N - 1] = True
    return logits, drafts, mask



def paged_inputs(B, T, H, Kv, P, ps, nb, hd, *, n_mapped=None, seed=7):
    """q, k/v pool, pos pool, block tables, q_pos for one paged read, as the
    JAX package's kernel tests build them: a shuffled pool whose page 0 is
    the trash page (never mapped), the first ``n_mapped`` blocks of each row
    mapped to distinct pages and the rest unmapped (-1), each mapped page
    filled to a random length (ragged fills, empty slots at position -1),
    and the T queries at positions n_mapped * ps - 2 onwards."""
    if n_mapped is None:
        n_mapped = min(nb - 1, (P - 1) // B)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, hd), np.float32)
    k_pool = rng.standard_normal((P, ps, Kv, hd), np.float32)
    v_pool = rng.standard_normal((P, ps, Kv, hd), np.float32)
    bt = np.full((B, nb), -1, np.int32)
    pages = rng.permutation(np.arange(1, P))[:B * n_mapped]
    bt[:, :n_mapped] = pages.reshape(B, n_mapped)
    pos_pool = np.full((P, ps), -1, np.int32)
    for b in range(B):
        for j in range(n_mapped):
            fill = int(rng.integers(1, ps + 1))
            pos_pool[bt[b, j], :fill] = j * ps + np.arange(fill)
    q_pos = np.tile(n_mapped * ps - 2 + np.arange(T), (B, 1)).astype(np.int32)
    return q, k_pool, v_pool, pos_pool, bt, q_pos


def aliased_paged_inputs(B, T, H, Kv, ps, nb, hd, n_shared, n_private, *,
                         seed=8):
    """q, k/v pool, pos pool, block tables, q_pos for a paged read whose
    rows share their first ``n_shared`` pages (the same page ids in every
    row, as a radix prefix is aliased), then own ``n_private`` pages each,
    the last filled to a random length; the other blocks are unmapped.
    Each row's T queries are its last T written positions (a chunk read
    causally, or the newest token). The pool holds exactly the mapped
    pages plus the trash page 0."""
    rng = np.random.default_rng(seed)
    P = 1 + n_shared + B * n_private
    mapped = n_shared + n_private
    q = rng.standard_normal((B, T, H, hd), np.float32)
    k_pool = rng.standard_normal((P, ps, Kv, hd), np.float32)
    v_pool = rng.standard_normal((P, ps, Kv, hd), np.float32)
    pages = rng.permutation(np.arange(1, P))
    bt = np.full((B, nb), -1, np.int32)
    bt[:, :n_shared] = pages[:n_shared]
    bt[:, n_shared:mapped] = pages[n_shared:].reshape(B, n_private)
    pos_pool = np.full((P, ps), -1, np.int32)
    q_pos = np.zeros((B, T), np.int32)
    for b in range(B):
        for j in range(mapped):
            fill = int(rng.integers(1, ps + 1)) if j == mapped - 1 else ps
            pos_pool[bt[b, j], :fill] = j * ps + np.arange(fill)
            last = j * ps + fill
        q_pos[b] = last - T + np.arange(T)
    return q, k_pool, v_pool, pos_pool, bt, q_pos


def flash_inputs(B, S, H, hd, *, lengths=None, seed=4, Kv=None):
    """q, k, v and an upstream gradient dO in the model's layout: q and dO
    (B, S, H, hd), k and v (B, S, Kv, hd) (Kv defaults to H), and a key
    mask (B, S) bool: None when ``lengths`` is None, else True on the first
    ``lengths[b]`` keys of row ``b`` (trailing padding, as ``src != pad``
    and the decoder's ``lengths`` give it)."""
    rng = np.random.default_rng(seed)
    Kv = H if Kv is None else Kv
    q, k, v, do = (rng.standard_normal((B, S, h, hd), np.float32)
                   for h in (H, Kv, Kv, H))
    key_mask = (None if lengths is None
                else np.arange(S)[None] < np.asarray(lengths)[:, None])
    return q, k, v, do, key_mask


def ragged_lengths(B, S, *, seed=5):
    """Per-row valid lengths in [1, S], row 0 full: the ragged key masks
    of the checks."""
    lengths = np.random.default_rng(seed).integers(1, S + 1, B)
    lengths[0] = S
    return lengths


def permuted_positions(B, S, *, seed=9):
    """(B, S) int32 positions that are not the indices: each row a shuffle
    of ``offset + arange(S)`` (a random offset a row), so keys arrive in no
    order of position and a causal row's visible keys are scattered."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 50) + rng.permutation(S)
                     for _ in range(B)]).astype(np.int32)
