"""The yardstick's arithmetic: the card's published peaks, the Molecular
Transformer's useful flops, and what each kernel launch needs (bytes read
once and written once, flops), frozen with the benchmark.

The launch counts follow ``decode_work`` / ``paged_work`` /
``verify_work`` of the program's kernel modules as they stood when this
benchmark was written. The paged and dense reads are counted where their
inputs live (``*_read_work`` return 0-d tensors), from copies kept at
each launch and only once the window has closed.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 outside the tensor
# cores (dense).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound_s(nbytes, flops):
    """The least time the card could take: bytes or flops at peak, the
    larger. Works on numbers and on tensors alike."""
    if isinstance(nbytes, torch.Tensor):
        return torch.maximum(nbytes.double() / HBM_BYTES_PER_S,
                             flops.double() / FP32_FLOPS_PER_S)
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


# ---------------------------------------------------------------------------
# the model's useful flops


def mt_query_flops(cfg: dict, src_len: int, out_lens) -> int:
    """Useful flops of one served query: the encoder over its ``src_len``
    source tokens (EOS included), the cross-attention keys and values of
    that memory in every decoder layer, and the decoder over the committed
    tokens of every returned beam (``out_lens``), token t attending over
    t + 1 cached keys and the ``src_len`` memory keys, plus the output head.
    Multiply-adds count 2; norms, biases, softmax and embeddings are left
    out. Rejected draft positions do no useful work and are not counted."""
    d, f, V = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    S = int(src_len)
    enc = cfg["n_encoder_layers"] * S * (8 * d * d + 4 * d * f + 4 * d * S)
    mem = cfg["n_layers"] * S * 4 * d * d
    dec = 0
    for L in out_lens:
        L = int(L)
        # sum over t < L of (t + 1) = L (L + 1) / 2
        per_layer = (L * (8 * d * d + 4 * d * d + 4 * d * S + 4 * d * f)
                     + 4 * d * (L * (L + 1) // 2))
        dec += cfg["n_layers"] * per_layer + L * 2 * d * V
    return enc + mem + dec


# ---------------------------------------------------------------------------
# kernel launches: (bytes, flops) of what the inputs need


def verify_work(N: int, T: int, V: int, itemsize: int) -> tuple[int, int]:
    """``draft_verify``: one compare a logit; the logits, the int32 drafts
    and the bool mask read once, the int32 tokens and accepted lengths
    written once."""
    nbytes = N * T * V * itemsize + N * (T - 1) * 4 + N + (N * T + N) * 4
    return nbytes, N * T * V


def paged_read_work(q_shape, pool_shape, pos_pool, block_tables, q_pos,
                    itemsize: int):
    """One paged decode read: the visible keys' K and V (a key counts when
    its block is mapped and its stored position is >= 0 and <= the newest
    query of a row that maps it; a page several rows alias counts once),
    the stored positions of the mapped pages, the block table, q, the output
    and q_pos; 4·hd flops per visible (query head, key) pair of each row.
    Tensors in, 0-d int64 tensors out (no host sync)."""
    B, T, H, hd = q_shape
    P, ps, Kv = pool_shape[:3]
    nb = block_tables.shape[1]
    bt = block_tables.long()
    mapped = bt >= 0
    page = torch.where(mapped, bt, 0)
    kpos = torch.where(mapped[..., None], pos_pool[page],
                       torch.full_like(pos_pool[page], -1)).reshape(B, -1)
    qmax = q_pos.max(1, keepdim=True).values
    vis = (kpos >= 0) & (kpos <= qmax)
    key_id = (page[..., None] * ps + torch.arange(ps, device=bt.device)
              ).reshape(B, -1)
    keys = torch.zeros(P * ps + 1, dtype=torch.bool, device=bt.device)
    keys[torch.where(vis, key_id, P * ps)] = True
    visible = keys[:-1].sum()
    pages = torch.zeros(P + 1, dtype=torch.bool, device=bt.device)
    pages[torch.where(mapped, bt, P)] = True
    n_pages = pages[:-1].sum()
    pairs = ((kpos[:, None, :] >= 0)
             & (kpos[:, None, :] <= q_pos[:, :, None])).sum()
    nbytes = (2 * visible * Kv * hd * itemsize + 2 * B * T * H * hd * itemsize
              + n_pages * ps * 4 + B * nb * 4 + B * T * 4)
    return nbytes, 4 * hd * H * pairs


def dense_read_work(q_shape, cache_shape, k_pos, q_pos, itemsize: int):
    """One dense decode read: the K and V of slots some query of the row can
    see, the stored and query positions, q and the output; 4·hd flops per
    visible (query head, key) pair. Tensors in, 0-d tensors out."""
    B, T, H, hd = q_shape
    S, Kv = cache_shape[1:3]
    qmax = q_pos.max(1, keepdim=True).values
    visible = ((k_pos >= 0) & (k_pos <= qmax)).sum()
    pairs = ((k_pos[:, None, :] >= 0)
             & (k_pos[:, None, :] <= q_pos[:, :, None])).sum()
    nbytes = (2 * visible * Kv * hd * itemsize + 2 * B * T * H * hd * itemsize
              + 4 * B * S + 4 * B * T)
    return nbytes, 4 * hd * H * pairs
