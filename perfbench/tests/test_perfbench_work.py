"""The yardstick's arithmetic against counts made by hand."""

from __future__ import annotations

import torch

from perfbench import work


def test_verify_work_by_hand():
    # logits 2*3*5 fp32, drafts 2*2 int32, mask 2 bytes, tokens 2*3 and
    # accepted 2 int32 written; one compare a logit
    assert work.verify_work(2, 3, 5, 4) == (120 + 16 + 2 + 32, 30)
    assert work.verify_work(1, 1, 7, 2) == (14 + 0 + 1 + 8, 7)


def test_mt_flops_by_hand():
    cfg = {"d_model": 2, "d_ff": 4, "vocab_size": 3, "n_encoder_layers": 1,
           "n_layers": 1}
    # encoder, 2 tokens: QKVO 8*d*d, FFN 4*d*f, attention 4*d*S each
    enc = 2 * (32 + 32 + 16)
    # the memory's cross K and V in the decoder layer: 4*d*d a token
    mem = 2 * 16
    # decoder, 2 tokens: self QKVO 32, cross Q and O 16, cross attention
    # 4*d*S 16, FFN 32, self attention 4*d*(t+1) = 8 and 16, head 2*d*V 12
    dec = (32 + 16 + 16 + 32) * 2 + 8 + 16 + 12 * 2
    assert work.mt_query_flops(cfg, 2, [2]) == enc + mem + dec
    # two beams of lengths 1 and 0: a beam counts its own tokens only
    one = 32 + 16 + 16 + 32 + 8 + 12
    assert work.mt_query_flops(cfg, 2, [1, 0]) == enc + mem + one


def test_paged_read_by_hand():
    # 4 pages of 2 slots, one kv head of width 2; row 1 aliases row 0's
    # first page
    pos = torch.tensor([[-1, -1], [0, 1], [2, -1], [5, 5]], dtype=torch.int32)
    bt = torch.tensor([[1, 2], [1, -1]], dtype=torch.int32)
    q_pos = torch.tensor([[2], [1]], dtype=torch.int32)
    nbytes, flops = work.paged_read_work((2, 1, 1, 2), (4, 2, 1, 2), pos, bt,
                                         q_pos, 4)
    # visible keys: page 1 both slots, page 2 slot 0 (once, though two rows
    # map page 1) = 3; mapped pages 2; pairs 3 + 2
    want = 2 * 3 * 1 * 2 * 4 + 2 * 2 * 1 * 1 * 2 * 4 + 2 * 2 * 4 + 2 * 2 * 4 \
        + 2 * 1 * 4
    assert (int(nbytes), int(flops)) == (want, 4 * 2 * 1 * 5)


def test_dense_read_by_hand():
    k_pos = torch.tensor([[0, 1, -1]], dtype=torch.int32)
    q_pos = torch.tensor([[0, 1]], dtype=torch.int32)
    nbytes, flops = work.dense_read_work((1, 2, 2, 2), (1, 3, 1, 2), k_pos,
                                         q_pos, 4)
    # 2 visible keys (K and V), q and out, stored and query positions;
    # pairs 1 + 2
    assert (int(nbytes), int(flops)) == (32 + 64 + 12 + 8, 4 * 2 * 2 * 3)


def test_bound_takes_the_larger():
    assert work.bound_s(3.35e12, 1) == 1.0
    assert work.bound_s(1, 67e12) == 1.0
    t = work.bound_s(torch.tensor(3.35e12, dtype=torch.float64),
                     torch.tensor(134e12, dtype=torch.float64))
    assert float(t) == 2.0
