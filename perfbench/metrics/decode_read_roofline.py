"""The cached decode reads (``csrc/paged_decode_gqa.cu``,
``csrc/decode_gqa.cu``: the ``decode_attention_kernel`` instances) against
their roofline: the sum over the traced launches of each launch's bound
(``work.paged_read_work`` / ``work.dense_read_work`` of its inputs, kept at
the program's Python entry and counted after the window) over the kernels'
device time in the trace, in percent."""

from perfbench import work

ENTRIES = {
    ("repro_torch.models.attention", "paged_decode_gqa_attention"): (
        lambda a, kw: (a[0].shape, a[1].shape, a[3], a[4], a[5],
                       a[0].element_size()),
        work.paged_read_work),
    ("repro_torch.models.attention", "decode_gqa_attention"): (
        lambda a, kw: (a[0].shape, a[1].shape, a[3], a[4],
                       a[0].element_size()),
        work.dense_read_work),
}
KERNELS = r"decode_attention_kernel"


def read(run, name):
    return run.roofline(name)
