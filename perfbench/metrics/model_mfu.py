"""The model's useful flops in the window (``work.mt_query_flops`` of each
completed query: encoder, cross keys and values, committed decoder tokens
of every returned beam) over the window's seconds at the card's float32
peak (``work.FP32_FLOPS_PER_S``), in percent."""

from perfbench import work


def read(run, name):
    if not run.completions:
        return None
    flops = sum(work.mt_query_flops(run.model_cfg, c.src_len, c.lengths)
                for c in run.completions)
    return 100.0 * flops / (run.window_s * work.FP32_FLOPS_PER_S)
