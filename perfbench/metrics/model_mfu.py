"""The model's useful flops in the window (its family's ``query_flops`` of
each completed query: for the Molecular Transformer ``work.
mt_query_flops``, encoder, cross keys and values, committed decoder tokens
of every returned beam; for a decoder-only model its reference's, the
prompt and the served tokens) over the window's seconds at the card's
float32 peak (``work.FP32_FLOPS_PER_S``), in percent."""

from perfbench import work


def read(run, name):
    if not run.completions:
        return None
    flops = sum(run.family.query_flops(run.model_cfg, c)
                for c in run.completions)
    return 100.0 * flops / (run.window_s * work.FP32_FLOPS_PER_S)
