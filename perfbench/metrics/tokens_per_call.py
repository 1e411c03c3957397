"""Speculative decoding's yield: the generated tokens of each completed
query's first beam over the decoder calls it took (``SlotResult.lengths``
and ``SlotResult.n_calls``), summed over the window's completions."""


def read(run, name):
    calls = sum(c.n_calls for c in run.completions)
    if not calls:
        return None
    return sum(int(c.lengths[0]) for c in run.completions) / calls
