"""End-to-end serving example with the PyTorch port (the paper's industrial
target): single-step retrosynthesis with speculative beam search, streamed
requests. The counterpart of ``examples/serve_retrosynthesis.py``; runs on
the card unless ``--device cpu``.

Serves the shared benchmark model (``benchmarks/common_torch.py``: trains
and caches it on the first run):

    PYTHONPATH=src python examples/serve_retrosynthesis_torch.py [n_queries] [--device cpu]

Compares the per-request reference engine (one closed decode loop per
query, the paper's B=1 regime) against the continuous-batching
StreamingEngine (fixed decode slots, queued requests admitted as slots
free up) for both beam search and speculative beam search.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # benchmarks/
from benchmarks.common_torch import trained_model  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.serving import (EngineConfig, ReactionEngine,  # noqa: E402
                                 StreamingEngine)

MODES = ("beam", "speculative_beam")


def cfg_for(mode: str, max_new: int = 72) -> EngineConfig:
    return EngineConfig(mode=mode, n_beams=5, draft_len=10, n_drafts=16,
                        max_new=max_new, n_slots=2)


def run(n_queries: int = 6, *, device=None, model=None, max_new: int = 72,
        verbose: bool = False) -> dict:
    """Serve the first ``n_queries`` retro test products per request and
    streamed, in each beam mode, after one warm-up each (the streaming
    engine ``reset()`` after it); ``model``: (cfg, params, train_ds,
    test_ds), default ``trained_model(direction="retro")``; ``max_new``:
    the engines' token budget (the script's 72). Returns each mode's
    per-request predictions, streamed results (SMILES, log-probs and calls
    a request), walls and calls, and the speculative-beam prediction of
    the last query."""
    dev = resolve_device(device)
    cfg, params, train_ds, test_ds = model or trained_model(
        verbose=verbose, direction="retro", device=dev)
    tok = train_ds.tokenizer
    # retro direction: query = product, predictions = reactant sets
    requests = [test_ds.pair(i)[0] for i in range(n_queries)]

    engines = []
    for mode in MODES:
        ecfg = cfg_for(mode, max_new)
        ref = ReactionEngine(params, cfg, tok, ecfg, device=dev)
        stream = StreamingEngine(params, cfg, tok, ecfg, device=dev)
        ref.predict_topn(requests[0])          # warm-up
        stream.predict_topn(requests[0])
        stream.reset()                         # drop the warm-up's steps
        engines.append((mode, ref, stream))

    out = {"requests": requests}
    for mode, ref, stream in engines:
        t0 = time.perf_counter()
        per_request = [ref.predict_topn(q) for q in requests]
        t_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        handles = [stream.submit(q) for q in requests]
        done = stream.serve()
        t_stream = time.perf_counter() - t0
        streamed = [dict(smiles=[tok.decode(t) for t in done[int(h)].tokens],
                         logprobs=[float(x) for x in done[int(h)].logprobs],
                         n_calls=int(done[int(h)].n_calls))
                    for h in handles]
        out[mode] = dict(
            per_request=per_request, streamed=streamed, wall_ref_s=t_ref,
            wall_stream_s=t_stream,
            calls=sum(p.n_calls for p in per_request),
            resident_calls=sum(r.n_calls for r in done.values()),
            shared_steps=stream.scheduler.n_steps)
    out["last"] = engines[-1][2].predict_topn(requests[-1])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_queries", nargs="?", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)
    out = run(args.n_queries, device=args.device, verbose=True)
    for mode in MODES:
        r = out[mode]
        print(f"{mode:18s}: per-request {r['wall_ref_s']:6.2f}s "
              f"({r['calls']} calls) | continuous {r['wall_stream_s']:6.2f}s "
              f"({r['resident_calls']} resident calls, "
              f"{r['shared_steps']} shared steps)")
    print("\ntop-5 reactant sets for the last query (speculative beam):")
    pred = out["last"]
    for smi, lp in zip(pred.smiles, pred.logprobs):
        print(f"  {lp:8.3f}  {smi}")
    return out


if __name__ == "__main__":
    main()
