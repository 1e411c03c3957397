"""Run one cell of the benchmark on the card and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
``breakdown`` (traced runs) and ``checks`` (each number the comparison
read, beside its limit). The same numbers end standard error. Without a
CUDA card the run fails and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "perfbench" / ".cache"


def _environment() -> None:
    """Fixed cache directories inside the checkout, deterministic cuBLAS
    for the trainer, one host thread for the libraries (the host loop is
    the program's; idle worker threads only add noise), and no JAX pulled
    in by a library."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(CACHE / "torch_kernels")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # the benchmark as a package, the program from its source tree; not
    # this directory itself, whose module names would shadow others
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    torch.set_num_threads(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    from perfbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    need = {w["name"]: w["chips"] for w in bench["workloads"]}.get(
        args.workload)
    if need is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START)
    except harness.ForbiddenModules as e:
        print(str(e), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
