"""The readings the comparison's limits are set from: a cell run on many
seeds in one process. Each run judges the program's numbers and then the
control's on the same served requests (the reference at TF32, one
precision step below the configuration's, in the program's place), both
through the harness's own ``decide``. With ``--fault`` a fault of
``faults.py`` is planted under the timed path instead, and its numbers are
the program's.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --seconds 51 [--fault token-altered]

Prints one JSON line a seed, then the largest reading of each number over
the program's runs and the smallest over the control's (or the fault's).
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from run import _environment


def _values(checks: dict) -> dict:
    return {k: c["value"] for k, c in checks.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    _environment()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from perfbench import faults, harness

    lower: dict[str, float] = {}
    upper: dict[str, float] = {}

    def widest(into, values, pick):
        for k, v in values.items():
            v = float("inf") if v is None else v   # not produced: failed
            into[k] = pick(into.get(k, v), v)

    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        plant = (faults.planted(args.fault) if args.fault
                 else contextlib.nullcontext())
        with plant:
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 control=args.fault is None)
        line = {"seed": seed, "completions": r["attempted"]}
        if args.fault:
            line.update(fault=args.fault, correct=r["correct"],
                        numbers=_values(r["checks"]))
            widest(upper, line["numbers"], min)
        else:
            line.update(correct=r["program"]["correct"],
                        program=_values(r["program"]["checks"]),
                        control_correct=r["correct"],
                        control=_values(r["checks"]))
            widest(lower, line["program"], max)
            widest(upper, line["control"], min)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "fault": args.fault,
                      "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
