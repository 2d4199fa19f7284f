"""Readings of the comparison that decides ``correct``, for setting and
proving its limits: the program at the configuration's precision on many
seeds (the lower readings), and the control, the program's own float32
lane in place of float64 (the upper readings), which has to come out as not
correct. One process runs every seed, one after another:

    python3 -m benchmark.control --workload <cell> --seconds <s> \\
        [--dtype float32] --seeds <n> [<n> ...]

One JSON line per seed on standard output: the cell, seed, precision,
``correct``, the points compared, and each number compared with its
limit. Runs only on a CUDA device, at the cell's own size.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from benchmark.run import run_cell

    rc = 0
    for seed in args.seeds:
        try:
            out, checks = run_cell(args.workload, seed, args.seconds, False,
                                   dtype=args.dtype)
            rec = dict(cell=args.workload, seed=seed,
                       dtype=args.dtype or "config", correct=out["correct"],
                       attempted=out["attempted"], metrics=out["metrics"],
                       checks={k: [c["value"], c["limit"]]
                               for k, c in checks.items()})
        except Exception as e:   # a control that crashes has failed
            traceback.print_exc()
            rec = dict(cell=args.workload, seed=seed,
                       dtype=args.dtype or "config", correct=False,
                       error=repr(e)[:400])
            rc = 1
        print(json.dumps(rec, default=str), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
