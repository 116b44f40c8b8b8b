"""Run a cell with the control (control/system.py) in the program's place,
at the cell's own size, on several seeds, and print each run's numbers
compared beside their limits, one JSON line per seed:

    python3 ecbench/control/run.py --workload rs10_4.encode \\
        --seeds 11 12 13 --seconds 8

Every line should read "correct": false: the check fails the control.  The
control is NumPy on the host; the benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from ecbench import harness
    for seed in args.seeds:
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             device="cpu", system="control")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "failed": r["failed"], "checks": r["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
