"""Run one cell of the benchmark of seaweedfs_tpu_torch once, on the CUDA
device of this machine, and print the result as the last line of standard
output:

    python3 ecbench/run.py --workload rs10_4.encode --seed 7 --seconds 20 \\
        --trace 0

The cells, their configurations and their metrics are in BENCHMARK.json
at the root of the checkout; see ecbench/harness.py for how a run finds
them.  With --trace 1 the window runs under torch.profiler and the line
holds the per-layer metrics instead of the end-to-end ones.  Each number
compared with the reference is printed beside its limit as the last lines
of standard error.  Exits 2 without a result when CUDA or the cell's cards
are missing, and 3 when jax or the JAX package is loaded once the window
has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from ecbench import harness
    _, cell, _, _ = harness.load_cell(args.workload)
    import torch
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell["chips"]:
        print(f"ecbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda", t0=T0)
    found = harness.banned_modules()
    if found:
        print(f"ecbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
