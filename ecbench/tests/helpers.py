"""Small sizes the CPU tests run the cells at."""

from ecbench import harness

CELLS = ("rs10_4.encode", "clay10_4.rebuild", "rs10_4.degraded_read",
         "clay10_4.degraded_read")
# a 12 MiB volume: two 10 MiB rows, so shard 3 holds data
SMALL = {"volume_mb": 12, "interval_s": 0.3, "lost_order": [3, 11]}
SEED = 2**33 + 5


def run_small(cell: str, seed: int = SEED, **kw) -> dict:
    return harness.run_cell(cell, seed, 1.0, kw.pop("trace", False),
                            device="cpu", overrides=SMALL, **kw)
