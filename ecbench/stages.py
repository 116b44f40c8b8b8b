"""The program's host stages per operation, for the per-layer metrics
that read them: the window's delta of a stage family's sum
(`seaweedfs_<family>_seconds`, from the codec metrics' text page), summed
over the backend label for one op, over the operations in the window, in
ms.  None where the program has no such family."""

from __future__ import annotations


def stage_ms(run, family: str, op: str) -> "float | None":
    sample = f"seaweedfs_{family}_seconds_sum"
    keys = [k for k in run.counters_after if k[0] == sample and k[2] == op]
    if not keys or not run.records:
        return None
    return sum(run.counter_delta(*k) for k in keys) / len(run.records) * 1e3
