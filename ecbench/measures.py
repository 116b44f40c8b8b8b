"""Arithmetic the metric readers share: rates and percentiles over a
run's records, the codec metrics' deltas, and shares of the device trace.
Each returns None where the run has nothing to read."""

from __future__ import annotations

import numpy as np

from . import peaks


def job_rate_gbps(run) -> "float | None":
    """Bytes of every job over the summed time of every job, each timed
    from its due time to its return, in GB/s."""
    if not run.records:
        return None
    seconds = sum(r["end"] - r["due"] for r in run.records)
    return sum(r["bytes"] for r in run.records) / seconds / 1e9


def latency_ms(run, q: float) -> "float | None":
    """The q-th percentile of every operation's latency, in ms."""
    lat = [r["latency_s"] for r in run.records]
    if not lat:
        return None
    return float(np.percentile(lat, q)) * 1e3


def codec_call_ms(run, backend: str, op: str) -> "float | None":
    """Mean span of the codec's calls in the window (issue to fetch), from
    seaweedfs_codec_op_seconds' sum and count."""
    count = run.counter_delta("seaweedfs_codec_op_seconds_count", backend,
                              op)
    if count <= 0:
        return None
    return run.counter_delta("seaweedfs_codec_op_seconds_sum", backend,
                             op) / count * 1e3


def _scope(run, over: str):
    tr = run.device_trace
    return tr.ops if over == "ops" else tr.window_scope()


def roofline_pct(run, over: str) -> "float | None":
    """The least time of the codec's work (the records' codec_io_bytes at
    the card's HBM rate) over the kernels' time in the operations' intervals
    ("ops") or the window ("window"), in %."""
    tr = run.device_trace
    if tr is None:
        return None
    rate = peaks.HBM_BYTES_PER_S.get(run.kind)
    kernel_s = tr.kernel_s(_scope(run, over))
    if rate is None or kernel_s <= 0 or not run.records:
        return None
    least = sum(r["codec_io_bytes"] for r in run.records) / rate
    return 100.0 * least / kernel_s


def idle_pct(run, over: str) -> "float | None":
    """Share of the operations' intervals ("ops") or of the window
    ("window") with no kernel or copy running, in %."""
    tr = run.device_trace
    if tr is None:
        return None
    busy = tr.busy_share(_scope(run, over))
    return None if busy is None else 100.0 * (1.0 - busy)

