"""The per-layer metrics of the program's host stages (ecbench/stages.py):
a traced run of each cell on the CPU, at a small size, reports every one
that lists the cell, each a finite number >= 0, and their sums fit in the
operations' time: in the encode cell each thread's stages within the mean
job, elsewhere all four stages within the mean operation.  An untraced
run's line has none of them."""

import math
import types

import pytest

from ecbench import harness
from ecbench.tests.helpers import CELLS, run_small

STAGE_METRICS = {
    "rs10_4.encode": {
        "producer": ("ec_read_ms.encode", "codec_submit_ms.encode",
                     "ec_queue_wait_ms.encode"),
        "writer": ("ec_write_ms.encode", "codec_wait_ms.encode")},
    "clay10_4.rebuild": {
        "sequence": ("ec_read_ms.rebuild", "codec_submit_ms.rebuild",
                     "codec_wait_ms.rebuild", "ec_write_ms.rebuild")},
    "rs10_4.degraded_read": {
        "sequence": ("ec_read_ms.degraded", "codec_submit_ms.degraded",
                     "codec_wait_ms.degraded", "needle_parse_ms.degraded")},
}
STAGE_METRICS["clay10_4.degraded_read"] = \
    STAGE_METRICS["rs10_4.degraded_read"]


def _names(cell):
    return {m for group in STAGE_METRICS[cell].values() for m in group}


def test_benchmark_lists_each_stage_metric_where_it_reads():
    bench, _, _, _ = harness.load_cell(CELLS[0])
    listed = {m["name"]: set(m["workloads"]) for m in bench["per_layer"]
              if m["source"] == "program_counter"
              and m["name"].split(".")[0].endswith("_ms")
              and m["name"].split(".")[0] != "codec_call_ms"}
    for cell in CELLS:
        assert {n for n, cells in listed.items() if cell in cells} \
            == _names(cell)


def _mean_op_ms(run):
    """The mean operation's time in the window: a job from its start to
    its return, or a read's latency."""
    secs = [r["latency_s"] if "latency_s" in r else r["end"] - r["began"]
            for r in run.records]
    return sum(secs) / len(secs) * 1e3


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_stages(cell, monkeypatch):
    seen = {}
    real = harness.load_module

    def spy(kind, name):
        mod = real(kind, name)
        if kind != "metrics":
            return mod

        def read(run):
            seen["run"] = run
            return mod.read(run)
        return types.SimpleNamespace(read=read)

    monkeypatch.setattr(harness, "load_module", spy)
    r = run_small(cell, trace=True)
    assert r["correct"] is True
    got = r["metrics"]
    assert _names(cell) <= set(got)
    for name in _names(cell):
        v = got[name]["value"]
        assert got[name]["unit"] == "ms" and math.isfinite(v) and v >= 0
    mean = _mean_op_ms(seen["run"])
    for group in STAGE_METRICS[cell].values():
        assert sum(got[n]["value"] for n in group) <= mean


@pytest.mark.parametrize("cell", ["rs10_4.encode", "rs10_4.degraded_read"])
def test_untraced_line_has_no_stage_metric(cell):
    r = run_small(cell)
    assert r["correct"] is True
    assert not _names(cell) & set(r["metrics"])
