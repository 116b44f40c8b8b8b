"""Every cell runs on the CPU at a small size and is correct, and its
result line has exactly the contract's keys."""

import json

import pytest
import torch

from ecbench import harness
from ecbench.tests.helpers import CELLS, run_small

KEYS = ["correct", "attempted", "failed", "metrics", "device",
        "setup_built", "checks"]


def _metric_names(cell, trace):
    bench, _, _, _ = harness.load_cell(cell)
    return {m["name"] for m in harness.metrics_of(bench, cell, trace)}


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_keys(cell):
    r = run_small(cell)
    json.dumps(r)
    assert list(r) == KEYS
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == _metric_names(cell, False)
    assert "setup_s" in r["metrics"]
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_traced_result_line_keys():
    r = run_small("rs10_4.degraded_read", trace=True)
    assert list(r) == KEYS[:5] + ["breakdown"] + KEYS[5:]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: the trace readers find nothing and stay out
    assert set(r["metrics"]) <= _metric_names("rs10_4.degraded_read", True)


def test_every_cell_has_its_metrics():
    bench, _, _, _ = harness.load_cell(CELLS[0])
    for w in bench["workloads"]:
        e2e = _metric_names(w["name"], False)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert _metric_names(w["name"], True)
    for m in bench["per_layer"]:
        harness.load_module("metrics", m["name"])
        for cell in m["workloads"]:
            assert m["moves"] in _metric_names(cell, False)
    for m in bench["end_to_end"]:
        harness.load_module("metrics", m["name"])


def test_run_refuses_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from ecbench import run
    assert run.main(["--workload", "rs10_4.encode", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""
