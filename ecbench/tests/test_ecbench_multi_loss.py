"""The four-shard RS rebuild cell (drivers/multi_loss_rebuild_jobs.py) on
the CPU at a small size: the program comes out correct with exactly the
cell's end-to-end metrics and checks, a traced run reports its stage
metrics within the mean job, the control comes out not correct, and the
driver refuses what it has no read plan for."""

import json
import math
import os
import types

import pytest

from ecbench import harness
from ecbench.tests.helpers import SEED, SMALL

CELL = "rs10_4.rebuild"
OVERRIDES = {**SMALL, "lost_sets": [[1, 4, 8, 12]]}
STAGES = {"producer": ("ec_read_ms.rebuild", "codec_submit_ms.rebuild",
                       "ec_queue_wait_ms.rebuild"),
          "writer": ("ec_write_ms.rebuild", "codec_wait_ms.rebuild")}


def run_small(**kw) -> dict:
    return harness.run_cell(CELL, SEED, 1.0, kw.pop("trace", False),
                            device="cpu", overrides=OVERRIDES, **kw)


def test_cell_is_correct_with_its_metrics_and_checks():
    r = run_small()
    json.dumps(r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"rebuild_gbps", "setup_s"}
    for m in r["metrics"].values():
        assert m["value"] > 0
    assert r["checks"] == {"shards_differing": {"value": 0, "limit": 0},
                           "read_bytes_off_plan": {"value": 0, "limit": 0}}


def test_traced_run_reports_the_stages(monkeypatch):
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
    r = run_small(trace=True)
    assert r["correct"] is True
    got = r["metrics"]
    names = {n for group in STAGES.values() for n in group}
    # no device here: the roofline and idle readers find nothing
    assert set(got) == names
    for name in names:
        v = got[name]["value"]
        assert got[name]["unit"] == "ms" and math.isfinite(v) and v >= 0
    assert got["ec_read_ms.rebuild"]["value"] > 0
    run = seen["run"]
    mean = sum(r["end"] - r["began"] for r in run.records) \
        / len(run.records) * 1e3
    for group in STAGES.values():
        assert sum(got[n]["value"] for n in group) <= mean


def test_control_is_not_correct():
    r = run_small(system="control")
    assert r["correct"] is False
    assert r["checks"]["shards_differing"]["value"] > 0
    assert r["checks"]["read_bytes_off_plan"]["value"] == 0


def test_a_read_off_plan_is_not_correct(monkeypatch):
    """A rebuild that reads one shard more than the plan fails the read
    check alone."""
    from ecbench import system
    real = system.Program.rebuild

    def one_more(self, base):
        stats = real(self, base)
        return {**stats,
                "bytes_read": stats["bytes_read"]
                + os.path.getsize(base + ".ec00")}

    monkeypatch.setattr(system.Program, "rebuild", one_more)
    r = run_small()
    assert r["correct"] is False
    assert r["checks"]["shards_differing"]["value"] == 0
    assert r["checks"]["read_bytes_off_plan"]["value"] > 0


def _config(name):
    with open(os.path.join(harness.HERE, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("config,lost_sets,match", [
    ("clay10_4", [[1, 4, 8, 12]], "code kind 'rs' only"),
    ("rs10_4", [[1, 4, 8, 12, 13]], "lost set"),
    ("rs10_4", [[1, 1]], "lost set"),
    ("rs10_4", [[14]], "lost set"),
    ("rs10_4", [[]], "lost set")])
def test_driver_refuses_what_it_has_no_plan_for(tmp_path, config,
                                                lost_sets, match):
    driver = harness.load_module("drivers", "multi_loss_rebuild_jobs")
    run = harness.Run(CELL, {}, _config(config),
                      {**OVERRIDES, "lost_sets": lost_sets}, SEED, 1.0,
                      False, "cpu", str(tmp_path), system=None)
    with pytest.raises(ValueError, match=match):
        driver.prepare(run)
    assert os.listdir(tmp_path) == []
