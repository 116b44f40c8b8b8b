"""The LRC(12,2,2) configuration and its two companions on the CPU at a
small size: the lrc kind's module has the four hooks, its read plan
follows the local groups and its control generator is MDS with an
identity top; `lrc12_2_2.rebuild` and `clay10_4.encode` come out correct
with exactly their end-to-end metrics and checks; the control fails the
LRC rebuild on both checks; a traced LRC rebuild reports every stage
metric that lists it, `ec_plan_ms.rebuild` included."""

import itertools
import json
import math
import os
import types

import numpy as np
import pytest

from ecbench import harness
from ecbench.reference import codes, gf256
from ecbench.tests.helpers import SEED, SMALL

HOOKS = ("parity_shards", "single_loss_read_bytes", "degraded_io_bytes",
         "control_generator")
CELL = "lrc12_2_2.rebuild"
# a local data, a local parity and a global parity loss
OVERRIDES = {**SMALL, "lost_order": [3, 12, 14]}
STAGES = ("ec_read_ms.rebuild", "codec_submit_ms.rebuild",
          "codec_wait_ms.rebuild", "ec_write_ms.rebuild",
          "ec_plan_ms.rebuild")


def _config(name):
    with open(os.path.join(harness.HERE, "configs", name + ".json")) as f:
        return json.load(f)


def run_cell(cell, overrides=OVERRIDES, **kw) -> dict:
    return harness.run_cell(cell, SEED, 1.0, kw.pop("trace", False),
                            device="cpu", overrides=overrides, **kw)


def _rank(rows: np.ndarray) -> int:
    """Rank over GF(2^8) by elimination."""
    a = [[int(v) for v in r] for r in rows]
    rank, cols = 0, len(a[0])
    for c in range(cols):
        p = next((r for r in range(rank, len(a)) if a[r][c]), None)
        if p is None:
            continue
        a[rank], a[p] = a[p], a[rank]
        s = gf256.inv(a[rank][c])
        a[rank] = [gf256.mul(v, s) for v in a[rank]]
        for r in range(len(a)):
            f = a[r][c]
            if r != rank and f:
                a[r] = [v ^ gf256.mul(f, w) for v, w in zip(a[r], a[rank])]
        rank += 1
    return rank


def test_the_lrc_module_has_the_hooks_and_an_mds_control():
    c = _config("lrc12_2_2")
    mod = codes.of(c)
    assert mod.__name__.endswith(".lrc")
    for hook in HOOKS:
        assert callable(getattr(mod, hook))
    gen = mod.control_generator(c)
    assert gen.shape == (16, 12)
    assert np.array_equal(gen[:12], np.eye(12, dtype=np.uint8))
    # MDS: every square submatrix of the parity block is invertible, so
    # every 12 of the 16 rows are
    par = gen[12:]
    for size in range(1, 5):
        for rows in itertools.combinations(range(4), size):
            for cols in itertools.combinations(range(12), size):
                assert _rank(par[np.ix_(rows, cols)]) == size


def test_the_lrc_generator_and_read_plan():
    c = _config("lrc12_2_2")
    mod = codes.of(c)
    gen = mod.generator(c)
    assert np.array_equal(gen[12], [1] * 6 + [0] * 6)
    assert np.array_equal(gen[13], [0] * 6 + [1] * 6)
    assert [int(v) for v in gen[14]] == list(range(1, 13))
    assert [int(v) for v in gen[15]] == [gf256.mul(v, v)
                                         for v in range(1, 13)]
    shard = 43 << 20
    for lost in range(16):
        reads = 6 if lost < 14 else 12
        assert mod.single_loss_read_bytes(c, lost, shard) == reads * shard
        assert mod.degraded_io_bytes(c, lost, 100) == (reads + 1) * 100
    # every 3 losses recoverable: the 13 survivors have rank 12
    for lost in itertools.combinations(range(16), 3):
        keep = [s for s in range(16) if s not in lost]
        assert _rank(gen[keep]) == 12, lost


@pytest.mark.parametrize("cell,overrides,checks", [
    (CELL, OVERRIDES, ("shards_differing", "read_bytes_off_plan")),
    ("clay10_4.encode", SMALL,
     ("shard_files_differing", "ecx_files_differing"))])
def test_cell_is_correct_with_its_metrics_and_checks(cell, overrides,
                                                     checks):
    r = run_cell(cell, overrides)
    json.dumps(r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    rate = "rebuild_gbps" if cell == CELL else "encode_gbps"
    assert set(r["metrics"]) == {rate, "setup_s"}
    for m in r["metrics"].values():
        assert m["value"] > 0
    assert r["checks"] == {name: {"value": 0, "limit": 0}
                           for name in checks}


def test_control_is_not_correct():
    """The control reads 12 whole shards with Cauchy's matrix: every
    restored shard differs, and each local repair reads 6 shards too
    many."""
    r = run_cell(CELL, system="control")
    assert r["correct"] is False
    assert r["checks"]["shards_differing"]["value"] == r["attempted"]
    assert r["checks"]["read_bytes_off_plan"]["value"] > 0


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
    r = run_cell(CELL, trace=True)
    assert r["correct"] is True
    got = r["metrics"]
    # no device here: the roofline and idle readers find nothing
    assert set(got) == set(STAGES)
    for name in STAGES:
        v = got[name]["value"]
        assert got[name]["unit"] == "ms" and math.isfinite(v) and v >= 0
    assert got["ec_plan_ms.rebuild"]["value"] > 0
    run = seen["run"]
    assert run.counter_delta("seaweedfs_ec_plan_seconds_count", "lrc",
                             "rebuild") == len(run.records)
    mean = sum(r["end"] - r["began"] for r in run.records) \
        / len(run.records) * 1e3
    assert sum(got[n]["value"] for n in STAGES) <= mean
