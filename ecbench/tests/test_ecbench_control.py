"""The control (the reference in the program's place with one guarantee
broken, control/system.py) comes out not correct in every cell; the same
harness with the program comes out correct (test_ecbench_result.py)."""

import pytest

from ecbench.tests.helpers import CELLS, run_small


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = run_small(cell, system="control")
    assert r["correct"] is False
    broken = {n for n, c in r["checks"].items() if c["value"] > c["limit"]}
    want = {"rs10_4.encode": {"shard_files_differing"},
            "clay10_4.rebuild": {"shards_differing",
                                 "read_bytes_off_plan"},
            "rs10_4.degraded_read": {"answers_differing"},
            "clay10_4.degraded_read": {"answers_differing"}}[cell]
    assert want <= broken
