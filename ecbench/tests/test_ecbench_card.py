"""On a CUDA card: one short run of each cell through the benchmark's
command (`python3 ecbench/run.py`), with its result line.  Skips without
a card (decided here, not at import).  Run on the card with
`python3 -m pytest ecbench/tests -m cuda`."""

import json
import os
import subprocess
import sys

import pytest

from ecbench import harness
from ecbench.tests.helpers import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this host")
    out = subprocess.run(
        [sys.executable, os.path.join("ecbench", "run.py"), "--workload",
         cell, "--seed", "2147483651", "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
