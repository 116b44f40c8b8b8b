"""Guards of the PyTorch port's boundaries: it loads no jax and nothing of
seaweedfs_tpu, it never moves to the CPU by itself, its kernel wrapper
counts only real launches, and chip_smoke.py refuses to run without a
CUDA device.  Import checks run in a subprocess: this test process already
holds jax (tests/conftest.py imports it)."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.ops import rs_cuda, rs_matrix
from seaweedfs_tpu_torch.ops.codec import RSCodec

# one intra-op thread: the plain torch versions are small here, and a
# thread per core would crowd the other test workers on this host
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "seaweedfs_tpu_torch"


def _run(args, cwd, timeout=120):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_import_loads_no_jax_and_no_reference_package():
    probe = (
        "import sys\n"
        "import seaweedfs_tpu_torch, seaweedfs_tpu_torch.storage.ec\n"
        "import seaweedfs_tpu_torch.ops.codec\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'seaweedfs_tpu' or m.startswith('seaweedfs_tpu.')]\n"
        "print(repr(bad))\n")
    res = _run(["-c", probe], cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_no_jax_and_no_reference_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top != "jax", (path, mod)
        assert top != "seaweedfs_tpu", (path, mod)   # the port is _torch


def test_codec_default_device_needs_cuda():
    if torch.cuda.is_available():
        assert RSCodec().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        RSCodec()


def test_cpu_tensor_takes_plain_path_and_counts_no_launch():
    planes = rs_cuda.matrix_planes(rs_matrix.generator_matrix(10, 4)[10:])
    data = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (10, 100), dtype=np.uint8))
    before = rs_cuda.launches.value
    out = rs_cuda.gf_matmul_bits_cuda(planes, data)
    assert out.device.type == "cpu" and out.shape == (4, 100)
    assert rs_cuda.launches.value == before


def _assert_refused(res):
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    _assert_refused(_run(["chip_smoke.py"], cwd=REPO))


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _assert_refused(_run(["chip_smoke.py"], cwd=tmp_path))
