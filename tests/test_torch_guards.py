"""Guards of the PyTorch port's boundaries: it loads no jax and nothing of
seaweedfs_tpu, it never moves to the CPU by itself, its kernel wrappers
count only real launches and launch under the tensor's device, and
chip_smoke.py refuses to run without a CUDA device.  Import checks run in
a subprocess: this test process already holds jax (tests/conftest.py
imports it)."""

import ast
import math
import os
import pathlib
import shutil
import subprocess
import sys
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.ops import clay_cuda, rs_cuda, rs_matrix
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
        "import seaweedfs_tpu_torch.parallel.mesh_codec\n"
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


class FakeCudaTensor:
    """What the launch wrappers read of a contiguous uint8 tensor on
    `device`; it holds no memory."""

    def __init__(self, shape, device):
        self.shape = torch.Size(shape)
        self.device = torch.device(device)
        self.dtype = torch.uint8

    def dim(self):
        return len(self.shape)

    def numel(self):
        return math.prod(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 4096

    def reshape(self, *shape):
        assert math.prod(shape) == self.numel()
        return FakeCudaTensor(shape, self.device)


@pytest.fixture()
def fake_cuda():
    """The CUDA runtime as the launch wrappers see it, with no GPU: a
    kernel library that records each launch with the thread's current
    device at that moment, torch.cuda.device as a guard that sets that
    device, and one stream per device (handle 100 + index).  The current
    device is cuda:0 outside any guard."""
    rec = SimpleNamespace(current=torch.device("cuda", 0), launches=[],
                          entered=[])

    class Guard:
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            self.prev, rec.current = rec.current, self.dev
            rec.entered.append(self.dev)

        def __exit__(self, *exc):
            rec.current = self.prev

    def entry(name):
        def launch(*args):
            rec.launches.append((name, rec.current, args[-1]))
            return 0
        return launch

    lib = SimpleNamespace(
        gf2_matmul_smem_bytes=lambda *a: 1024,
        clay_fused_smem_bytes=lambda *a: 1024,
        gf2_matmul_bits=entry("gf2_matmul"),
        clay_fused_encode=entry("clay_fused_encode"),
        clay_fused_repair=entry("clay_fused_repair"))
    with mock.patch.object(rs_cuda, "_kernel_lib", lambda: lib), \
            mock.patch.object(clay_cuda, "_kernel_lib", lambda: lib), \
            mock.patch("torch.cuda.device", Guard), \
            mock.patch("torch.cuda.current_stream",
                       lambda dev: SimpleNamespace(
                           cuda_stream=100 + torch.device(dev).index)), \
            mock.patch("torch.cuda.get_device_properties",
                       lambda dev: SimpleNamespace(
                           multi_processor_count=132)), \
            mock.patch("torch.empty", lambda shape, dtype, device:
                       FakeCudaTensor(shape, device)):
        yield rec


@pytest.mark.parametrize("index", [1, 3])
def test_launches_run_under_the_tensors_device(fake_cuda, index):
    """Each wrapper's C entry (its cudaFuncSetAttribute and <<<>>> act on
    the current device) is called with the tensor's device current and
    that device's stream, while cuda:0 is current outside; the device is
    restored after."""
    dev = f"cuda:{index}"
    c = clay_cuda
    rs_cuda.gf_matmul_bits_cuda(FakeCudaTensor((32, 80), dev),
                                FakeCudaTensor((10, 4096), dev))
    rs_cuda.gf_matmul_bits_vm_cuda(FakeCudaTensor((32, 80), dev),
                                   FakeCudaTensor((2, 10, 4096), dev))
    rs_cuda.gf_matmul_bits_cols_cuda(FakeCudaTensor((32, 96), dev),
                                     FakeCudaTensor((12, 4, 128), dev))
    c.clay_fused_encode(FakeCudaTensor((32, 96), dev),
                        FakeCudaTensor((10, 2, 256, 16), dev), q=4, t=4,
                        gamma=2, det_inv=3)
    c.clay_fused_repair(FakeCudaTensor((32, 96), dev),
                        FakeCudaTensor((13, 2, 64, 16), dev), k=10, q=4,
                        t=4, lost=3, gamma=2, inv_gamma=142)
    want = torch.device("cuda", index)
    assert [name for name, _, _ in fake_cuda.launches] == [
        "gf2_matmul"] * 3 + ["clay_fused_encode", "clay_fused_repair"]
    for name, current, stream in fake_cuda.launches:
        assert current == want, name
        assert stream == 100 + index, name
    assert fake_cuda.entered == [want] * 5
    assert fake_cuda.current == torch.device("cuda", 0)


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
