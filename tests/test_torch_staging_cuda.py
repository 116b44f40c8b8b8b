"""Bulk batches gathered straight into pinned staging on a CUDA device:
the buffer `ops.codec.staging` hands out is page-locked, an encode and an
RS rebuild upload only staged bytes (seaweedfs_codec_staged_bytes_total
{path="direct"}), an RS degraded read copies into staging (path="copied"),
and the shards equal the plain versions' on the CPU.  Marked `cuda`: each
test skips without a CUDA device.  This file imports no jax, so it runs on
the card without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_staging_cuda.py
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from seaweedfs_tpu_torch.ops import codec as codec_mod
from seaweedfs_tpu_torch.ops.codec import RSCodec
from seaweedfs_tpu_torch.storage import ec

pytestmark = pytest.mark.cuda

# 1 KiB small blocks, 16 KiB large ones: a large row, then small rows
GEO = ec.EcGeometry(10, 4, large_block_size=16 * 1024,
                    small_block_size=1024)
LOST = [1, 4, 8, 12]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned staging exists only there")
    return torch.device("cuda")


def _staged(backend, op):
    m = codec_mod.codec_metrics().staged
    return {p: m.value(backend, op, p) for p in ("direct", "copied")}


def _delta(before, after):
    return {p: after[p] - before[p] for p in before}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_staging_is_pinned_on_the_card(dev):
    buf = codec_mod.staging(dev, (10, 4096))
    assert buf.is_pinned() and buf.dtype == torch.uint8
    assert not codec_mod.staging("cpu", (10, 4096)).is_pinned()


def test_dispatch_refuses_pageable_staging(dev):
    """A tensor that is not pinned is refused the direct path: it is
    copied, as an array is."""
    data = np.random.default_rng(9).integers(0, 256, (10, 4096),
                                             dtype=np.uint8)
    before = _staged("rs_cuda", "encode")
    parity = RSCodec(10, 4, device=dev).encode(torch.from_numpy(data))
    assert _delta(before, _staged("rs_cuda", "encode")) == {
        "direct": 0, "copied": data.nbytes}
    assert np.array_equal(parity,
                          RSCodec(10, 4, device="cpu").encode(data))


def test_mesh_batches_are_pinned_on_the_card(dev):
    """A mesh codec's batches are gathered into pinned staging of its
    first device, resident across jobs like a single device's."""
    from seaweedfs_tpu_torch.parallel.mesh_codec import (MeshCodec,
                                                         default_ec_mesh)
    codec = MeshCodec(mesh=default_ec_mesh([dev] * 4))
    assert codec_mod.staging(codec.device, (10, 4096)).is_pinned()


def test_encode_and_rebuild_upload_only_staged_bytes(dev, tmp_path):
    size = GEO.large_row_size() + 5 * GEO.small_row_size() + 700
    data = np.random.default_rng(15).integers(0, 256, size, dtype=np.uint8)
    bases = []
    for name in ("cpu", "cuda"):
        (tmp_path / name).mkdir()
        bases.append(str(tmp_path / name / "1"))
        data.tofile(bases[-1] + ".dat")
    plain, base = bases
    ec.write_ec_files(plain, GEO, RSCodec(10, 4, device="cpu"),
                      batch_bytes=4096)
    codec = RSCodec(10, 4, device=dev)
    before = _staged("rs_cuda", "encode")
    ec.write_ec_files(base, GEO, codec, batch_bytes=4096)
    shard = os.path.getsize(base + ec.to_ext(0))
    assert _delta(before, _staged("rs_cuda", "encode")) == {
        "direct": 10 * shard, "copied": 0}
    for s in range(14):
        assert _read(base + ec.to_ext(s)) == _read(plain + ec.to_ext(s)), s
    for s in LOST:
        os.remove(base + ec.to_ext(s))
    before, stats = _staged("rs_cuda", "reconstruct"), {}
    assert ec.rebuild_ec_files(base, GEO, codec, batch_bytes=4096,
                               stats=stats) == LOST
    assert _delta(before, _staged("rs_cuda", "reconstruct")) == {
        "direct": stats["bytes_read"], "copied": 0}
    assert stats["bytes_read"] == 10 * shard
    for s in LOST:
        assert _read(base + ec.to_ext(s)) == _read(plain + ec.to_ext(s)), s


def test_degraded_read_copies_into_staging(dev, tmp_path):
    base = str(tmp_path / "1")
    needles = chip_smoke.build_volume(base, 3 * GEO.small_row_size(),
                                      seed=5, max_size=4096)
    codec = RSCodec(10, 4, device=dev)
    ec.encode_volume_to_ec(base, 3, GEO, codec)
    gone = [3]
    os.remove(base + ec.to_ext(3))
    ev = chip_smoke.open_ec_volume(str(tmp_path), 1, GEO, gone, codec=codec)
    before = _staged("rs_cuda", "reconstruct")
    res = chip_smoke.degraded_reads(ev, base + ".dat", needles, GEO, gone,
                                    reads=8, seed=6)
    ev.close()
    assert res["degraded_intervals"] > 0
    got = _delta(before, _staged("rs_cuda", "reconstruct"))
    assert got["direct"] == 0 and got["copied"] > 0


def test_clay_single_loss_rebuild_uploads_only_staged_bytes(dev, tmp_path):
    from seaweedfs_tpu_torch.ops import clay_matrix
    small = clay_matrix.code(10, 4).alpha * 16
    geo = ec.EcGeometry(10, 4, large_block_size=1 << 20,
                        small_block_size=small, code_kind="clay")
    data = np.random.default_rng(21).integers(
        0, 256, 3 * geo.small_row_size() + 999, dtype=np.uint8)
    bases = []
    for name in ("cpu", "cuda"):
        (tmp_path / name).mkdir()
        bases.append(str(tmp_path / name / "1"))
        data.tofile(bases[-1] + ".dat")
    plain, base = bases
    ec.write_ec_files(plain, geo, ec.ClayWindowCodec(geo, device="cpu"),
                      batch_bytes=2 * small)
    codec = ec.ClayWindowCodec(geo, device=dev)
    ec.write_ec_files(base, geo, codec, batch_bytes=2 * small)
    lost = 3
    os.remove(base + ec.to_ext(lost))
    before, stats = _staged("clay", "reconstruct"), {}
    assert ec.rebuild_ec_files(base, geo, codec, batch_bytes=2 * small,
                               stats=stats) == [lost]
    assert stats["plan_kind"] == "clay-plane-fused"
    assert _delta(before, _staged("clay", "reconstruct")) == {
        "direct": stats["bytes_read"], "copied": 0}
    for s in range(14):
        assert _read(base + ec.to_ext(s)) == _read(plain + ec.to_ext(s)), s
