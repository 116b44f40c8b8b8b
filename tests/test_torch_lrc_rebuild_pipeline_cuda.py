"""The LRC rebuild's pipeline on a CUDA device, at LRC(12,2,2): a shard of
several windows rebuilt through the GF(2^8) kernel, one launch a window,
with the writer slowed so the producer runs ahead, equals the plain
versions' rebuild on the CPU byte for byte, for every lost shard 0-15 and
a three-loss pattern; every input byte is uploaded from pinned staging
(seaweedfs_codec_staged_bytes_total{lrc, reconstruct, direct}); and every
queued window keeps a staging buffer of its own, unchanged from its
gather until its rows are written.  Marked `cuda`: each test skips
without a CUDA device.  This file imports no jax, so it runs on the card
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_lrc_rebuild_pipeline_cuda.py
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch

import chip_smoke
from seaweedfs_tpu_torch.ops import codec as codec_mod
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.storage import ec
from seaweedfs_tpu_torch.storage.ec import codes

pytestmark = pytest.mark.cuda

SMALL = 64 * 1024
GEO = ec.EcGeometry(12, 4, large_block_size=1 << 30, small_block_size=SMALL,
                    code_kind="lrc", lrc_locals=2)
ROWS = 4                     # the volume in small rows, a little over
BATCH = 96 * 1024            # windows of 96 KiB, the last one short


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the GF(2^8) kernel runs only "
                    "there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def encoded(dev, tmp_path_factory):
    """One needle volume encoded by the plain versions on the CPU."""
    root = tmp_path_factory.mktemp("lrc_pipeline_cuda")
    base = str(root / "1")
    chip_smoke.build_volume(base, ROWS * 12 * SMALL - 5000, seed=37,
                            max_size=48 * 1024)
    ec.encode_volume_to_ec(base, 3, GEO, ec.LrcWindowCodec(GEO,
                                                           device="cpu"))
    return str(root)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _staged():
    m = codec_mod.codec_metrics().staged
    return {p: m.value("lrc", "reconstruct", p)
            for p in ("direct", "copied")}


def _watch_pipeline(monkeypatch, delay=0.02):
    """Slow rebuild_lrc's writer, and check in it that every queued
    window's staging tensor holds, when the writer takes it and after its
    rows are written, the bytes it held when it was queued.  Returns the
    list of the queued tensors' addresses."""
    real = codes._pipelined
    queued = []

    def pipelined(produce, consume, backend, op):
        def tagged():
            for item in produce:
                assert item[0].is_pinned()
                queued.append(item[0].data_ptr())
                yield item, item[0].numpy().copy()

        def slow(entry):
            item, gathered = entry
            time.sleep(delay)
            assert np.array_equal(item[0].numpy(), gathered)
            consume(item)
            assert np.array_equal(item[0].numpy(), gathered)
        real(tagged(), slow, backend, op)
    monkeypatch.setattr(codes, "_pipelined", pipelined)
    return queued


@pytest.mark.parametrize("lost", [[s] for s in range(16)] + [[0, 7, 13]])
def test_pipelined_rebuild_on_the_card_equals_plain(dev, encoded, tmp_path,
                                                    monkeypatch, lost):
    card, plain = str(tmp_path / "card" / "1"), str(tmp_path / "plain" / "1")
    shutil.copytree(encoded, os.path.dirname(card))
    shutil.copytree(encoded, os.path.dirname(plain))
    want = {s: _read(card + ec.to_ext(s)) for s in lost}
    windows = -(-len(want[lost[0]]) // BATCH)
    assert windows >= 3 and len(want[lost[0]]) % BATCH
    for b in (card, plain):
        for s in lost:
            os.remove(b + ec.to_ext(s))
    ec.rebuild_ec_files(plain, GEO, ec.LrcWindowCodec(GEO, device="cpu"),
                        batch_bytes=BATCH)
    queued = _watch_pipeline(monkeypatch)
    stats, staged, launches = {}, _staged(), rs_cuda.launches.value
    assert ec.rebuild_ec_files(card, GEO, ec.LrcWindowCodec(GEO, device=dev),
                               batch_bytes=BATCH, stats=stats) == lost
    after = _staged()
    assert {p: after[p] - staged[p] for p in after} == {
        "direct": stats["bytes_read"], "copied": 0}
    assert rs_cuda.launches.value - launches == windows
    assert len(queued) == windows
    # a window is gathered while the one before it is in flight
    assert all(a != b for a, b in zip(queued, queued[1:]))
    for s in lost:
        assert _read(card + ec.to_ext(s)) == _read(plain + ec.to_ext(s)) \
            == want[s], s
