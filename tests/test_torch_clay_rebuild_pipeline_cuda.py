"""The Clay single-loss rebuild's pipeline on a CUDA device: a shard of
several batches rebuilt through the fused repair kernel, with the writer
slowed so the producer runs ahead, equals the plain versions' rebuild on
the CPU byte for byte; and every queued batch keeps a staging buffer of
its own, unchanged from its gather until its windows are written.  Marked
`cuda`: each test skips without a CUDA device.  This file imports no jax,
so it runs on the card without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_clay_rebuild_pipeline_cuda.py
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch

import chip_smoke
from seaweedfs_tpu_torch.ops import clay_matrix
from seaweedfs_tpu_torch.storage import ec
from seaweedfs_tpu_torch.storage.ec import codes

pytestmark = pytest.mark.cuda

ALPHA = clay_matrix.code(10, 4).alpha
SMALL = ALPHA * 128
GEO = ec.EcGeometry(10, 4, large_block_size=1 << 20,
                    small_block_size=SMALL, code_kind="clay")
WINDOWS = 8                  # the volume in small rows, a little over
BATCH = 2 * SMALL            # batches of two windows


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused repair kernel runs "
                    "only there")
    return torch.device("cuda")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _watch_pipeline(monkeypatch, delay=0.02):
    """Slow rebuild_clay's writer, and check in it that every queued
    batch's staging tensor holds, when the writer takes it and after its
    windows are written, the bytes it held when it was queued.  Returns
    the list of the queued tensors' addresses."""
    real = codes._pipelined
    queued = []

    def pipelined(produce, consume, backend, op):
        def tagged():
            for item in produce:
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


@pytest.mark.parametrize("lost", [0, 3, 12, 13])
def test_pipelined_rebuild_on_the_card_equals_plain(dev, tmp_path,
                                                    monkeypatch, lost):
    card, plain = str(tmp_path / "card" / "1"), str(tmp_path / "plain" / "1")
    os.makedirs(os.path.dirname(card))
    chip_smoke.build_volume(card, WINDOWS * 10 * SMALL - 5000, seed=29,
                            max_size=24 * 1024)
    ec.encode_volume_to_ec(card, 3, GEO, ec.ClayWindowCodec(GEO,
                                                            device="cpu"))
    shutil.copytree(os.path.dirname(card), os.path.dirname(plain))
    want = _read(card + ec.to_ext(lost))
    batches = -(-len(want) // BATCH)
    assert batches >= 3
    for b in (card, plain):
        os.remove(b + ec.to_ext(lost))
    ec.rebuild_ec_files(plain, codec=ec.ClayWindowCodec(GEO, device="cpu"),
                        batch_bytes=BATCH)
    queued = _watch_pipeline(monkeypatch)
    stats = {}
    assert ec.rebuild_ec_files(card, codec=ec.ClayWindowCodec(GEO,
                                                              device=dev),
                               batch_bytes=BATCH, stats=stats) == [lost]
    assert stats["plan_kind"] == "clay-plane-fused"
    assert len(queued) == batches
    # a batch is gathered while the one before it is in flight
    assert all(a != b for a, b in zip(queued, queued[1:]))
    assert _read(card + ec.to_ext(lost)) == _read(plain + ec.to_ext(lost)) \
        == want
