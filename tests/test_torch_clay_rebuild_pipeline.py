"""The Clay single-loss rebuild's pipeline (storage/ec/codes.rebuild_clay
over storage/ec/pipeline._pipelined), on the CPU: a shard of several
batches is gathered, repaired and appended in batch order, byte-equal to
the JAX package's rebuild of the same volume, with the same read
accounting; the ec_queue_wait stage is observed once per batch and once
for the drain; a write that fails on the writer thread reaches the caller
and leaves no thread behind; and `repair` is `repair_begin`'s fetch."""

import builtins
import os
import shutil
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from seaweedfs_tpu.storage import ec as ref_ec
from seaweedfs_tpu_torch.ops import clay_matrix, codec as codec_mod
from seaweedfs_tpu_torch.storage import ec
from seaweedfs_tpu_torch.storage.ec import codes

# one intra-op thread: the plain torch versions are small here, and a
# thread per core would crowd the other test workers on this host
torch.set_num_threads(1)

ALPHA = clay_matrix.code(10, 4).alpha
SMALL = ALPHA * 128
GEO = ec.EcGeometry(10, 4, large_block_size=1 << 20,
                    small_block_size=SMALL, code_kind="clay")
REF_GEO = ref_ec.EcGeometry(10, 4, large_block_size=1 << 20,
                            small_block_size=SMALL, code_kind="clay")
WINDOWS = 8                  # small blocks per shard: 8 small rows
BATCH = 3 * SMALL            # batches of 3, 3 and 2 windows
BATCHES = 3


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """One needle volume of 8 small rows encoded by the JAX package; the
    port's encode of it is byte-identical (tests/test_torch_clay.py)."""
    root = tmp_path_factory.mktemp("clay_pipeline")
    chip_smoke.build_volume(str(root / "1"), WINDOWS * 10 * SMALL - 5000,
                            seed=23, max_size=24 * 1024)
    ref_ec.encode_volume_to_ec(str(root / "1"), 3, REF_GEO)
    return str(root)


@pytest.fixture()
def volumes(encoded, tmp_path):
    """Fresh copies of the encoded volume: (port base, reference base)."""
    shutil.copytree(encoded, tmp_path / "port")
    shutil.copytree(encoded, tmp_path / "ref")
    return str(tmp_path / "port" / "1"), str(tmp_path / "ref" / "1")


def _queue_waits():
    return codec_mod.codec_metrics().ec_queue_wait._totals.get(
        ("clay", "rebuild"), 0)


def _op_observations():
    return codec_mod.codec_metrics().seconds._totals.get(
        ("clay", "reconstruct"), 0)


@pytest.mark.parametrize("lost", [0, 3, 12, 13])
def test_pipelined_single_loss_matches_reference(volumes, lost):
    base, ref_base = volumes
    assert os.path.getsize(base + ec.to_ext(0)) == WINDOWS * SMALL
    want = _read(base + ec.to_ext(lost))
    for b in (base, ref_base):
        os.remove(b + ec.to_ext(lost))
    waits, ops = _queue_waits(), _op_observations()
    stats, ref_stats = {}, {}
    assert ec.rebuild_ec_files(base, codec=ec.ClayWindowCodec(
        GEO, device="cpu"), batch_bytes=BATCH, stats=stats) == [lost]
    assert _queue_waits() - waits == BATCHES + 1
    assert _op_observations() - ops == 1
    ref_ec.rebuild_ec_files(ref_base, REF_GEO, batch_bytes=BATCH,
                            stats=ref_stats)
    assert _read(base + ec.to_ext(lost)) == \
        _read(ref_base + ec.to_ext(lost)) == want
    assert stats == {"bytes_read": ref_stats["bytes_read"],
                     "plan_kind": "clay-plane-fused",
                     "helpers": ref_stats["helpers"],
                     "layers_per_helper": ALPHA // 4}
    # 13 helpers x beta = alpha/4 layers: 13/40 of RS's k whole shards
    assert stats["bytes_read"] * 40 == 13 * 10 * WINDOWS * SMALL


class _FailingFile:
    """A shard file whose second write raises."""

    def __init__(self, f):
        self.f, self.writes = f, 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.f.close()
        return False

    def write(self, data):
        self.writes += 1
        if self.writes == 2:
            raise OSError("injected write failure")
        return self.f.write(data)


def test_writer_failure_reaches_the_caller(volumes, monkeypatch):
    """The second batch's write raises on the writer thread: the rebuild
    raises that error, and returns, with the writer joined."""
    base, _ = volumes
    os.remove(base + ec.to_ext(5))
    monkeypatch.setattr(codes, "open", lambda path, mode="r":
                        _FailingFile(builtins.open(path, mode)),
                        raising=False)
    raised = []

    def rebuild():
        try:
            ec.rebuild_ec_files(base, codec=ec.ClayWindowCodec(
                GEO, device="cpu"), batch_bytes=BATCH)
        except OSError as e:
            raised.append(e)

    t = threading.Thread(target=rebuild, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "the rebuild hung on its writer"
    assert [str(e) for e in raised] == ["injected write failure"]
    assert not [w for w in threading.enumerate() if w.name == "ec-writer"]


@pytest.mark.parametrize("lost", [0, 9, 10, 13])
def test_repair_is_repair_begin_fetched(lost):
    """`repair` returns what `repair_begin`'s fetch() returns, for an
    array and for a staging tensor, and neither observes the codec's op
    histogram (the rebuild observes once per rebuild)."""
    codec = ec.ClayWindowCodec(GEO, device="cpu")
    x = np.random.default_rng(lost).integers(
        0, 256, (13, 2, ALPHA // 4, SMALL // ALPHA), dtype=np.uint8)
    staged = codec_mod.staging("cpu", x.shape)
    staged.numpy()[...] = x
    ops = _op_observations()
    got = codec.repair(lost, x)
    assert got.shape == (2, ALPHA, SMALL // ALPHA)
    assert np.array_equal(codec.repair_begin(lost, x)(), got)
    assert np.array_equal(codec.repair_begin(lost, staged)(), got)
    assert np.array_equal(codec.repair(lost, staged), got)
    assert _op_observations() == ops
