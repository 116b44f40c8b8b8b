"""The LRC rebuild's pipeline (storage/ec/codes.rebuild_lrc over
storage/ec/pipeline._pipelined), on the CPU, at LRC(12,2,2): a shard of
several windows is gathered into staging, rebuilt and appended in window
order, byte-equal to the JAX package's rebuild of the same volume, for
every single loss and for a two- and a three-loss pattern, with the same
read accounting; every input byte is uploaded from the caller's staging
(seaweedfs_codec_staged_bytes_total{lrc, reconstruct, direct}); the
ec_queue_wait stage is observed once per window and once for the drain,
the op histogram once per rebuild; a write that fails on the writer
thread reaches the caller and leaves no thread behind; and
`reconstruct_begin` computes what `gf_apply` does."""

import builtins
import os
import shutil
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from seaweedfs_tpu.storage import ec as ref_ec
from seaweedfs_tpu_torch.ops import codec as codec_mod
from seaweedfs_tpu_torch.ops import lrc
from seaweedfs_tpu_torch.storage import ec
from seaweedfs_tpu_torch.storage.ec import codes

# one intra-op thread: the plain torch versions are small here, and a
# thread per core would crowd the other test workers on this host
torch.set_num_threads(1)

SMALL = 4096
KW = dict(large_block_size=1 << 20, small_block_size=SMALL,
          code_kind="lrc", lrc_locals=2)
GEO = ec.EcGeometry(12, 4, **KW)
REF_GEO = ref_ec.EcGeometry(12, 4, **KW)
ROWS = 4                     # the volume in small rows, a little over
BATCH = 6 * 1024             # windows of 6 KiB, the last one short


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """One needle volume of 4 small rows encoded by the JAX package; the
    port's encode of it is byte-identical (tests/test_torch_lrc12.py)."""
    root = tmp_path_factory.mktemp("lrc_pipeline")
    chip_smoke.build_volume(str(root / "1"), ROWS * 12 * SMALL - 3000,
                            seed=31, min_size=256, max_size=6 * 1024)
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
        ("lrc", "rebuild"), 0)


def _op_observations():
    return codec_mod.codec_metrics().seconds._totals.get(
        ("lrc", "reconstruct"), 0)


def _staged():
    m = codec_mod.codec_metrics().staged
    return {p: m.value("lrc", "reconstruct", p)
            for p in ("direct", "copied")}


def _rebuild_both(base, ref_base, lost, batch):
    """Remove `lost` from both copies and rebuild each through its
    package: (port stats, reference stats, the lost shards' bytes before
    the loss, the port's counters' growth)."""
    want = {s: _read(base + ec.to_ext(s)) for s in lost}
    for b in (base, ref_base):
        for s in lost:
            os.remove(b + ec.to_ext(s))
    waits, ops, staged = _queue_waits(), _op_observations(), _staged()
    stats, ref_stats = {}, {}
    assert ec.rebuild_ec_files(base, GEO, ec.LrcWindowCodec(
        GEO, device="cpu"), batch_bytes=batch, stats=stats) == sorted(lost)
    after = _staged()
    grown = {"queue_waits": _queue_waits() - waits,
             "ops": _op_observations() - ops,
             "staged": {p: after[p] - staged[p] for p in after}}
    ref_ec.rebuild_ec_files(ref_base, REF_GEO, batch_bytes=batch,
                            stats=ref_stats)
    return stats, ref_stats, want, grown


def _check(base, ref_base, lost, batch):
    stats, ref_stats, want, grown = _rebuild_both(base, ref_base, lost,
                                                  batch)
    size = os.path.getsize(base + ec.to_ext(0))
    assert size % SMALL == 0 and size % BATCH and size > 2 * BATCH
    for s in lost:
        assert _read(base + ec.to_ext(s)) == \
            _read(ref_base + ec.to_ext(s)) == want[s], s
    assert stats == {"bytes_read": ref_stats["bytes_read"],
                     "read_shards": ref_stats["read_shards"],
                     "plan_kind": ref_stats["plan_kind"]}
    assert stats["bytes_read"] == len(stats["read_shards"]) * size
    assert grown == {"queue_waits": -(-size // batch) + 1, "ops": 1,
                     "staged": {"direct": stats["bytes_read"],
                                "copied": 0}}
    return stats


@pytest.mark.parametrize("lost", range(16))
def test_single_loss_matches_reference(volumes, lost):
    """Each lost shard restored from its local group (6 reads) or, for
    the globals 14 and 15, from the 12 data shards, in several windows."""
    stats = _check(*volumes, [lost], BATCH)
    assert stats["plan_kind"] == ("local" if lost < 14 else "global")
    assert len(stats["read_shards"]) == (6 if lost < 14 else 12)


@pytest.mark.parametrize("lost", [[1, 14], [0, 7, 13]])
def test_multi_loss_matches_reference(volumes, lost):
    """A two- and a three-loss pattern: one global solve, the same loop."""
    _check(*volumes, lost, BATCH)


@pytest.mark.parametrize("batch", [SMALL, 5000, 3 * SMALL, 1 << 20])
def test_window_sizes_give_the_same_bytes(volumes, batch):
    """Windows that divide the shard, leave a short last window (5000),
    or hold the whole shard in one."""
    _check(*volumes, [3], batch)


class _FailingFile:
    """A shard file whose second write raises."""

    def __init__(self, f):
        self.f, self.writes = f, 0

    def close(self):
        self.f.close()

    def write(self, data):
        self.writes += 1
        if self.writes == 2:
            raise OSError("injected write failure")
        return self.f.write(data)


def test_writer_failure_reaches_the_caller(volumes, monkeypatch):
    """The second window's write raises on the writer thread: the rebuild
    raises that error, and returns, with the writer joined."""
    base, _ = volumes
    os.remove(base + ec.to_ext(5))
    monkeypatch.setattr(codes, "open", lambda path, mode="r":
                        _FailingFile(builtins.open(path, mode)),
                        raising=False)
    raised = []

    def rebuild():
        try:
            ec.rebuild_ec_files(base, GEO, ec.LrcWindowCodec(
                GEO, device="cpu"), batch_bytes=BATCH)
        except OSError as e:
            raised.append(e)

    t = threading.Thread(target=rebuild, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "the rebuild hung on its writer"
    assert [str(e) for e in raised] == ["injected write failure"]
    assert not [w for w in threading.enumerate() if w.name == "ec-writer"]


@pytest.mark.parametrize("missing", [[3], [14], [1, 14], [0, 7, 13]])
def test_reconstruct_begin_is_gf_apply(missing):
    """`reconstruct_begin(M, x)()` equals `gf_apply(M, x)` for a plan's
    matrix, for an array (counted copied) and for a staging tensor
    (counted direct), and neither observes the codec's op histogram."""
    plan = lrc.plan_repair(lrc.LrcGeometry(12, 2, 2), missing)
    x = np.random.default_rng(len(missing)).integers(
        0, 256, (len(plan.read_shards), 777), dtype=np.uint8)
    want = codec_mod.gf_apply(plan.matrix, x, device="cpu")
    assert want.shape == (len(missing), 777)
    codec = ec.LrcWindowCodec(GEO, device="cpu")
    staged = codec_mod.staging("cpu", x.shape)
    staged.numpy()[...] = x
    ops, before = _op_observations(), _staged()
    assert np.array_equal(codec.reconstruct_begin(plan.matrix, x)(), want)
    assert np.array_equal(codec.reconstruct_begin(plan.matrix, staged)(),
                          want)
    after = _staged()
    assert {p: after[p] - before[p] for p in after} == {
        "direct": x.nbytes, "copied": x.nbytes}
    assert _op_observations() == ops

