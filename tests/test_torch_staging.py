"""Bulk batches gathered straight into the dispatch's host staging
(`ops.codec.staging`).  write_ec_files, rebuild_ec_files' RS branch and the
Clay single-loss rebuild stay byte-identical to the JAX package, and every
byte they hand the codec is counted as staged by the caller
(seaweedfs_codec_staged_bytes_total{path="direct"}); a degraded read keeps
the copy into staging (path="copied").  Behind a slow writer, no gathered
batch changes before its window has been written.
"""

import os
import time

import numpy as np
import pytest
import torch

import chip_smoke
from seaweedfs_tpu.ops.codec import RSCodec as RefCodec
from seaweedfs_tpu.storage import ec as ref_ec
from seaweedfs_tpu_torch.ops import clay_matrix, codec as codec_mod
from seaweedfs_tpu_torch.ops.codec import RSCodec
from seaweedfs_tpu_torch.storage import ec
from seaweedfs_tpu_torch.storage.ec import encoder, pipeline

# one intra-op thread: the plain torch versions are small here, and a
# thread per core would crowd the other test workers on this host
torch.set_num_threads(1)

GEO = ec.EcGeometry(10, 4, large_block_size=16 * 1024,
                    small_block_size=1024)
REF_GEO = ref_ec.EcGeometry(10, 4, large_block_size=16 * 1024,
                            small_block_size=1024)
ALPHA = clay_matrix.code(10, 4).alpha
CLAY_GEO = ec.EcGeometry(10, 4, large_block_size=1 << 20,
                         small_block_size=ALPHA * 16, code_kind="clay")
REF_CLAY_GEO = ref_ec.EcGeometry(10, 4, large_block_size=1 << 20,
                                 small_block_size=ALPHA * 16,
                                 code_kind="clay")

# .dat sizes: small rows only, one large row then small rows, and small
# rows ending in a partial row
SIZES = {"small_rows": 5 * GEO.small_row_size(),
         "large_row": GEO.large_row_size() + 3 * GEO.small_row_size(),
         "partial_row": 2 * GEO.small_row_size() + 700}


@pytest.fixture(scope="module")
def codec():
    return RSCodec(10, 4, device="cpu")


@pytest.fixture(scope="module")
def ref_codec():
    return RefCodec(10, 4, backend="numpy")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _twin_dat(tmp_path, size, seed):
    """The same random .dat under 'ref' and 'port': (ref_base, base)."""
    data = np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()
    bases = []
    for name in ("ref", "port"):
        (tmp_path / name).mkdir()
        bases.append(str(tmp_path / name / "1"))
        with open(bases[-1] + ".dat", "wb") as f:
            f.write(data)
    return bases


class Staged:
    """Bytes counted under seaweedfs_codec_staged_bytes_total{backend, op}
    since construction, by path."""

    def __init__(self, backend, op):
        self.m, self.labels = codec_mod.codec_metrics().staged, (backend, op)
        self.start = self.now()

    def now(self):
        return {p: self.m.value(*self.labels, p)
                for p in ("direct", "copied")}

    def __call__(self):
        now = self.now()
        return {p: now[p] - self.start[p] for p in now}


def test_staging_on_the_cpu_is_plain_memory():
    for device in ("cpu", torch.device("cpu")):
        buf = codec_mod.staging(device, (3, 5))
        assert buf.dtype == torch.uint8 and tuple(buf.shape) == (3, 5)
        assert buf.device.type == "cpu" and not buf.is_pinned()
        view = buf.numpy()
        view[...] = 7
        assert int(buf.sum()) == 7 * 15


def _encode_counted(codec, x):
    """(parity of x, the staged bytes of its encode by path)."""
    staged = Staged("rs_torch", "encode")
    return codec.encode(x), staged()


@pytest.mark.parametrize("bad", ["dtype", "strided"])
def test_dispatch_refuses_a_tensor_it_cannot_upload(codec, bad):
    """A tensor of another dtype or layout is refused the direct path: it
    is copied, as an array is, and the parity is the same."""
    data = np.random.default_rng(4).integers(0, 256, (10, 64),
                                             dtype=np.uint8)
    x = torch.from_numpy(data.astype(np.int16)) if bad == "dtype" \
        else torch.from_numpy(np.repeat(data, 2, axis=1))[:, ::2]
    parity, staged = _encode_counted(codec, x)
    assert np.array_equal(parity, codec.encode(data))
    assert staged == {"direct": 0, "copied": data.nbytes}


@pytest.mark.parametrize("form", ["staged", "array"])
def test_dispatch_uploads_staging_as_it_is(codec, form):
    """A contiguous uint8 host tensor is uploaded as it is (direct); an
    array goes the copy path (copied)."""
    data = np.random.default_rng(5).integers(0, 256, (10, 64),
                                             dtype=np.uint8)
    want = codec.encode(data)
    x = torch.from_numpy(data.copy()) if form == "staged" else data
    parity, staged = _encode_counted(codec, x)
    assert np.array_equal(parity, want)
    if form == "staged":
        assert staged == {"direct": data.nbytes, "copied": 0}
        assert codec_mod.host_staged(torch.device("cpu"), x) is x
    else:
        assert staged == {"direct": 0, "copied": data.nbytes}


@pytest.mark.parametrize("kind", sorted(SIZES))
def test_encode_gathers_into_staging(tmp_path, codec, ref_codec, kind):
    ref_base, base = _twin_dat(tmp_path, SIZES[kind], seed=len(kind))
    staged = Staged("rs_torch", "encode")
    ref_ec.write_ec_files(ref_base, REF_GEO, ref_codec, batch_bytes=4096)
    ec.write_ec_files(base, GEO, codec, batch_bytes=4096)
    for s in range(14):
        assert _read(base + ec.to_ext(s)) == _read(ref_base + ec.to_ext(s)), s
    shard = os.path.getsize(base + ec.to_ext(0))
    assert shard == GEO.shard_file_size(SIZES[kind])
    assert staged() == {"direct": 10 * shard, "copied": 0}


@pytest.mark.parametrize("lost", [[1, 4, 8, 12], [5]])
def test_rs_rebuild_gathers_into_staging(tmp_path, codec, ref_codec, lost):
    ref_base, base = _twin_dat(tmp_path, SIZES["large_row"], seed=3)
    ref_ec.write_ec_files(ref_base, REF_GEO, ref_codec)
    ec.write_ec_files(base, GEO, codec)
    want = {s: _read(base + ec.to_ext(s)) for s in lost}
    for s in lost:
        os.remove(base + ec.to_ext(s))
        os.remove(ref_base + ec.to_ext(s))
    staged, stats = Staged("rs_torch", "reconstruct"), {}
    assert ec.rebuild_ec_files(base, GEO, codec, batch_bytes=4096,
                               stats=stats) == lost
    ref_ec.rebuild_ec_files(ref_base, REF_GEO, ref_codec, batch_bytes=4096)
    for s in lost:
        assert _read(base + ec.to_ext(s)) == want[s] \
            == _read(ref_base + ec.to_ext(s)), s
    shard = os.path.getsize(base + ec.to_ext(0))
    assert staged() == {"direct": 10 * shard, "copied": 0}
    assert stats["bytes_read"] == 10 * shard


def test_clay_single_loss_rebuild_gathers_into_staging(tmp_path):
    size = 3 * CLAY_GEO.small_row_size() + 999
    ref_base, base = _twin_dat(tmp_path, size, seed=21)
    clay = ec.ClayWindowCodec(CLAY_GEO, device="cpu")
    batch = 2 * CLAY_GEO.small_block_size       # two windows per call
    staged = Staged("clay", "encode")
    ref_ec.write_ec_files(ref_base, REF_CLAY_GEO, batch_bytes=batch)
    ec.write_ec_files(base, CLAY_GEO, clay, batch_bytes=batch)
    shard = os.path.getsize(base + ec.to_ext(0))
    assert staged() == {"direct": 10 * shard, "copied": 0}
    lost = 3
    want = _read(base + ec.to_ext(lost))
    for b in (base, ref_base):
        os.remove(b + ec.to_ext(lost))
    staged, stats = Staged("clay", "reconstruct"), {}
    assert ec.rebuild_ec_files(base, CLAY_GEO, clay, batch_bytes=batch,
                               stats=stats) == [lost]
    ref_ec.rebuild_ec_files(ref_base, REF_CLAY_GEO, batch_bytes=batch)
    assert stats["plan_kind"] == "clay-plane-fused"
    assert _read(base + ec.to_ext(lost)) == want \
        == _read(ref_base + ec.to_ext(lost))
    assert staged() == {"direct": stats["bytes_read"], "copied": 0}
    assert stats["bytes_read"] * 40 == 13 * 10 * shard


def test_degraded_read_copies_into_staging(tmp_path, codec):
    base = str(tmp_path / "1")
    needles = chip_smoke.build_volume(base, 3 * GEO.small_row_size(),
                                      seed=5, max_size=4096)
    ec.encode_volume_to_ec(base, 3, GEO, codec)
    gone = [3]
    os.remove(base + ec.to_ext(3))
    ev = chip_smoke.open_ec_volume(str(tmp_path), 1, GEO, gone, codec=codec)
    staged = Staged("rs_torch", "reconstruct")
    res = chip_smoke.degraded_reads(ev, base + ".dat", needles, GEO, gone,
                                    reads=8, seed=6)
    ev.close()
    assert res["degraded_intervals"] > 0
    got = staged()
    assert got["direct"] == 0 and got["copied"] > 0


def _watch_pipeline(monkeypatch, delay=0.01):
    """Make _pipelined's writer slow, and check in it that every item's
    gathered batch (its first element) holds, when the writer takes it and
    after its window is written, the bytes it held when it was queued.
    Returns the list of items written."""
    real = encoder._pipelined
    written = []

    def pipelined(produce, consume, backend, op):
        def tagged():
            for item in produce:
                yield item, np.array(item[0], copy=True)

        def slow(entry):
            item, queued = entry
            time.sleep(delay)
            assert np.array_equal(np.asarray(item[0]), queued)
            consume(item)
            assert np.array_equal(np.asarray(item[0]), queued)
            written.append(queued.shape)
        real(tagged(), slow, backend, op)
    monkeypatch.setattr(encoder, "_pipelined", pipelined)
    return written


@pytest.mark.parametrize("path", ["encode", "rebuild"])
def test_slow_writer_sees_every_batch_as_gathered(tmp_path, codec, ref_codec,
                                                  monkeypatch, path):
    """A writer slower than the producer: the producer runs PIPELINE_DEPTH
    batches ahead, each in a staging buffer of its own, so none is
    overwritten before its shards are written."""
    ref_base, base = _twin_dat(tmp_path, SIZES["large_row"], seed=8)
    ref_ec.write_ec_files(ref_base, REF_GEO, ref_codec)
    lost = [1, 4, 8, 12]
    if path == "rebuild":
        ec.write_ec_files(base, GEO, codec)
        for s in lost:
            os.remove(base + ec.to_ext(s))
    written = _watch_pipeline(monkeypatch)
    if path == "encode":
        ec.write_ec_files(base, GEO, codec, batch_bytes=1024)
    else:
        assert ec.rebuild_ec_files(base, GEO, codec, batch_bytes=1024) \
            == lost
    assert len(written) > 2 * (pipeline.PIPELINE_DEPTH + 2)
    for s in range(14):
        assert _read(base + ec.to_ext(s)) == _read(ref_base + ec.to_ext(s)), s
