"""The port's EC storage path (seaweedfs_tpu_torch.storage) against the JAX
package, on the CPU and on disk: the same .dat/.idx go through both
packages' encode, and the shard files, .ecx and .vif must be byte-identical;
rebuilds, fleet batches, degraded reads and decode must give back the
original bytes.  A shrunken geometry (16 KiB large / 1 KiB small blocks,
as tests/test_ec.py uses) runs both the large-row and the small-row paths.
"""

import json
import os
import random
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from seaweedfs_tpu.ops.codec import RSCodec as RefCodec
from seaweedfs_tpu.storage import crc as ref_crc
from seaweedfs_tpu.storage import ec as ref_ec
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.ttl import TTL as RefTTL
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu_torch.ops.codec import RSCodec
from seaweedfs_tpu_torch.storage import crc, ec
from seaweedfs_tpu_torch.storage.ec.layout import EcGeometry
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.ttl import TTL

# one intra-op thread: the plain torch versions are small here, and a
# thread per core would crowd the other test workers on this host
torch.set_num_threads(1)

GEO = EcGeometry(data_shards=10, parity_shards=4,
                 large_block_size=16 * 1024, small_block_size=1024)
REF_GEO = ref_ec.EcGeometry(data_shards=10, parity_shards=4,
                            large_block_size=16 * 1024,
                            small_block_size=1024)
SIDE_FILES = [ec.to_ext(s) for s in range(14)] + [".ecx", ".vif"]


@pytest.fixture(scope="module")
def codec():
    return RSCodec(10, 4, device="cpu")


@pytest.fixture(scope="module")
def ref_codec():
    return RefCodec(10, 4, backend="numpy")


def make_volume(directory, vid=7, n_needles=60, seed=1234):
    """A volume written by the JAX package (spans one 160 KiB large row
    plus small rows), with two deletes so .ecx sees tombstones."""
    rng = random.Random(seed)
    v = Volume(directory, "", vid)
    needles = {}
    for i in range(1, n_needles + 1):
        data = bytes(rng.getrandbits(8)
                     for _ in range(rng.randint(1, 8000)))
        n = RefNeedle(id=i, cookie=rng.getrandbits(32), data=data)
        v.write_needle(n)
        needles[i] = (n.cookie, data)
    for i in (3, 17):
        v.delete_needle(i)
        del needles[i]
    v.close()
    return needles


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture()
def twin_volumes(tmp_path):
    """The same .dat/.idx in a 'ref' and a 'port' directory."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    needles = make_volume(str(ref_dir))
    shutil.copytree(ref_dir, port_dir)
    return str(ref_dir), str(port_dir), needles


def test_encode_files_byte_identical(twin_volumes, codec, ref_codec):
    ref_dir, port_dir, _ = twin_volumes
    ref_base, base = os.path.join(ref_dir, "7"), os.path.join(port_dir, "7")
    assert os.path.getsize(base + ".dat") > GEO.large_row_size()
    ref_ec.encode_volume_to_ec(ref_base, 3, REF_GEO, ref_codec)
    ec.encode_volume_to_ec(base, 3, GEO, codec)
    for ext in SIDE_FILES:
        assert _read(base + ext) == _read(ref_base + ext), ext
    assert json.loads(_read(base + ".vif"))["dat_size"] == \
        os.path.getsize(base + ".dat")


@pytest.mark.parametrize("lost", [[5], [0, 13], [1, 4, 10], [0, 7, 10, 13]])
def test_rebuild_byte_identical(twin_volumes, codec, lost):
    _, port_dir, _ = twin_volumes
    base = os.path.join(port_dir, "7")
    ec.encode_volume_to_ec(base, 3, GEO, codec)
    want = {s: _read(base + ec.to_ext(s)) for s in lost}
    for s in lost:
        os.remove(base + ec.to_ext(s))
    assert ec.rebuild_ec_files(base, codec=codec, batch_bytes=4096) == lost
    for s in lost:
        assert _read(base + ec.to_ext(s)) == want[s], s


def test_rebuild_noop_and_too_many_lost(twin_volumes, codec):
    _, port_dir, _ = twin_volumes
    base = os.path.join(port_dir, "7")
    ec.encode_volume_to_ec(base, 3, GEO, codec)
    assert ec.rebuild_ec_files(base, GEO, codec) == []
    for s in range(5):
        os.remove(base + ec.to_ext(s))
    with pytest.raises(ValueError):
        ec.rebuild_ec_files(base, GEO, codec)


def _raw_volumes(directory, sizes, seed):
    rng = np.random.default_rng(seed)
    bases = []
    for vid, size in enumerate(sizes, start=7):
        base = os.path.join(directory, str(vid))
        with open(base + ".dat", "wb") as f:
            f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        bases.append(base)
    return bases


def test_fleet_encode_and_rebuild_batch(tmp_path, codec, ref_codec):
    """encode_ec_files_batch / rebuild_ec_files_batch: three same-size
    volumes share grouped [V, k, width] dispatches, one odd-sized volume
    takes the single path; shards equal the JAX package's."""
    sizes = [GEO.large_row_size() + 25 * GEO.small_row_size() + 700] * 3 \
        + [GEO.small_row_size()]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    ref_bases = _raw_volumes(str(ref_dir), sizes, 5)
    bases = _raw_volumes(str(port_dir), sizes, 5)
    ref_ec.encode_ec_files_batch(ref_bases, REF_GEO, ref_codec,
                                 batch_bytes=8192)
    ec.encode_ec_files_batch(bases, GEO, codec, batch_bytes=8192)
    for base, ref_base, size in zip(bases, ref_bases, sizes):
        for s in range(14):
            assert _read(base + ec.to_ext(s)) == \
                _read(ref_base + ec.to_ext(s)), (base, s)
        ec.save_volume_info(base, 3, dat_size=size,
                            data_shards=10, parity_shards=4,
                            large_block_size=GEO.large_block_size,
                            small_block_size=GEO.small_block_size)
    originals = {}
    for base in bases:
        for s in (2, 5, 11):
            originals[(base, s)] = _read(base + ec.to_ext(s))
            os.remove(base + ec.to_ext(s))
    out = ec.rebuild_ec_files_batch(bases, batch_bytes=4096, codec=codec)
    for base in bases:
        assert out[base] == [2, 5, 11]
    for (base, s), want in originals.items():
        assert _read(base + ec.to_ext(s)) == want, (base, s)


def test_degraded_reads_return_written_payloads(twin_volumes, codec):
    _, port_dir, needles = twin_volumes
    base = os.path.join(port_dir, "7")
    ec.encode_volume_to_ec(base, 3, GEO, codec)
    for s in (1, 4, 12):
        os.remove(base + ec.to_ext(s))
    ev = ec.EcVolume(port_dir, "", 7, codec=codec)
    for s in range(14):
        if s not in (1, 4, 12):
            ev.add_shard(s)
    degraded = 0
    for nid, (cookie, data) in needles.items():
        _, _, intervals = ev.locate_ec_shard_needle(nid)
        degraded += any(iv.to_shard_id_and_offset(GEO)[0] in (1, 4)
                        for iv in intervals)
        assert ev.read_needle(nid, cookie).data == data
    assert degraded > 5
    with pytest.raises(ec.EcNotFoundError):
        ev.read_needle(3)
    ev.delete_shard(0)
    ev.delete_shard(2)
    with pytest.raises(ec.EcShardUnavailableError):
        for nid in needles:
            ev.read_needle(nid)
    ev.close()


def test_remote_reader_serves_missing_local_shards(twin_volumes, codec):
    _, port_dir, needles = twin_volumes
    base = os.path.join(port_dir, "7")
    ec.encode_volume_to_ec(base, 3, GEO, codec)
    remote = {s: _read(base + ec.to_ext(s)) for s in (0, 1, 2)}
    calls = []

    def remote_reader(vid, sid, off, size):
        calls.append(sid)
        return remote[sid][off:off + size]

    ev = ec.EcVolume(port_dir, "", 7, codec=codec,
                     remote_reader=remote_reader)
    for s in range(3, 14):
        ev.add_shard(s)
    assert ev.shard_bits().shard_ids() == list(range(3, 14))
    for nid, (cookie, data) in needles.items():
        assert ev.read_needle(nid, cookie).data == data
    assert calls
    ev.close()


def test_delete_journal_matches_reference(twin_volumes, codec, ref_codec):
    """delete_needle tombstones .ecx in place and appends .ecj; a reopen
    replays it; rebuild_ecx_file folds it in — files equal the JAX
    package's after the same deletes."""
    ref_dir, port_dir, needles = twin_volumes
    ref_base, base = os.path.join(ref_dir, "7"), os.path.join(port_dir, "7")
    ref_ec.encode_volume_to_ec(ref_base, 3, REF_GEO, ref_codec)
    ec.encode_volume_to_ec(base, 3, GEO, codec)
    victims = sorted(needles)[:3]
    ev = ec.EcVolume(port_dir, "", 7, codec=codec)
    ref_ev = ref_ec.EcVolume(ref_dir, "", 7, REF_GEO, ref_codec)
    for s in range(14):
        ev.add_shard(s)
    for nid in victims:
        ev.delete_needle(nid)
        ref_ev.delete_needle(nid)
        with pytest.raises(ec.EcNotFoundError):
            ev.read_needle(nid)
    ev.close()
    ref_ev.close()
    for ext in (".ecx", ".ecj"):
        assert _read(base + ext) == _read(ref_base + ext), ext
    reopened = ec.EcVolume(port_dir, "", 7, codec=codec)
    with pytest.raises(ec.EcNotFoundError):
        reopened.find_needle_from_ecx(victims[0])
    reopened.close()
    ec.rebuild_ecx_file(base)
    ref_ec.rebuild_ecx_file(ref_base)
    assert not os.path.exists(base + ".ecj")
    assert _read(base + ".ecx") == _read(ref_base + ".ecx")


def test_decode_to_volume_round_trips(twin_volumes, codec, ref_codec):
    ref_dir, port_dir, needles = twin_volumes
    ref_base, base = os.path.join(ref_dir, "7"), os.path.join(port_dir, "7")
    original = _read(base + ".dat")
    ref_ec.encode_volume_to_ec(ref_base, 3, REF_GEO, ref_codec)
    ec.encode_volume_to_ec(base, 3, GEO, codec)
    for b in (ref_base, base):
        os.remove(b + ".dat")
        os.remove(b + ".idx")
    for s in (2, 9):
        os.remove(base + ec.to_ext(s))
    ec.decode_ec_to_volume(base, codec=codec)
    ref_ec.decode_ec_to_volume(ref_base, REF_GEO)
    got = _read(base + ".dat")
    assert got == _read(ref_base + ".dat")
    assert got[:len(original)] == original or original[:len(got)] == got
    assert _read(base + ".idx") == _read(ref_base + ".idx")
    v = Volume(port_dir, "", 7)
    for nid, (cookie, data) in needles.items():
        assert v.read_needle(nid, cookie).data == data
    v.close()


@pytest.mark.parametrize("kind", ["lrc"])
def test_unported_code_kinds_raise(tmp_path, codec, kind):
    geo = EcGeometry(code_kind=kind, lrc_locals=2 if kind == "lrc" else 0)
    base = str(tmp_path / "7")
    with open(base + ".dat", "wb") as f:
        f.write(b"\0" * 64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ec.write_ec_files(base, geo)


# -- needle bytes and checksums --------------------------------------------

def _needle_specs(seed=42, count=24):
    rng = np.random.default_rng(seed)
    for i in range(count):
        spec = {"id": int(rng.integers(1, 1 << 63)),
                "cookie": int(rng.integers(0, 1 << 32)),
                "data": rng.bytes(int(rng.integers(0, 3000))),
                "append_at_ns": int(rng.integers(0, 1 << 62))}
        if i % 2:
            spec.update(name=b"n%d.bin" % i, mime=b"application/x-test",
                        pairs=b'{"Seaweed-a":"b"}', last_modified=1700000000 + i,
                        ttl=(i % 7 + 1, "3d"))
        yield spec


def _build(cls, ttl_cls, spec):
    n = cls(id=spec["id"], cookie=spec["cookie"], data=spec["data"],
            append_at_ns=spec["append_at_ns"])
    if "name" in spec:
        n.set_name(spec["name"])
        n.set_mime(spec["mime"])
        n.set_pairs(spec["pairs"])
        n.set_last_modified(spec["last_modified"])
        n.set_ttl(ttl_cls.parse(spec["ttl"][1]))
    return n


@pytest.fixture(params=["native", "python"])
def crc_path(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(crc, "_native", None)
        monkeypatch.setattr(crc, "_native_tried", True)
    else:
        assert crc.native_crc32c() is not None, "g++ build of crc32c.cpp"
    return request.param


@pytest.mark.parametrize("version", [1, 2, 3])
def test_needle_bytes_identical_to_reference(crc_path, version):
    for spec in _needle_specs():
        want = _build(RefNeedle, RefTTL, spec).to_bytes(version)
        n = _build(Needle, TTL, spec)
        got = n.to_bytes(version)
        assert got == want
        back = Needle()
        back.read_bytes(got, 0, n.size, version)
        assert back.data == spec["data"] and back.id == spec["id"]


def test_crc_identical_to_reference(crc_path):
    rng = np.random.default_rng(8)
    for size in (0, 1, 7, 8, 9, 63, 1000, 65537):
        buf = rng.bytes(size)
        assert crc.crc32c(buf) == ref_crc.crc32c(buf)
        assert crc.masked_value(crc.crc32c(buf)) == \
            ref_crc.needle_checksum(buf)


def test_smoke_volume_builder_reads_back_in_reference(tmp_path):
    """chip_smoke.build_volume writes through the port's Needle, idx and
    SuperBlock; the JAX package's Volume must read every needle back."""
    base = str(tmp_path / "9")
    needles = chip_smoke.build_volume(base, 200 * 1024, seed=1,
                                      max_size=16 * 1024)
    with open(base + ".dat", "rb") as f:
        dat = f.read()
    v = Volume(str(tmp_path), "", 9)
    for nid, off, size in needles:
        start = off + 20
        assert v.read_needle(nid).data == dat[start:start + size]
    v.close()
