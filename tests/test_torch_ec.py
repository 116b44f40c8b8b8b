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


@pytest.mark.parametrize("lost", [[5], [0, 13], [1, 4, 10], [0, 7, 10, 13],
                                  [1, 4, 8, 12], [10, 11, 12, 13]])
def test_rebuild_byte_identical(twin_volumes, codec, ref_codec, lost):
    """Every restored shard equals the one encoded and the JAX package's
    rebuild of the same loss."""
    ref_dir, port_dir, _ = twin_volumes
    base = os.path.join(port_dir, "7")
    ref_base = os.path.join(ref_dir, "7")
    ec.encode_volume_to_ec(base, 3, GEO, codec)
    ref_ec.encode_volume_to_ec(ref_base, 3, REF_GEO, ref_codec)
    want = {s: _read(base + ec.to_ext(s)) for s in lost}
    for s in lost:
        os.remove(base + ec.to_ext(s))
        os.remove(ref_base + ec.to_ext(s))
    assert ec.rebuild_ec_files(base, codec=codec, batch_bytes=4096) == lost
    assert ref_ec.rebuild_ec_files(ref_base, codec=ref_codec,
                                   batch_bytes=4096) == lost
    for s in lost:
        got = _read(base + ec.to_ext(s))
        assert got == want[s] == _read(ref_base + ec.to_ext(s)), s


@pytest.mark.parametrize("lost,volumes", [([3], 1), ([1, 4, 8, 12], 1),
                                          ([1, 4, 8, 12], 3)],
                         ids=["lost0", "lost1", "fleet"])
def test_rebuild_counts_the_bytes_it_gathers(twin_volumes, codec,
                                             ref_codec, lost, volumes,
                                             monkeypatch):
    """An RS rebuild's `bytes_read` is the sum of the survivors' windows
    handed to the codec, which is k whole shards, as the JAX package's
    rebuild reports.  A fleet rebuild of same-size volumes hands the codec
    k whole shards of each volume and no more."""
    ref_dir, port_dir, _ = twin_volumes
    bases = [os.path.join(port_dir, "7")]
    for v in range(1, volumes):
        bases.append(os.path.join(shutil.copytree(port_dir,
                                                  f"{port_dir}{v}"), "7"))
    ref_base = os.path.join(ref_dir, "7")
    for base in bases:
        ec.encode_volume_to_ec(base, 3, GEO, codec)
    ref_ec.encode_volume_to_ec(ref_base, 3, REF_GEO, ref_codec)
    shard = os.path.getsize(ref_base + ec.to_ext(0))
    for s in lost:
        for base in bases + [ref_base]:
            os.remove(base + ec.to_ext(s))
    handed = []
    real = codec.reconstruct_rows_begin

    def spy(survivors, used, targets, **kw):
        handed.append(survivors.nbytes)
        return real(survivors, used, targets, **kw)

    monkeypatch.setattr(codec, "reconstruct_rows_begin", spy)
    stats, ref_stats = {}, {}
    if volumes == 1:
        ec.rebuild_ec_files(bases[0], codec=codec, batch_bytes=4096,
                            stats=stats)
        assert stats["bytes_read"] == sum(handed)
    else:
        assert ec.rebuild_ec_files_batch(bases, batch_bytes=4096,
                                         codec=codec) \
            == dict.fromkeys(bases, lost)
    ref_ec.rebuild_ec_files(ref_base, codec=ref_codec, batch_bytes=4096,
                            stats=ref_stats)
    assert len(handed) == -(-shard // 4096)
    assert sum(handed) == volumes * 10 * shard \
        == volumes * ref_stats["bytes_read"]
    for base in bases:
        for s in lost:
            assert _read(base + ec.to_ext(s)) == \
                _read(ref_base + ec.to_ext(s)), (base, s)


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
    volumes share grouped [k, V * width] dispatches, one odd-sized volume
    is a group of its own; shards equal the JAX package's."""
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


@pytest.mark.parametrize("kind", ["bogus"])
def test_unported_code_kinds_raise(tmp_path, codec, kind):
    """A code kind neither package knows raises, in both."""
    base = str(tmp_path / "7")
    with open(base + ".dat", "wb") as f:
        f.write(b"\0" * 64)
    with pytest.raises(ValueError, match="unknown code_kind"):
        ec.write_ec_files(base, EcGeometry(code_kind=kind))
    with pytest.raises(ValueError, match="unknown code_kind"):
        ref_ec.write_ec_files(base, ref_ec.EcGeometry(code_kind=kind))


# -- EcVolume's maintenance surface (the store's calls) --------------------

def _public(cls):
    return sorted(n for n in dir(cls) if not n.startswith("_"))


@pytest.mark.parametrize("name", ["EcVolume", "EcVolumeShard"])
def test_ec_volume_public_methods_match_reference(name):
    assert _public(getattr(ec, name)) == _public(getattr(ref_ec, name))


def test_needle_has_the_methods_the_serving_path_reads():
    """Every public method of the JAX package's Needle but its file IO
    (append_to / read_from belong to the volume engine): a volume server
    reads an EC needle's etag and flags."""
    assert set(_public(RefNeedle)) - set(_public(Needle)) == \
        {"append_to", "read_from"}
    n = Needle(data=b"abc")
    n.set_is_compressed()
    ref = RefNeedle(data=b"abc")
    ref.set_is_compressed()
    got, want = n.to_bytes(3), ref.to_bytes(3)
    assert got == want
    n2, r2 = Needle(), RefNeedle()
    n2.read_bytes(got, 0, n.size, 3)
    r2.read_bytes(want, 0, ref.size, 3)
    assert (n2.etag(), n2.is_compressed(), n2.is_chunked_manifest()) == \
        (r2.etag(), r2.is_compressed(), r2.is_chunked_manifest())


def test_file_and_deleted_counts_match_reference(twin_volumes, codec,
                                                 ref_codec):
    ref_dir, port_dir, needles = twin_volumes
    ref_base, base = os.path.join(ref_dir, "7"), os.path.join(port_dir, "7")
    ref_ec.encode_volume_to_ec(ref_base, 3, REF_GEO, ref_codec)
    ec.encode_volume_to_ec(base, 3, GEO, codec)
    ev = ec.EcVolume(port_dir, "", 7, codec=codec)
    ref_ev = ref_ec.EcVolume(ref_dir, "", 7, REF_GEO, ref_codec)
    rng = np.random.default_rng(3)
    victims = [int(v) for v in rng.choice(sorted(needles), 7,
                                          replace=False)]
    # a repeat and an id the volume never held count nothing more
    for nid in victims + victims[:2] + [10 ** 9]:
        ev.delete_needle(nid)
        ref_ev.delete_needle(nid)
        assert (ev.file_count(), ev.deleted_count()) == \
            (ref_ev.file_count(), ref_ev.deleted_count())
    assert ev.deleted_count() == len(victims)
    assert ev.file_count() == len(needles) - len(victims)
    ev.close()
    ref_ev.close()


def test_destroy_removes_every_file_of_the_family(twin_volumes, codec,
                                                  ref_codec):
    """destroy removes .ecx, .ecj, .vif and every shard file, loaded or
    not, and leaves the same files behind as the JAX package's."""
    ref_dir, port_dir, needles = twin_volumes
    for d, pkg, geo, c in ((port_dir, ec, GEO, codec),
                           (ref_dir, ref_ec, REF_GEO, ref_codec)):
        pkg.encode_volume_to_ec(os.path.join(d, "7"), 3, geo, c)
        vol = pkg.EcVolume(d, "", 7, geo, c)
        for s in (0, 5, 13):
            vol.load_shard(s)
        vol.delete_needle(sorted(needles)[0])   # writes the .ecj
        assert os.path.exists(os.path.join(d, "7.ecj"))
        vol.destroy()
        assert not vol.shards
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir)) \
        == ["7.dat", "7.idx"]


def test_shard_destroy_removes_its_file(twin_volumes, codec):
    _, port_dir, _ = twin_volumes
    ec.encode_volume_to_ec(os.path.join(port_dir, "7"), 3, GEO, codec)
    shard = ec.EcVolumeShard(port_dir, "", 7, 4)
    shard.destroy()
    assert not os.path.exists(os.path.join(port_dir, "7.ec04"))
    assert os.path.exists(os.path.join(port_dir, "7.ec05"))


# -- a mixed fleet rebuild with an explicit codec ---------------------------

def test_fleet_rebuild_mixed_kinds_with_rs_codec(tmp_path, codec):
    """rebuild_ec_files_batch(codec=RSCodec) on RS, Clay(10,4) and
    LRC(10,2,2) volumes with shard 3 lost in each: the RS codec serves the
    RS volume, the others get codecs of their own on its device; every
    rebuilt shard equals the JAX package's encode."""
    from seaweedfs_tpu.ops.clay_matrix import code as ref_clay_code
    small = ref_clay_code(10, 4).alpha * 128
    kinds = {7: ("rs", 0), 8: ("clay", 0), 9: ("lrc", 2)}
    rng = np.random.default_rng(17)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    bases, golden = [], {}
    for vid, (kind, locals_) in kinds.items():
        geo = ref_ec.EcGeometry(10, 4, large_block_size=4 * small,
                                small_block_size=small, code_kind=kind,
                                lrc_locals=locals_)
        ref_base = str(ref_dir / str(vid))
        size = geo.small_row_size() + 333
        with open(ref_base + ".dat", "wb") as f:
            f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        ref_ec.write_ec_files(ref_base, geo,
                              RefCodec(10, 4, backend="numpy")
                              if kind == "rs" else None)
        ref_ec.save_volume_info(ref_base, 3, dat_size=size, data_shards=10,
                                parity_shards=4,
                                large_block_size=geo.large_block_size,
                                small_block_size=small, code_kind=kind,
                                lrc_locals=locals_)
        golden[vid] = _read(ref_base + ec.to_ext(3))
        bases.append(str(port_dir / str(vid)))
    shutil.copytree(ref_dir, port_dir)
    for base in bases:
        os.remove(base + ec.to_ext(3))
    out = ec.rebuild_ec_files_batch(bases, batch_bytes=small, codec=codec)
    for vid, base in zip(kinds, bases):
        assert out[base] == [3]
        assert _read(base + ec.to_ext(3)) == golden[vid], kinds[vid]


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
