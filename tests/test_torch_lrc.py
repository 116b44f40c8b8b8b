"""LRC on the port against the JAX package, byte for byte: the generator
matrices and repair plans of ops/lrc.py, the window codec, and the on-disk
path at LRC(10,2,2) (encode, single-loss and 2-loss rebuilds with their
read accounting, degraded reads with a group member unreachable, decode).
The shrunken geometry of tests/test_ec_codes.py (16 KiB large / 1 KiB small
blocks) runs both the large-row and the small-row paths.  Every input comes
from a numpy seed; every comparison is exact.
"""

import itertools
import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import lrc as ref_lrc
from seaweedfs_tpu.storage import ec as ref_ec
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu_torch.ops import gf256, lrc
from seaweedfs_tpu_torch.ops.codec import RSCodec
from seaweedfs_tpu_torch.storage import ec
from seaweedfs_tpu_torch.storage.ec.layout import EcGeometry

# one intra-op thread: the plain torch versions are small here, and a
# thread per core would crowd the other test workers on this host
torch.set_num_threads(1)

GEOMETRIES = [lrc.LrcGeometry(12, 2, 2), lrc.LrcGeometry(6, 2, 2),
              lrc.LrcGeometry(12, 3, 2), lrc.LrcGeometry(10, 2, 2)]
LRC_GEO = EcGeometry(data_shards=10, parity_shards=4,
                     large_block_size=16 * 1024, small_block_size=1024,
                     code_kind="lrc", lrc_locals=2)
REF_LRC_GEO = ref_ec.EcGeometry(data_shards=10, parity_shards=4,
                                large_block_size=16 * 1024,
                                small_block_size=1024, code_kind="lrc",
                                lrc_locals=2)
FAMILY = [ec.to_ext(s) for s in range(14)] + [".ecx", ".vif"]


def _ref_geo(g):
    return ref_lrc.LrcGeometry(g.k, g.l, g.r)


def _plan_or_error(mod, geo, missing, available=None):
    try:
        p = mod.plan_repair(geo, missing, available)
    except ValueError:
        return "unrecoverable"
    return p.kind, list(p.read_shards), p.matrix.tolist(), list(p.missing)


def _shards(geo, seed, B=256):
    data = np.random.default_rng(seed).integers(0, 256, (geo.k, B),
                                                dtype=np.uint8)
    return data, lrc.encode_shards(geo, data)


# -- ops/lrc.py --------------------------------------------------------------

@pytest.mark.parametrize("geo", GEOMETRIES, ids=str)
def test_generator_matrix_equals_reference(geo):
    G = lrc.generator_matrix(geo)
    assert G.dtype == np.uint8 and G.shape == (geo.n, geo.k)
    assert np.array_equal(G, ref_lrc.generator_matrix(_ref_geo(geo)))
    # local parity rows are the group XOR masks
    for g in range(geo.l):
        row = np.zeros(geo.k, dtype=np.uint8)
        row[geo.group_members(g)] = 1
        assert np.array_equal(G[geo.local_parity_index(g)], row)


@pytest.mark.parametrize("geo", GEOMETRIES, ids=str)
def test_plans_equal_reference_for_one_and_two_losses(geo):
    for size in (1, 2):
        for missing in itertools.combinations(range(geo.n), size):
            assert _plan_or_error(lrc, geo, list(missing)) == \
                _plan_or_error(ref_lrc, _ref_geo(geo), list(missing)), missing


def test_plans_equal_reference_over_survivors_that_answered():
    geo = lrc.LrcGeometry(10, 2, 2)
    for missing, gone in (([1], [2]), ([3], [10]), ([10], [0, 4]),
                          ([12], [13])):
        avail = [s for s in range(geo.n) if s not in missing + gone]
        assert _plan_or_error(lrc, geo, missing, avail) == \
            _plan_or_error(ref_lrc, _ref_geo(geo), missing, avail)


@pytest.mark.parametrize("geo", GEOMETRIES, ids=str)
def test_encode_shards_equal_reference(geo):
    data, shards = _shards(geo, seed=geo.k + geo.l)
    assert np.array_equal(shards,
                          ref_lrc.encode_shards(_ref_geo(geo), data))


def test_single_failures_repair_locally():
    geo = lrc.LrcGeometry(12, 2, 2)
    _, shards = _shards(geo, 0)
    for lost in (0, 5, 7, 11, 12, 13):
        plan = lrc.plan_repair(geo, [lost])
        assert plan.kind == "local"
        assert len(plan.read_shards) == geo.group_size
        got = lrc.repair(geo, plan, {s: shards[s] for s in plan.read_shards})
        assert np.array_equal(got[lost], shards[lost])
    plan = lrc.plan_repair(geo, [geo.k + geo.l])     # a global parity
    got = lrc.repair(geo, plan, {s: shards[s] for s in plan.read_shards})
    assert np.array_equal(got[geo.k + geo.l], shards[geo.k + geo.l])


def test_exhaustive_triple_failures_small_geometry():
    """LRC(6,2,2): every 3-failure pattern plans as the reference plans it
    and repairs byte-exactly (all are recoverable at n - k = 4)."""
    geo = lrc.LrcGeometry(6, 2, 2)
    _, shards = _shards(geo, 3)
    for missing in itertools.combinations(range(geo.n), 3):
        assert _plan_or_error(lrc, geo, list(missing)) == \
            _plan_or_error(ref_lrc, _ref_geo(geo), list(missing))
        plan = lrc.plan_repair(geo, list(missing))
        got = lrc.repair(geo, plan, {s: shards[s] for s in plan.read_shards})
        for s in missing:
            assert np.array_equal(got[s], shards[s]), missing


def test_double_failure_in_one_group_is_global():
    geo = lrc.LrcGeometry(6, 2, 2)
    _, shards = _shards(geo, 4)
    plan = lrc.plan_repair(geo, [0, 1])
    assert plan.kind == "global"
    got = lrc.repair(geo, plan, {s: shards[s] for s in plan.read_shards})
    assert np.array_equal(got[0], shards[0])
    assert np.array_equal(got[1], shards[1])


def test_unrecoverable_is_reported_by_both():
    geo = lrc.LrcGeometry(6, 2, 2)
    with pytest.raises(ValueError):
        lrc.plan_repair(geo, [0, 1, 2, 3, 4])
    with pytest.raises(ValueError):
        ref_lrc.plan_repair(_ref_geo(geo), [0, 1, 2, 3, 4])


def test_repair_bandwidth_advantage():
    """One loss in LRC(12,3,2) reads its group of 4 (RS(12, x) reads 12)."""
    plan = lrc.plan_repair(lrc.LrcGeometry(12, 3, 2), [4])
    assert plan.read_shards == [5, 6, 7, 13]


# -- the window codec ----------------------------------------------------------

def test_window_codec_equals_numpy_oracle():
    geo = EcGeometry(10, 4, code_kind="lrc", lrc_locals=2)
    codec = ec.LrcWindowCodec(geo, device="cpu")
    data = np.random.default_rng(9).integers(0, 256, (10, 5000),
                                             dtype=np.uint8)
    want = ref_lrc.encode_shards(ref_lrc.LrcGeometry(10, 2, 2), data)[10:]
    assert np.array_equal(codec.encode(data), want)
    assert np.array_equal(codec.encode_begin(data, volumes=3)(), want)


def test_codec_for_checks_the_local_groups():
    from seaweedfs_tpu_torch.storage.ec.encoder import codec_for
    geo = EcGeometry(12, 4, code_kind="lrc", lrc_locals=2)
    codec = ec.LrcWindowCodec(geo, device="cpu")
    assert codec_for(geo, codec) is codec
    with pytest.raises(ValueError, match="does not match"):
        codec_for(EcGeometry(12, 4, code_kind="lrc", lrc_locals=3), codec)
    with pytest.raises(ValueError, match="cannot code"):
        codec_for(geo, RSCodec(12, 4, device="cpu"))
    with pytest.raises(ValueError, match="lrc_locals"):
        ec.LrcWindowCodec(EcGeometry(10, 4, code_kind="lrc", lrc_locals=3),
                          device="cpu")


# -- on disk at LRC(10,2,2) ------------------------------------------------

@pytest.fixture(scope="module")
def codec():
    return ec.LrcWindowCodec(LRC_GEO, device="cpu")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def reference_volume(tmp_path_factory):
    """A needle volume written by the JAX package (one 160 KiB large row
    plus small rows), with two deletes, and its LRC encode by the JAX
    package."""
    d = tmp_path_factory.mktemp("lrc_ref")
    rng = np.random.default_rng(77)
    v = Volume(str(d), "", 7)
    needles = {}
    for i in range(1, 60):
        data = rng.bytes(int(rng.integers(1, 8000)))
        n = RefNeedle(id=i, cookie=int(rng.integers(0, 1 << 32)), data=data)
        v.write_needle(n)
        needles[i] = (n.cookie, data)
    for i in (3, 17):
        v.delete_needle(i)
        del needles[i]
    v.close()
    shutil.copytree(d, d.parent / "lrc_orig")
    ref_ec.encode_volume_to_ec(str(d / "7"), 3, REF_LRC_GEO)
    return str(d), str(d.parent / "lrc_orig"), needles


@pytest.fixture()
def encoded(reference_volume, codec, tmp_path):
    """The same .dat/.idx encoded by the port."""
    ref_dir, orig_dir, needles = reference_volume
    port_dir = tmp_path / "port"
    shutil.copytree(orig_dir, port_dir)
    base = str(port_dir / "7")
    ec.encode_volume_to_ec(base, 3, LRC_GEO, codec)
    return ref_dir, str(port_dir), base, needles


def test_encode_files_equal_reference(encoded):
    ref_dir, _, base, _ = encoded
    assert os.path.getsize(base + ".dat") > LRC_GEO.large_row_size()
    for ext in FAMILY:
        assert _read(base + ext) == _read(os.path.join(ref_dir, "7") + ext), \
            ext


@pytest.mark.parametrize("lost,plan_kind,read_shards", [
    ([0], "local", [1, 2, 3, 4, 10]),
    ([3], "local", [0, 1, 2, 4, 10]),
    ([11], "local", [5, 6, 7, 8, 9]),
    ([13], "global", list(range(10))),
    ([2, 7], "global", [0, 1, 3, 4, 5, 6, 8, 9, 10, 11]),
    ([4, 12], "global", [0, 1, 2, 3, 5, 6, 7, 8, 9, 10]),
])
def test_rebuild_equals_reference(encoded, codec, lost, plan_kind,
                                  read_shards, tmp_path):
    ref_dir, _, base, _ = encoded
    ref_base = str(tmp_path / "ref7")
    for ext in FAMILY:
        shutil.copy(os.path.join(ref_dir, "7") + ext, ref_base + ext)
    golden = {s: _read(base + ec.to_ext(s)) for s in lost}
    for b in (base, ref_base):
        for s in lost:
            os.remove(b + ec.to_ext(s))
    stats, ref_stats = {}, {}
    assert ec.rebuild_ec_files(base, codec=codec, batch_bytes=4096,
                               stats=stats) == lost
    assert ref_ec.rebuild_ec_files(ref_base, batch_bytes=4096,
                                   stats=ref_stats) == lost
    assert stats == ref_stats
    assert stats["plan_kind"] == plan_kind
    assert stats["read_shards"] == read_shards
    shard = os.path.getsize(base + ec.to_ext(read_shards[0]))
    assert stats["bytes_read"] == len(read_shards) * shard
    for s in lost:
        assert _read(base + ec.to_ext(s)) == golden[s], s


@pytest.mark.parametrize("gone", [[1, 11], [1, 2], [1, 10]],
                         ids=["one-per-group", "two-in-one-group",
                              "member-and-its-local-parity"])
def test_degraded_reads_equal_reference(encoded, codec, gone):
    """Reads with `gone` unreachable: a local plan where the group
    answers, else the probe of every shard and a global re-plan.  Every
    payload equals the written one, and every reconstructed interval the
    JAX package's."""
    ref_dir, port_dir, _, needles = encoded
    ev = ec.EcVolume(port_dir, "", 7, codec=codec)
    ref_ev = ref_ec.EcVolume(ref_dir, "", 7, REF_LRC_GEO)
    for s in range(14):
        if s not in gone:
            ev.load_shard(s)
            ref_ev.load_shard(s)
    degraded = 0
    try:
        for nid, (cookie, data) in needles.items():
            assert ev.read_needle(nid, cookie).data == data, nid
            for iv in ev.locate_ec_shard_needle(nid)[2]:
                sid, off = iv.to_shard_id_and_offset(LRC_GEO)
                if sid in gone:
                    degraded += 1
                    assert ev._reconstruct_interval(sid, off, iv.size) == \
                        ref_ev._reconstruct_interval(sid, off, iv.size)
    finally:
        ev.close()
        ref_ev.close()
    assert degraded > 5


def test_degraded_read_with_too_few_shards_raises(encoded, codec):
    _, port_dir, _, needles = encoded
    ev = ec.EcVolume(port_dir, "", 7, codec=codec)
    for s in range(5, 14):     # 9 shards: rank 9 < k
        ev.load_shard(s)
    with pytest.raises(ec.EcShardUnavailableError):
        for nid in needles:
            ev.read_needle(nid)
    ev.close()


def test_decode_to_volume_equals_reference(encoded, codec,
                                           reference_volume):
    ref_dir, port_dir, base, needles = encoded
    _, orig_dir, _ = reference_volume
    for s in (2, 9):
        os.remove(base + ec.to_ext(s))
    os.remove(base + ".dat")
    os.remove(base + ".idx")
    ec.decode_ec_to_volume(base, codec=codec)
    shutil.copytree(ref_dir, os.path.join(port_dir, "ref"))
    ref_copy = os.path.join(port_dir, "ref", "7")
    os.remove(ref_copy + ".dat")
    os.remove(ref_copy + ".idx")
    ref_ec.decode_ec_to_volume(ref_copy)
    got = _read(base + ".dat")
    assert got == _read(ref_copy + ".dat")
    # the original up to its last live needle (the deletes appended
    # tombstone records after it)
    assert _read(os.path.join(orig_dir, "7.dat"))[:len(got)] == got
    assert _read(base + ".idx") == _read(ref_copy + ".idx")
    v = Volume(port_dir, "", 7)
    for nid, (cookie, data) in needles.items():
        assert v.read_needle(nid, cookie).data == data
    v.close()


def test_fleet_encode_equals_reference(tmp_path, codec):
    """encode_ec_files_batch folds same-size LRC volumes onto the byte axis
    (one dispatch per window for the group, `volumes` in the metrics);
    shards equal the JAX package's per-volume encodes."""
    rng = np.random.default_rng(5)
    sizes = [LRC_GEO.large_row_size() + 7 * LRC_GEO.small_row_size() + 9] \
        * 3 + [LRC_GEO.small_row_size()]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    for vid, size in enumerate(sizes):
        with open(ref_dir / f"{vid}.dat", "wb") as f:
            f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    shutil.copytree(ref_dir, port_dir)
    ec.encode_ec_files_batch([str(port_dir / str(v))
                              for v in range(len(sizes))], LRC_GEO, codec,
                             batch_bytes=8192)
    for vid in range(len(sizes)):
        ref_base = str(ref_dir / str(vid))
        ref_ec.write_ec_files(ref_base, REF_LRC_GEO, batch_bytes=8192)
        for s in range(14):
            assert _read(str(port_dir / str(vid)) + ec.to_ext(s)) == \
                _read(ref_base + ec.to_ext(s)), (vid, s)


def test_parity_equals_generator_rows(encoded):
    """The on-disk parity of the first small row against gf256 tables."""
    _, _, base, _ = encoded
    head = 1024
    data = np.stack([np.fromfile(base + ec.to_ext(s), np.uint8, count=head)
                     for s in range(10)])
    parity = np.stack([np.fromfile(base + ec.to_ext(10 + p), np.uint8,
                                   count=head) for p in range(4)])
    G = lrc.generator_matrix(lrc.LrcGeometry(10, 2, 2))
    assert np.array_equal(parity, gf256.matmul(G[10:], data))
