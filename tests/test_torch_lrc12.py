"""Azure's LRC(12,2,2) on the port, on the CPU, against the benchmark's
plain reference (ecbench/reference/codes/lrc.py), byte for byte: 16-shard
volumes encoded and rebuilt through the serving binding, which reads the
geometry back from the .vif; each single loss rebuilt from the reads the
reference's read plan names, with one ec_plan observation; every
three-loss pattern restored by the port's planner and gf_apply.  Seeded
volumes of a few 12-block rows at a 4 KiB small block.
"""

import itertools
import json
import os
import shutil

import numpy as np
import pytest
import torch

from ecbench import volume as bench_volume
from ecbench.reference import layout as ref_layout
from ecbench.reference import needle as ref_needle
from ecbench.reference.codes import lrc as ref_lrc
from seaweedfs_tpu_torch import serving
from seaweedfs_tpu_torch.ops import codec as codec_mod
from seaweedfs_tpu_torch.ops import lrc
from seaweedfs_tpu_torch.storage import ec
from seaweedfs_tpu_torch.storage.ec.encoder import codec_for

# one intra-op thread: the plain torch versions are small here, and a
# thread per core would crowd the other test workers on this host
torch.set_num_threads(1)

SMALL = 4096
LARGE = 1 << 30
CONFIG_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ecbench", "configs", "lrc12_2_2.json")
with open(CONFIG_PATH) as _f:
    CONFIG = {**json.load(_f), "small_block_size": SMALL,
              "large_block_size": LARGE}
GEO = ec.EcGeometry(12, 4, large_block_size=LARGE, small_block_size=SMALL,
                    code_kind="lrc", lrc_locals=2)
LGEO = lrc.LrcGeometry(12, 2, 2)
VID = 5


def _volume(directory, seed, rows=3.5):
    """A seeded volume of `rows` small-block rows: (base, volume)."""
    os.makedirs(directory, exist_ok=True)
    base = os.path.join(str(directory), str(VID))
    vol = bench_volume.make_volume(base, int(rows * 12 * SMALL), seed, 64,
                                   4096)
    return base, vol


def _reference(vol):
    """The reference's 16 shards and .ecx of a volume."""
    dat = np.fromfile(vol.base + ".dat", dtype=np.uint8)
    data = ref_layout.data_shards(dat, 12, SMALL, LARGE)
    shards = np.concatenate([data, ref_lrc.parity_shards(CONFIG, data)])
    order = np.argsort(vol.ids)
    body = np.array([ref_needle.body_size(int(s)) for s in vol.data_sizes],
                    dtype=np.int64)
    ecx = ref_needle.index_bytes(vol.ids[order], vol.offsets[order],
                                 body[order])
    return shards, ecx


def _read(path):
    return np.fromfile(path, dtype=np.uint8)


def _plan_observations():
    h = codec_mod.codec_metrics().ec_plan
    return h._totals.get(("lrc", "rebuild"), 0)


def test_reference_generator_is_the_ports():
    assert np.array_equal(ref_lrc.generator(CONFIG),
                          lrc.generator_matrix(LGEO))


@pytest.mark.parametrize("entry", ["encode_volume_to_ec", "write_ec_files"])
@pytest.mark.parametrize("seed", [11, 2**33 + 7])
def test_encode_matches_reference(tmp_path, entry, seed):
    """All 16 shard files byte-exact with the reference's; through the
    binding also the .ecx, and a .vif that gives the geometry back."""
    base, vol = _volume(tmp_path, seed)
    if entry == "encode_volume_to_ec":
        serving.bind("cpu").encode_volume_to_ec(base, 3, geo=GEO)
    else:
        ec.write_ec_files(base, GEO, codec_for(GEO, device="cpu"), 8192)
    shards, ecx = _reference(vol)
    assert shards.shape == (16, 4 * SMALL)
    for s in range(16):
        assert np.array_equal(_read(base + ec.to_ext(s)), shards[s]), s
    assert not os.path.exists(base + ec.to_ext(16))
    if entry == "encode_volume_to_ec":
        with open(base + ".ecx", "rb") as f:
            assert f.read() == ecx
        assert ec.geometry_from_vif(base) == GEO


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """A volume encoded through the binding: (directory, reference
    shards)."""
    d = tmp_path_factory.mktemp("lrc12")
    base, vol = _volume(d, 2**31 + 3, rows=5.25)
    serving.bind("cpu").encode_volume_to_ec(base, 3, geo=GEO)
    return str(d), _reference(vol)[0]


@pytest.mark.parametrize("lost", range(16))
def test_single_loss_rebuild(encoded, tmp_path, lost):
    """The binding's rebuild, geometry from the .vif, restores the shard
    byte-exact, reads what the reference's read plan names (6 shards for
    0-13, 12 for 14-15) and plans once."""
    src, shards = encoded
    d = str(tmp_path / "v")
    shutil.copytree(src, d)
    base = os.path.join(d, str(VID))
    os.remove(base + ec.to_ext(lost))
    plans = _plan_observations()
    stats = {}
    got = serving.bind("cpu").rebuild_ec_files(base, batch_bytes=2 * SMALL,
                                               stats=stats)
    assert got == [lost]
    assert np.array_equal(_read(base + ec.to_ext(lost)), shards[lost])
    shard = shards.shape[1]
    assert stats["bytes_read"] == ref_lrc.single_loss_read_bytes(
        CONFIG, lost, shard)
    assert stats["plan_kind"] == ("local" if lost < 14 else "global")
    assert lost not in stats["read_shards"]
    assert _plan_observations() - plans == 1


@pytest.mark.parametrize("first", range(14))
def test_three_loss_patterns(first):
    """Every pattern of three lost shards whose lowest is `first`: the
    port's planner reads none of them, and gf_apply of its matrix to the
    shards it reads restores each lost one (560 patterns in all)."""
    data = np.random.default_rng(first).integers(0, 256, (12, 64),
                                                 dtype=np.uint8)
    shards = np.concatenate([data, ref_lrc.parity_shards(CONFIG, data)])
    n = 0
    for rest in itertools.combinations(range(first + 1, 16), 2):
        missing = [first, *rest]
        plan = lrc.plan_repair(LGEO, missing)
        assert not set(plan.read_shards) & set(missing)
        out = codec_mod.gf_apply(plan.matrix, shards[plan.read_shards],
                                 device="cpu")
        assert np.array_equal(out, shards[missing]), missing
        n += 1
    assert n == (15 - first) * (14 - first) // 2
