"""The seeded generator: the same seed writes the same volume, seeds share
the sizes in their own order, and the records are valid version-3 needles with a matching
index (checked with the program's own reader)."""

import os

import numpy as np

from ecbench import volume


def _make(tmp_path, name, seed):
    return volume.make_volume(str(tmp_path / name), 3 << 20, seed, 1024,
                              1 << 20)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_same_seed_same_volume(tmp_path):
    a, b = _make(tmp_path, "a", 2**40 + 3), _make(tmp_path, "b", 2**40 + 3)
    for ext in (".dat", ".idx"):
        assert _read(a.base + ext) == _read(b.base + ext)


def test_seeds_share_sizes_not_bytes(tmp_path):
    a, b = _make(tmp_path, "a", 1), _make(tmp_path, "b", 2)
    assert np.array_equal(np.sort(a.data_sizes), np.sort(b.data_sizes))
    assert a.dat_size == b.dat_size
    assert not np.array_equal(a.offsets, b.offsets)
    assert _read(a.base + ".dat") != _read(b.base + ".dat")
    assert not set(a.ids.tolist()) & set(b.ids.tolist())


def test_sizes_log_uniform_in_bounds():
    sizes = volume.payload_sizes(256 << 20, 1024, 1 << 20)
    assert sizes.min() >= 1024 and sizes.max() <= 1 << 20
    # log-uniform over [1 KiB, 1 MiB]: mean (hi - lo) / ln(hi / lo)
    assert abs(sizes.mean() / ((2**20 - 2**10) / np.log(1024)) - 1) < 0.1


def test_records_are_valid_v3_needles(tmp_path):
    from seaweedfs_tpu_torch.storage.idx import parse_index_bytes
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.super_block import SuperBlock
    v = _make(tmp_path, "v", 99)
    raw = _read(v.base + ".dat")
    assert len(raw) == v.dat_size == os.path.getsize(v.base + ".dat")
    assert SuperBlock.from_bytes(raw[:8]).version == 3
    idx = parse_index_bytes(_read(v.base + ".idx"))
    assert len(idx) == len(v.ids)
    end = 8
    for i, entry in enumerate(idx):
        off, size = int(entry["offset"]), int(entry["size"])
        assert off == end == int(v.offsets[i])
        n = Needle()
        n.read_bytes(raw[off:], off, size, 3)     # checks size and CRC
        assert (n.id, n.cookie) == (int(v.ids[i]), int(v.cookies[i]))
        assert len(n.data) == int(v.data_sizes[i])
        end = off + 16 + size + 12 + (8 - (16 + size + 12) % 8)
    assert end == len(raw)
