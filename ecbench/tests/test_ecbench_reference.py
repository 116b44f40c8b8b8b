"""The frozen reference equals the program's plain CPU version on a small
volume, for both configurations: every shard, the .ecx, a rebuilt shard;
and its GF(2^8) and Clay pieces equal the program's."""

import json
import os

import numpy as np
import pytest

from ecbench import harness, volume
from ecbench.reference import clay, codes, gf256, layout, needle


def _config(name):
    with open(os.path.join(harness.HERE, "configs", name + ".json")) as f:
        return json.load(f)


def test_gf256_and_generators_equal_the_programs():
    from seaweedfs_tpu_torch.ops import gf256 as pgf, rs_matrix
    for a in range(256):
        for b in (0, 1, 2, 3, 29, 142, 255):
            assert gf256.mul(a, b) == int(pgf.MUL_TABLE[a, b])
    for kind in ("vandermonde", "cauchy"):
        assert np.array_equal(gf256.generator(10, 4, kind),
                              rs_matrix.generator_matrix(10, 4, kind))
    rng = np.random.default_rng(3)
    M = rng.integers(0, 256, (4, 10), dtype=np.uint8)
    X = rng.integers(0, 256, (10, 1003), dtype=np.uint8)
    assert np.array_equal(gf256.matmul_rows(M, X), pgf.matmul(M, X))


def test_clay_window_equals_the_programs_oracle():
    from seaweedfs_tpu_torch.ops.clay import ClayCode
    d = np.random.default_rng(4).integers(0, 256, (10, 256, 32),
                                          dtype=np.uint8)
    assert np.array_equal(clay.code(10, 4, 13).encode_window(d),
                          ClayCode(10, 4).encode(d))


@pytest.mark.parametrize("name", ["rs10_4", "clay10_4"])
def test_reference_shards_equal_the_program_on_cpu(tmp_path, name):
    from ecbench.system import Program
    c = _config(name)
    k, m = c["data_shards"], c["parity_shards"]
    v = volume.make_volume(str(tmp_path / "1"), 12 << 20, 77, 1024,
                           1 << 20)
    prog = Program("cpu", c)
    prog.encode(v.base)
    dat = np.fromfile(v.base + ".dat", dtype=np.uint8)
    data = layout.data_shards(dat, k, c["small_block_size"],
                              c["large_block_size"])
    want = np.concatenate([data, codes.of(c).parity_shards(c, data)])
    for s in range(k + m):
        assert harness.file_digest(f"{v.base}.ec{s:02d}") == \
            harness.digest(want[s])
    order = np.argsort(v.ids)
    body = np.array([needle.body_size(int(n)) for n in v.data_sizes])
    with open(v.base + ".ecx", "rb") as f:
        assert f.read() == needle.index_bytes(v.ids[order],
                                              v.offsets[order], body[order])
    os.remove(f"{v.base}.ec11")
    stats = prog.rebuild(v.base)
    assert np.array_equal(np.fromfile(f"{v.base}.ec11", dtype=np.uint8),
                          want[11])
    shard = want.shape[1]
    assert stats["bytes_read"] == (
        13 * shard // 4 if c["code_kind"] == "clay" else 10 * shard)
    assert stats["bytes_read"] == codes.of(c).single_loss_read_bytes(
        c, 11, shard)


def test_needle_payloads_read_back(tmp_path):
    v = volume.make_volume(str(tmp_path / "1"), 2 << 20, 5, 1024, 1 << 20)
    raw = np.fromfile(v.base + ".dat", dtype=np.uint8)
    for i in range(len(v.ids)):
        off = int(v.offsets[i])
        rec = raw[off:off + needle.record_size(int(v.data_sizes[i]))]
        cookie, nid, data = needle.data_of(rec.tobytes())
        assert (cookie, nid, len(data)) == (
            int(v.cookies[i]), int(v.ids[i]), int(v.data_sizes[i]))


def test_locate_matches_the_program():
    from seaweedfs_tpu_torch.storage.ec.layout import locate_data
    rng = np.random.default_rng(8)
    dat_size = 45 << 20
    for _ in range(200):
        off = int(rng.integers(0, dat_size - (2 << 20)))
        size = int(rng.integers(1, 2 << 20))
        got = [(iv.to_shard_id_and_offset()[0],
                iv.to_shard_id_and_offset()[1], iv.size)
               for iv in locate_data(dat_size, off, size)]
        assert got == layout.locate(off, size, 10, 1 << 20)
