"""The port's Clay path (seaweedfs_tpu_torch) against the JAX package, on the
CPU: the same seeded numpy inputs go through the JAX package's Pallas
kernels (interpret mode, WEED_CLAY_FUSED=interpret as tests/test_clay_fused.py
runs them), its tiled and numpy paths, and the plain torch versions of the
port's CUDA kernels; on disk both packages encode, rebuild, read degraded
and decode the same volumes.  Clay is exact, so every comparison is byte
equality (tolerance zero)."""

import itertools
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from clay_oracle import natural_layout_parity
from seaweedfs_tpu.ops import clay_matrix as ref_clay_matrix
from seaweedfs_tpu.ops import clay_structured as ref_cs
from seaweedfs_tpu.ops import rs_pallas
from seaweedfs_tpu.ops.codec import gf_apply as ref_gf_apply
from seaweedfs_tpu.storage import ec as ref_ec
from seaweedfs_tpu_torch.ops import clay_cuda, clay_matrix, codec, rs_cuda
from seaweedfs_tpu_torch.ops import clay_structured as cs
from seaweedfs_tpu_torch.ops import rs_matrix
from seaweedfs_tpu_torch.ops.clay import GAMMA
from seaweedfs_tpu_torch.storage import ec

# one intra-op thread: the plain torch versions are small here, and a
# thread per core would crowd the other test workers on this host
torch.set_num_threads(1)

GEOMETRIES = [(4, 2), (6, 3), (10, 4)]


def _interpret(monkeypatch):
    """Run the JAX package's fused kernels through the Pallas interpreter
    on this CPU host (the idiom of tests/test_clay_fused.py)."""
    import seaweedfs_tpu.ops.codec as ref_codec_mod
    monkeypatch.setenv("WEED_CLAY_FUSED", "interpret")
    monkeypatch.delenv("WEED_EC_BACKEND", raising=False)
    monkeypatch.setattr(ref_codec_mod, "device_compute_ok", lambda: True)


def _data(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


# -- own copies of the host-side clay code ------------------------------------

@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_encode_parts_and_r_bits_match_reference(k, m):
    got, want = cs.encode_parts(k, m), ref_cs.encode_parts(k, m)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(cs.r_bits(k, m), ref_cs._r_bits(k, m))
    assert np.array_equal(cs.r_bits_plane_major(k, m),
                          ref_cs._r_bits_plane_major(k, m))
    assert clay_matrix.code(k, m).alpha == ref_clay_matrix.code(k, m).alpha


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_repair_parts_match_reference_and_repair_flat(k, m):
    """Every loss: the plan (helpers ascending, plane layers ascending), the
    row solve R_r, 1/g and its plane-major bits equal the JAX package's,
    and the plan is the one repair_flat's partial reads use."""
    for lost in range(k + m):
        got = cs.repair_parts(k, m, lost)
        want = ref_cs.repair_parts(k, m, lost)
        assert got[:2] == want[:2] and got[3] == want[3]
        assert np.array_equal(got[2], want[2])
        assert np.array_equal(cs.repair_bits_plane_major(k, m, lost),
                              ref_cs._repair_bits_plane_major(k, m, lost))
        helpers, plane, R = clay_matrix.repair_flat(k, m, lost)
        assert (helpers, plane) == got[:2]
        ref_helpers, ref_plane, ref_R = ref_clay_matrix.repair_flat(
            k, m, lost)
        assert (helpers, plane) == (ref_helpers, ref_plane)
        assert np.array_equal(R, ref_R)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_flat_matrices_match_reference(k, m):
    assert np.array_equal(clay_matrix.generator_flat(k, m),
                          ref_clay_matrix.generator_flat(k, m))
    rng = np.random.default_rng(k * m)
    for n_lost in range(1, m + 1):
        lost = tuple(sorted(rng.choice(k + m, n_lost, replace=False)
                            .tolist()))
        present = tuple(i for i in range(k + m) if i not in lost)
        assert np.array_equal(
            clay_matrix.decode_flat(k, m, present, lost),
            ref_clay_matrix.decode_flat(k, m, present, lost)), lost


# -- the fused kernels' plain versions ----------------------------------------

@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_fused_encode_plain_matches_pallas_and_oracle(k, m, monkeypatch):
    _interpret(monkeypatch)
    c = clay_matrix.code(k, m)
    small, n_win = c.alpha * 128, 2
    data = _data((k, n_win * small), seed=k * 100 + m)
    shape4 = cs.fused_shape(k, m, data.shape[1], small)
    assert shape4 == ref_cs.fused_shape(k, m, data.shape[1], small)
    got = clay_cuda.clay_fused_encode_plain(
        torch.from_numpy(cs.r_bits_plane_major(k, m)),
        torch.from_numpy(data.reshape(shape4)), q=c.q, t=c.t, gamma=GAMMA,
        det_inv=int(c._det_inv)).numpy()
    pallas = np.asarray(ref_cs.encode_device_fused(
        k, m, jnp.asarray(data.reshape(shape4)), small=small))
    assert np.array_equal(got, pallas)
    assert np.array_equal(got.reshape(m, -1),
                          natural_layout_parity(k, m, data, small))


@pytest.mark.parametrize("w_a", [1, 13, 100])
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_fused_encode_narrow_windows_match_oracle(k, m, w_a):
    """Any w_a: the TPU's 128-lane column tile is not carried over."""
    c = clay_matrix.code(k, m)
    small = c.alpha * w_a
    data = _data((k, 3 * small), seed=w_a)
    got = cs.encode_device(k, m, torch.from_numpy(data), small=small)
    assert np.array_equal(got.numpy(),
                          natural_layout_parity(k, m, data, small))


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_tiled_encode_matches_reference_tiled(k, m):
    c = clay_matrix.code(k, m)
    small = c.alpha * 256
    data = _data((k, 2 * small), seed=k + 7)
    shape5 = cs.tiled_shape(k, m, data.shape[1], small)
    assert shape5 == ref_cs.tiled_shape(k, m, data.shape[1], small)
    got = cs.encode_device_tiled(k, m, torch.from_numpy(data.reshape(shape5)),
                                 small=small).numpy()
    want = np.asarray(ref_cs.encode_device_tiled(
        k, m, jnp.asarray(data.reshape(shape5)), small=small))
    assert np.array_equal(got, want)
    assert cs.tiled_shape(k, m, 2 * c.alpha * 13, c.alpha * 13) is None


def _encoded_stripe(k, m, w_a, n_win, seed):
    c = clay_matrix.code(k, m)
    data = _data((k, n_win * c.alpha * w_a), seed)
    parity = natural_layout_parity(k, m, data, c.alpha * w_a)
    return np.concatenate([data, parity]).reshape(k + m, n_win, c.alpha,
                                                  w_a)


def _repair_input(k, m, lost, sh4):
    helpers, plane, _, _ = cs.repair_parts(k, m, lost)
    return np.ascontiguousarray(sh4[list(helpers)][:, :, list(plane)])


@pytest.mark.parametrize("k,m,losses", [
    (4, 2, range(6)), (6, 3, range(9)), (10, 4, (0, 5, 9, 10, 13))])
def test_fused_repair_plain_matches_pallas(k, m, losses, monkeypatch):
    _interpret(monkeypatch)
    c = clay_matrix.code(k, m)
    sh4 = _encoded_stripe(k, m, 128, 2, seed=k * 10 + m)
    for lost in losses:
        x4 = _repair_input(k, m, lost, sh4)
        got = clay_cuda.clay_fused_repair_plain(
            torch.from_numpy(cs.repair_bits_plane_major(k, m, lost)),
            torch.from_numpy(x4), k=k, q=c.q, t=c.t, lost=lost, gamma=GAMMA,
            inv_gamma=cs.repair_parts(k, m, lost)[3]).numpy()
        pallas = np.asarray(ref_cs.repair_device_fused(k, m, lost,
                                                       jnp.asarray(x4)))
        assert np.array_equal(got, pallas), lost
        assert np.array_equal(got, sh4[lost]), lost


@pytest.mark.parametrize("w_a", [1, 7])
def test_fused_repair_narrow_windows(w_a):
    k, m = 10, 4
    sh4 = _encoded_stripe(k, m, w_a, 3, seed=w_a)
    for lost in range(k + m):
        got = cs.repair_device_fused(
            k, m, lost, torch.from_numpy(_repair_input(k, m, lost, sh4)))
        assert np.array_equal(got.numpy(), sh4[lost]), lost


# -- the matmul entries and gf_apply ------------------------------------------

def test_cols_entry_matches_pallas_cols():
    k, m = 10, 4
    bits = cs.r_bits_plane_major(k, m)
    u = _data((12, 64, 128), seed=3)
    want = np.asarray(rs_pallas.gf_matmul_bits_pallas_cols(
        jnp.asarray(bits, dtype=jnp.int8), jnp.asarray(u), interpret=True))
    got = rs_cuda.gf_matmul_bits_cols_cuda(torch.from_numpy(bits),
                                           torch.from_numpy(u))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(rs_cuda.gf_matmul_bits_cols_plain(
        torch.from_numpy(bits), torch.from_numpy(u)).numpy(), want)


@pytest.mark.parametrize("k,m", [(10, 4), (16, 8)])
def test_vm_entry_matches_pallas_volume_major(k, m):
    M = rs_matrix.generator_matrix(k, m)[k:]
    bits = rs_cuda.to_plane_major(rs_matrix.bit_matrix(M), m, k)
    d = _data((3, k, 512), seed=k)
    want = np.asarray(rs_pallas.gf_matmul_bits_pallas(
        jnp.asarray(bits, dtype=jnp.int8), jnp.asarray(d), block_b=256,
        interpret=True))
    got = rs_cuda.gf_matmul_bits_vm_cuda(torch.from_numpy(bits),
                                         torch.from_numpy(d))
    assert np.array_equal(got.numpy(), want)


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    k, m = 4, 2
    c = clay_matrix.code(k, m)
    counters = (clay_cuda.encode_launches, clay_cuda.repair_launches,
                rs_cuda.cols_launches, rs_cuda.vm_launches)
    before = [ctr.value for ctr in counters]
    sh4 = _encoded_stripe(k, m, 9, 2, seed=1)
    cs.encode_device_fused(k, m, torch.from_numpy(
        np.ascontiguousarray(sh4[:k])), small=c.alpha * 9)
    cs.repair_device_fused(k, m, 0, torch.from_numpy(
        _repair_input(k, m, 0, sh4)))
    bits = torch.from_numpy(cs.r_bits_plane_major(k, m))
    rs_cuda.gf_matmul_bits_cols_cuda(bits, torch.zeros((4, 2, 128),
                                                       dtype=torch.uint8))
    rs_cuda.gf_matmul_bits_vm_cuda(bits, torch.zeros((2, 4, 5),
                                                     dtype=torch.uint8))
    assert [ctr.value for ctr in counters] == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "q", "k", "lost",
                                 "contiguous", "matrix"])
def test_clay_wrappers_reject_what_the_kernels_do_not_take(bad):
    k, m = 10, 4
    c = clay_matrix.code(k, m)
    bits = torch.from_numpy(cs.r_bits_plane_major(k, m))
    d4 = torch.zeros((k, 1, c.alpha, 8), dtype=torch.uint8)
    x4 = torch.zeros((k + m - 1, 1, c.beta, 8), dtype=torch.uint8)
    kw = dict(q=c.q, t=c.t, gamma=GAMMA)
    rkw = dict(k=k, lost=0, inv_gamma=1, **kw)
    if bad == "dtype":
        d4, x4 = d4.int(), x4.int()
    elif bad == "shape":
        d4, x4 = d4[:, :, :-1], x4[:-1]
    elif bad == "q":
        kw["q"] = rkw["q"] = 9
    elif bad == "k":
        d4, rkw["k"] = torch.zeros((13, 1, c.alpha, 8),
                                   dtype=torch.uint8), 3
    elif bad == "lost":
        rkw["lost"] = 14
    elif bad == "contiguous":
        d4 = torch.zeros((k, 1, c.alpha, 16), dtype=torch.uint8)[..., ::2]
        x4 = torch.zeros((k + m - 1, 1, c.beta, 16),
                         dtype=torch.uint8)[..., ::2]
    else:
        bits = bits[:, :-8]
    if bad != "lost":   # the encode takes no lost id
        with pytest.raises((TypeError, ValueError)):
            clay_cuda.clay_fused_encode(bits, d4, det_inv=1, **kw)
    with pytest.raises((TypeError, ValueError)):
        clay_cuda.clay_fused_repair(bits, x4, **rkw)


def test_gf_apply_matches_reference_numpy(monkeypatch):
    """gf_apply(device="cpu") against the JAX gf_apply's numpy tables, for
    a clay decode matrix and a random matrix; a small chunk budget makes
    the column chunking run."""
    k, m = 4, 2
    present, lost = (0, 2, 3, 5), (1, 4)
    D = clay_matrix.decode_flat(k, m, present, lost)
    x = _data((D.shape[1], 1000), seed=5)
    assert np.array_equal(codec.gf_apply(D, x, device="cpu"),
                          ref_gf_apply(D, x, backend="numpy"))
    M = _data((7, 30), seed=6)
    x = _data((30, 777), seed=7)
    want = ref_gf_apply(M, x, backend="numpy")
    assert np.array_equal(codec.gf_apply(M, x, device="cpu"), want)
    monkeypatch.setattr(codec, "GF_APPLY_PLANE_BYTES", 32 * 30 * 100)
    assert np.array_equal(codec.gf_apply(M, x, device="cpu"), want)
    with pytest.raises(ValueError):
        codec.gf_apply(M, x[:-1], device="cpu")


def test_clay_codec_default_device_needs_cuda():
    geo = ec.EcGeometry(code_kind="clay")
    if torch.cuda.is_available():
        assert ec.ClayWindowCodec(geo).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ec.ClayWindowCodec(geo)
    with pytest.raises(RuntimeError, match="CUDA"):
        codec.gf_apply(np.eye(2, dtype=np.uint8),
                       np.zeros((2, 3), dtype=np.uint8))


# -- on disk: the port against the JAX package --------------------------------

ALPHA = clay_matrix.code(10, 4).alpha
GEO = ec.EcGeometry(10, 4, large_block_size=1 << 20,
                    small_block_size=ALPHA * 128, code_kind="clay")
REF_GEO = ref_ec.EcGeometry(10, 4, large_block_size=1 << 20,
                            small_block_size=ALPHA * 128, code_kind="clay")
# a large block of 8 small blocks: the large-row column slices run too
GEO_LARGE = ec.EcGeometry(10, 4, large_block_size=8 * ALPHA * 128,
                          small_block_size=ALPHA * 128, code_kind="clay")
REF_GEO_LARGE = ref_ec.EcGeometry(10, 4, large_block_size=8 * ALPHA * 128,
                                  small_block_size=ALPHA * 128,
                                  code_kind="clay")
SIDE_FILES = [ec.to_ext(s) for s in range(14)] + [".ecx", ".vif"]
BATCH = 4 * ALPHA * 128   # four windows per codec call


@pytest.fixture(scope="module")
def clay_codec():
    return ec.ClayWindowCodec(GEO, device="cpu")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """One needle volume (seeded, 1-24 KiB payloads over 8 small rows)
    encoded by both packages: (ref_dir, port_dir, needles)."""
    root = tmp_path_factory.mktemp("clay")
    ref_dir, port_dir = root / "ref", root / "port"
    ref_dir.mkdir()
    needles = chip_smoke.build_volume(str(ref_dir / "1"),
                                      8 * 10 * 32768 - 5000, seed=11,
                                      max_size=24 * 1024)
    shutil.copytree(ref_dir, port_dir)
    ref_ec.encode_volume_to_ec(str(ref_dir / "1"), 3, REF_GEO)
    ec.encode_volume_to_ec(str(port_dir / "1"), 3, GEO,
                           ec.ClayWindowCodec(GEO, device="cpu"))
    return str(ref_dir), str(port_dir), needles


@pytest.fixture()
def volumes(encoded, tmp_path):
    """A fresh copy of both encoded volumes for a test that deletes."""
    ref_dir, port_dir, needles = encoded
    shutil.copytree(ref_dir, tmp_path / "ref")
    shutil.copytree(port_dir, tmp_path / "port")
    return str(tmp_path / "ref"), str(tmp_path / "port"), needles


def test_encode_files_byte_identical(encoded):
    ref_dir, port_dir, _ = encoded
    base, ref_base = os.path.join(port_dir, "1"), os.path.join(ref_dir, "1")
    for ext in SIDE_FILES:
        assert _read(base + ext) == _read(ref_base + ext), ext
    info = json.loads(_read(base + ".vif"))
    assert info["code_kind"] == "clay"
    assert info["dat_size"] == os.path.getsize(base + ".dat")


def test_encode_with_large_rows_byte_identical(tmp_path):
    """A volume of one large row (column slices of 8-window large blocks)
    plus a partial small row."""
    size = GEO_LARGE.large_row_size() + 3 * GEO_LARGE.small_block_size + 99
    paths = []
    for name in ("ref", "port"):
        (tmp_path / name).mkdir()
        paths.append(str(tmp_path / name / "5"))
        with open(paths[-1] + ".dat", "wb") as f:
            f.write(_data(size, seed=17).tobytes())
    ref_ec.write_ec_files(paths[0], REF_GEO_LARGE, batch_bytes=BATCH)
    ec.write_ec_files(paths[1], GEO_LARGE,
                      ec.ClayWindowCodec(GEO_LARGE, device="cpu"),
                      batch_bytes=BATCH)
    for s in range(14):
        assert _read(paths[1] + ec.to_ext(s)) == \
            _read(paths[0] + ec.to_ext(s)), s


@pytest.mark.parametrize("lost", [3, 12, 0, 13])
def test_single_loss_rebuild_is_plane_fused(volumes, clay_codec, lost):
    ref_dir, port_dir, _ = volumes
    base, ref_base = os.path.join(port_dir, "1"), os.path.join(ref_dir, "1")
    want = _read(base + ec.to_ext(lost))
    for b in (base, ref_base):
        os.remove(b + ec.to_ext(lost))
    stats, ref_stats = {}, {}
    assert ec.rebuild_ec_files(base, codec=clay_codec, batch_bytes=BATCH,
                               stats=stats) == [lost]
    ref_ec.rebuild_ec_files(ref_base, REF_GEO, batch_bytes=BATCH,
                            stats=ref_stats)
    assert stats["plan_kind"] == "clay-plane-fused"
    assert stats["bytes_read"] == ref_stats["bytes_read"]
    assert stats["helpers"] == ref_stats["helpers"]
    assert stats["layers_per_helper"] == ALPHA // 4
    # 13 helpers x beta = alpha/4 layers: 13/40 of RS's k whole shards
    assert stats["bytes_read"] * 40 == 13 * 10 * os.path.getsize(
        base + ec.to_ext(0))
    assert _read(base + ec.to_ext(lost)) == want
    assert _read(ref_base + ec.to_ext(lost)) == want


@pytest.mark.parametrize("mask", [(0, 11), (3, 12), (10, 13), (1, 4, 7, 12),
                                  (0, 1, 2, 3)])
def test_multi_loss_rebuild_masks(volumes, clay_codec, mask):
    ref_dir, port_dir, _ = volumes
    base, ref_base = os.path.join(port_dir, "1"), os.path.join(ref_dir, "1")
    want = {s: _read(base + ec.to_ext(s)) for s in mask}
    for s in mask:
        os.remove(base + ec.to_ext(s))
        os.remove(ref_base + ec.to_ext(s))
    stats, ref_stats = {}, {}
    assert ec.rebuild_ec_files(base, codec=clay_codec, batch_bytes=BATCH,
                               stats=stats) == list(mask)
    ref_ec.rebuild_ec_files(ref_base, REF_GEO, batch_bytes=BATCH,
                            stats=ref_stats)
    assert stats == ref_stats == {"bytes_read": stats["bytes_read"],
                                  "plan_kind": "clay-decode"}
    for s in mask:
        assert _read(base + ec.to_ext(s)) == want[s], s
        assert _read(ref_base + ec.to_ext(s)) == want[s], s


def test_double_loss_every_mask_small_geometry(tmp_path):
    """Every double-loss mask of Clay(4, 2) through rebuild_ec_files."""
    c = clay_matrix.code(4, 2)
    geo = ec.EcGeometry(4, 2, large_block_size=1 << 20,
                        small_block_size=c.alpha * 128, code_kind="clay")
    codec_42 = ec.ClayWindowCodec(geo, device="cpu")
    base = str(tmp_path / "1")
    with open(base + ".dat", "wb") as f:
        f.write(_data(geo.small_row_size() + 123, seed=42).tobytes())
    ec.write_ec_files(base, geo, codec_42)
    want = {i: _read(base + ec.to_ext(i)) for i in range(6)}
    for mask in itertools.combinations(range(6), 2):
        for i in mask:
            os.remove(base + ec.to_ext(i))
        assert ec.rebuild_ec_files(base, geo, codec_42) == list(mask)
        for i in mask:
            assert _read(base + ec.to_ext(i)) == want[i], (mask, i)


@pytest.mark.parametrize("gone", [(1, 4), (0, 13), (2,)])
def test_degraded_reads_match_reference(volumes, clay_codec, gone):
    ref_dir, port_dir, needles = volumes
    for d in (ref_dir, port_dir):
        for s in gone:
            os.remove(os.path.join(d, "1") + ec.to_ext(s))
    ev = ec.EcVolume(port_dir, "", 1, codec=clay_codec)
    ref_ev = ref_ec.EcVolume(ref_dir, "", 1)
    for s in range(14):
        if s not in gone:
            ev.add_shard(s)
            ref_ev.add_shard(s)
    dat = _read(os.path.join(port_dir, "1") + ".dat")
    degraded = 0
    for nid, off, size in needles:
        _, _, intervals = ev.locate_ec_shard_needle(nid)
        degraded += any(iv.to_shard_id_and_offset(GEO)[0] in gone
                        for iv in intervals)
        got = ev.read_needle(nid).data
        assert bytes(got) == dat[off + 20:off + 20 + size], nid
        assert bytes(got) == bytes(ref_ev.read_needle(nid).data), nid
    assert degraded > 5
    ev.close()
    ref_ev.close()


def test_remote_reader_serves_missing_local_shards(volumes, clay_codec):
    """Shards 0-2 only remote: reads go through the reader, whole windows
    included when a degraded read needs them."""
    _, port_dir, needles = volumes
    base = os.path.join(port_dir, "1")
    remote = {s: _read(base + ec.to_ext(s)) for s in (0, 1, 2)}
    calls = []

    def remote_reader(vid, sid, off, size):
        calls.append(sid)
        return remote[sid][off:off + size] if sid != 1 else None

    ev = ec.EcVolume(port_dir, "", 1, codec=clay_codec,
                     remote_reader=remote_reader)
    for s in range(3, 14):
        ev.add_shard(s)
    dat = _read(base + ".dat")
    for nid, off, size in needles:
        got = bytes(ev.read_needle(nid).data)
        assert got == dat[off + 20:off + 20 + size], nid
    assert {0, 1, 2} <= set(calls)
    ev.close()


def test_degraded_read_needs_k_shards(volumes, clay_codec):
    _, port_dir, needles = volumes
    ev = ec.EcVolume(port_dir, "", 1, codec=clay_codec)
    for s in range(5, 14):
        ev.add_shard(s)
    with pytest.raises(ec.EcShardUnavailableError):
        for nid, _, _ in needles:
            ev.read_needle(nid)
    ev.close()


def test_decode_to_volume_round_trips(volumes, clay_codec):
    ref_dir, port_dir, _ = volumes
    base, ref_base = os.path.join(port_dir, "1"), os.path.join(ref_dir, "1")
    original = _read(base + ".dat")
    for b in (base, ref_base):
        os.remove(b + ".dat")
        os.remove(b + ".idx")
        for s in (2, 9):
            os.remove(b + ec.to_ext(s))
    ec.decode_ec_to_volume(base, codec=clay_codec)
    ref_ec.decode_ec_to_volume(ref_base)
    got = _read(base + ".dat")
    assert got == _read(ref_base + ".dat") == original
    assert _read(base + ".idx") == _read(ref_base + ".idx")


def test_fleet_encode_and_rebuild_batch(tmp_path):
    """encode_ec_files_batch folds three same-size clay volumes onto the
    byte axis, an odd-sized one takes the single path; shards equal the
    JAX package's.  rebuild_ec_files_batch then rebuilds a single and a
    double loss per volume."""
    sizes = [3 * GEO.small_row_size() + 700] * 3 + [GEO.small_row_size()]
    bases = {}
    for name in ("ref", "port"):
        (tmp_path / name).mkdir()
        bases[name] = []
        for vid, size in enumerate(sizes, start=7):
            base = str(tmp_path / name / str(vid))
            with open(base + ".dat", "wb") as f:
                f.write(_data(size, seed=vid).tobytes())
            bases[name].append(base)
    clay_codec = ec.ClayWindowCodec(GEO, device="cpu")
    ref_ec.encode_ec_files_batch(bases["ref"], REF_GEO, batch_bytes=BATCH)
    ec.encode_ec_files_batch(bases["port"], GEO, clay_codec,
                             batch_bytes=BATCH)
    for base, ref_base, size in zip(bases["port"], bases["ref"], sizes):
        for s in range(14):
            assert _read(base + ec.to_ext(s)) == \
                _read(ref_base + ec.to_ext(s)), (base, s)
        ec.save_volume_info(base, 3, dat_size=size, data_shards=10,
                            parity_shards=4,
                            large_block_size=GEO.large_block_size,
                            small_block_size=GEO.small_block_size,
                            code_kind="clay")
    for lost in ([6], [2, 11]):
        originals = {}
        for base in bases["port"]:
            for s in lost:
                originals[(base, s)] = _read(base + ec.to_ext(s))
                os.remove(base + ec.to_ext(s))
        out = ec.rebuild_ec_files_batch(bases["port"], batch_bytes=BATCH,
                                        codec=clay_codec)
        assert out == {b: lost for b in bases["port"]}
        for (base, s), want in originals.items():
            assert _read(base + ec.to_ext(s)) == want, (base, s)


def test_codec_kind_must_match_geometry(tmp_path, clay_codec):
    base = str(tmp_path / "1")
    with open(base + ".dat", "wb") as f:
        f.write(b"\1" * 100)
    with pytest.raises(ValueError):
        ec.write_ec_files(base, ec.EcGeometry(), clay_codec)
    with pytest.raises(ValueError):
        ec.write_ec_files(base, GEO, codec.RSCodec(device="cpu"))
    other_windows = ec.EcGeometry(10, 4, small_block_size=ALPHA * 64,
                                  code_kind="clay")
    with pytest.raises(ValueError, match="geometry"):
        ec.write_ec_files(base, other_windows, clay_codec)
    with pytest.raises(ValueError, match="alpha"):
        ec.ClayWindowCodec(ec.EcGeometry(small_block_size=1000,
                                         code_kind="clay"), device="cpu")
