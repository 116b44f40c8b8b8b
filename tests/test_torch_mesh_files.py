"""The port's EC files through a device mesh against the JAX package's, byte
for byte: `codec_for(geo, device=mesh)` (the port's mesh of 8 CPU
positions) drives write_ec_files, rebuild_ec_files of 3 lost shards,
encode_ec_files_batch and rebuild_ec_files_batch for RS(10,4), Clay(10,4)
and LRC(10,2,2) volumes, and every .ecNN must equal the JAX package's
write_ec_files of the same .dat with no codec given, which on its 8
virtual CPU devices (tests/conftest.py) runs its MeshCodec and its window
codecs' mesh arms.  Also the pickers: with no device this CPU-only host
has no CUDA and raises, a Mesh gives the mesh codecs, and the serving
binding on a mesh keeps EC volumes on one device.
"""

import os

import numpy as np
import pytest
import torch

from seaweedfs_tpu.storage import ec as ref_ec
from seaweedfs_tpu_torch import serving
from seaweedfs_tpu_torch.ops import clay_matrix
from seaweedfs_tpu_torch.ops.codec import RSCodec
from seaweedfs_tpu_torch.parallel import mesh_codec as mc
from seaweedfs_tpu_torch.storage import ec
from seaweedfs_tpu_torch.storage.ec import codes
from seaweedfs_tpu_torch.storage.ec.encoder import codec_for

# one intra-op thread: the plain torch versions are small here, and a
# thread per core would crowd the other test workers on this host
torch.set_num_threads(1)

SMALL = {"rs": 1024, "lrc": 1024, "clay": clay_matrix.code(10, 4).alpha * 16}
KINDS = ["rs", "clay", "lrc"]
LOST = [0, 5, 12]


def geometries(kind):
    """(port, JAX package) geometry: 4 small blocks per large block, so a
    .dat of one large row and a few small rows runs both paths."""
    args = dict(data_shards=10, parity_shards=4,
                large_block_size=4 * SMALL[kind],
                small_block_size=SMALL[kind], code_kind=kind,
                lrc_locals=2 if kind == "lrc" else 0)
    return ec.EcGeometry(**args), ref_ec.EcGeometry(**args)


@pytest.fixture(scope="module")
def mesh():
    return mc.default_ec_mesh([torch.device("cpu")] * 8)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _dat(directory, name, payload, geo=None):
    base = os.path.join(directory, name)
    with open(base + ".dat", "wb") as f:
        f.write(payload)
    if geo is not None:     # what rebuild_ec_files_batch reads back
        ec.save_volume_info(base, 3, dat_size=len(payload),
                            data_shards=geo.data_shards,
                            parity_shards=geo.parity_shards,
                            large_block_size=geo.large_block_size,
                            small_block_size=geo.small_block_size,
                            code_kind=geo.code_kind,
                            lrc_locals=geo.lrc_locals)
    return base


def _payload(geo, seed, extra):
    size = geo.large_row_size() + 2 * geo.small_row_size() + extra
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def _codec_type(kind):
    return {"rs": mc.MeshCodec, "clay": ec.ClayWindowCodec,
            "lrc": ec.LrcWindowCodec}[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_write_and_rebuild_equal_reference(tmp_path, mesh, kind):
    geo, ref_geo = geometries(kind)
    payload = _payload(geo, 7, 333)
    ref_base = _dat(str(tmp_path), "ref", payload)
    base = _dat(str(tmp_path), "port", payload)
    ref_ec.write_ec_files(ref_base, ref_geo)
    codec = codec_for(geo, device=mesh)
    assert type(codec) is _codec_type(kind) and codec.mesh is mesh
    ec.write_ec_files(base, geo, codec)
    golden = {s: _read(ref_base + ec.to_ext(s)) for s in range(14)}
    for s in range(14):
        assert _read(base + ec.to_ext(s)) == golden[s], s
    for s in LOST:
        os.remove(base + ec.to_ext(s))
    assert ec.rebuild_ec_files(base, geo, codec_for(geo, device=mesh)) \
        == LOST
    for s in range(14):
        assert _read(base + ec.to_ext(s)) == golden[s], s


@pytest.mark.parametrize("kind", KINDS)
def test_fleet_batch_equals_reference(tmp_path, mesh, kind):
    geo, ref_geo = geometries(kind)
    payload = [_payload(geo, 20 + v, 1000) for v in range(3)]
    ref_bases = [_dat(str(tmp_path), f"r{v}", p)
                 for v, p in enumerate(payload)]
    bases = [_dat(str(tmp_path), f"p{v}", p, geo)
             for v, p in enumerate(payload)]
    ref_ec.encode_ec_files_batch(ref_bases, ref_geo)
    codec = codec_for(geo, device=mesh)
    ec.encode_ec_files_batch(bases, geo, codec)
    golden = {(v, s): _read(rb + ec.to_ext(s))
              for v, rb in enumerate(ref_bases) for s in range(14)}
    for v, b in enumerate(bases):
        for s in range(14):
            assert _read(b + ec.to_ext(s)) == golden[v, s], (v, s)
    for b in bases:
        for s in LOST:
            os.remove(b + ec.to_ext(s))
    rebuilt = ec.rebuild_ec_files_batch(bases, codec=codec)
    assert rebuilt == {b: LOST for b in bases}
    for v, b in enumerate(bases):
        for s in range(14):
            assert _read(b + ec.to_ext(s)) == golden[v, s], (v, s)


@pytest.mark.parametrize("kind", KINDS)
def test_pickers(mesh, kind):
    geo, _ = geometries(kind)
    assert not mc.multi_device_host()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            codec_for(geo)
    codec = codec_for(geo, device=mesh)
    assert type(codec) is _codec_type(kind) and codec.mesh is mesh
    if kind != "rs":    # rebuilds and repairs: the mesh's first position
        assert codec.device == torch.device("cpu")
    single = codec_for(geo, device="cpu")
    assert getattr(single, "mesh", None) is None
    assert isinstance(single, RSCodec if kind == "rs"
                      else _codec_type(kind))
    if kind == "rs":
        assert codec_for(geo, codec) is codec
        with pytest.raises(ValueError):
            codec_for(geometries("clay")[0], codec)


def test_serving_bind_on_a_mesh(tmp_path, mesh):
    """bind(mesh): encode and rebuild on the mesh, EC volumes on one
    device; the shards equal the JAX package's."""
    bound = serving.bind(mesh)
    assert bound.device is mesh
    for kind in ("lrc", "clay"):
        geo, ref_geo = geometries(kind)
        payload = _payload(geo, 30, 77)
        d = tmp_path / kind
        d.mkdir()
        ref_base = _dat(str(d), "ref", payload)
        base = _dat(str(d), "1", payload)
        ref_ec.write_ec_files(ref_base, ref_geo)
        with open(base + ".idx", "wb"):
            pass
        bound.encode_volume_to_ec(base, version=3, geo=geo)
        for s in range(14):
            assert _read(base + ec.to_ext(s)) == \
                _read(ref_base + ec.to_ext(s)), (kind, s)
        os.remove(base + ec.to_ext(3))
        assert bound.rebuild_ec_files(base) == [3]
        assert _read(base + ec.to_ext(3)) == _read(ref_base + ec.to_ext(3))
        ev = bound.EcVolume(str(d), "", 1)
        assert ev.codec.mesh is None and ev.codec.device.type == "cpu"
        ev.close()
    assert codes.placement(mesh) == (mesh, torch.device("cpu"))
