"""The port's multi-device codec (seaweedfs_tpu_torch.parallel) against the
JAX package's, byte for byte: the port's mesh is `[torch.device("cpu")] *
n`, the JAX package's is `jax.devices()[:n]` on the 8 virtual CPU devices
tests/conftest.py gives it.  Covers the mesh shapes, the XOR ring (with
every position holding the same input, which an aliased in-place XOR would
zero) and the reduce onto one position, the mesh's device names and
stream waits, the volume- and shard-parallel products with zero-shard
padding, MeshCodec (encode, reconstruct, data_only, batched volumes,
verify, its codec metrics) and the LRC and Clay mesh arms.  Every input comes from a
numpy seed; every comparison is exact (tolerance 0).
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from seaweedfs_tpu.ops import codec as ref_codec_mod
from seaweedfs_tpu.ops import gf256, lrc as ref_lrc, rs_matrix
from seaweedfs_tpu.parallel import mesh as ref_meshlib
from seaweedfs_tpu.parallel import mesh_codec as ref_mc
from seaweedfs_tpu.parallel import sharded_codec as ref_sc
from seaweedfs_tpu_torch.ops import codec as codec_mod
from seaweedfs_tpu_torch.ops.codec import RSCodec
from seaweedfs_tpu_torch.parallel import mesh as meshlib
from seaweedfs_tpu_torch.parallel import mesh_codec as mc
from seaweedfs_tpu_torch.parallel import sharded_codec as sc
from seaweedfs_tpu_torch.storage import ec

# one intra-op thread: the plain torch versions are small here, and a
# thread per core would crowd the other test workers on this host
torch.set_num_threads(1)

CPU = torch.device("cpu")


def cpus(n):
    return [CPU] * n


def rand(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def mesh8():
    return mc.default_ec_mesh(cpus(8))


@pytest.fixture(scope="module")
def ref_mesh8():
    return ref_mc.default_ec_mesh(jax.devices()[:8])


# -- meshes ------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_default_mesh_shape_equals_reference(n):
    mesh = mc.default_ec_mesh(cpus(n))
    ref = ref_mc.default_ec_mesh(jax.devices()[:n])
    assert mesh.axis_names == tuple(ref.axis_names) == ("s", "b")
    assert mesh.shape == dict(ref.shape)
    assert mesh.devices.shape == ref.devices.shape and mesh.size == n


def test_make_mesh_and_volume_sharding():
    mesh = meshlib.make_mesh(4, 2, cpus(8))
    assert mesh.shape == {"v": 4, "b": 2}
    data = rand(1, (8, 10, 64))
    blocks = meshlib.volume_sharding(mesh, data)
    assert blocks.shape == (4, 2)
    for (i, j) in mesh.positions():
        assert np.array_equal(blocks[i, j].numpy(),
                              data[2 * i:2 * i + 2, :, 32 * j:32 * j + 32])
    with pytest.raises(ValueError):
        meshlib.make_mesh(3, 2, cpus(8))


def test_shard_pads_with_zeros_and_gather_crops():
    mesh = mc.default_ec_mesh(cpus(8))
    x = rand(2, (10, 100))
    parts = meshlib.shard(mesh, x, ("s", "b"), (12, 128))
    # s=4: the last row block holds shards 9, 10, 11 -> 10 and 11 are pads
    last = parts[3, 1].numpy()
    assert last.shape == (3, 64)
    assert not last[1:].any() and not last[0, 36:].any()
    assert np.array_equal(last[0, :36], x[9, 64:])
    assert np.array_equal(meshlib.gather_begin(mesh, parts, ("s", "b"),
                                               (10, 100))(), x)


def test_local_devices_need_cuda():
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in meshlib.local_devices())
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        meshlib.local_devices()
    with pytest.raises(RuntimeError, match="CUDA"):
        mc.default_ec_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        mc.MeshCodec(10, 4)
    assert not mc.multi_device_host()


# -- the XOR ring --------------------------------------------------------------

def _ref_xor_psum(n, vals):
    mesh = ref_meshlib.make_mesh(n, 1, devices=jax.devices()[:n])
    fn = jax.jit(ref_meshlib.shard_map(
        lambda x: ref_sc.xor_psum(x, "v"), mesh=mesh,
        in_specs=P("v", None, None), out_specs=P("v", None, None),
        check_vma=False))
    return np.asarray(fn(jnp.asarray(vals)))


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_xor_psum_matches_reference(n):
    vals = rand(10 + n, (n, 4, 128))
    mesh = meshlib.make_mesh(n, 1, cpus(n))
    parts = meshlib.shard(mesh, vals.reshape(n * 4, 128), ("v", None))
    got = sc.xor_psum(parts, mesh, "v")
    ref = _ref_xor_psum(n, vals)
    want = np.bitwise_xor.reduce(vals, axis=0)
    for d in range(n):
        assert np.array_equal(ref[d], want)
        assert np.array_equal(got[d, 0].numpy(), want), f"position {d}"


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_xor_psum_same_input_everywhere(n):
    """Every position holds the same tensor: the XOR of n copies is zeros
    for even n and the input for odd n.  On a mesh of one repeated device
    each ring step's `.to()` is the tensor itself, so an in-place XOR of
    the accumulator with the block in flight would break this."""
    x = rand(20 + n, (4, 128))
    mesh = meshlib.make_mesh(n, 1, cpus(n))
    same = torch.from_numpy(x.copy())
    parts = np.empty(mesh.devices.shape, dtype=object)
    for pos in mesh.positions():
        parts[pos] = same
    got = sc.xor_psum(parts, mesh, "v")
    want = x if n % 2 else np.zeros_like(x)
    ref = _ref_xor_psum(n, np.stack([x] * n))
    for d in range(n):
        assert np.array_equal(ref[d], want)
        assert np.array_equal(got[d, 0].numpy(), want), f"position {d}"
    assert np.array_equal(same.numpy(), x), "the input was written"


@pytest.mark.parametrize("same", [False, True], ids=["distinct", "same"])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_xor_reduce_onto_first_position(n, same):
    """The reduce MeshCodec's reconstruct runs: the first position of the
    axis holds row 0 of the reference's all-reduce, the others None; with
    every position holding one tensor (no copy between positions of a
    repeated device) the input stays unwritten."""
    vals = np.stack([rand(30 + n, (4, 128))] * n) if same \
        else rand(40 + n, (n, 4, 128))
    mesh = meshlib.make_mesh(1, n, cpus(n))      # reduce over "b"
    if same:
        one = torch.from_numpy(vals[0].copy())
        parts = np.empty(mesh.devices.shape, dtype=object)
        for pos in mesh.positions():
            parts[pos] = one
    else:
        parts = meshlib.shard(mesh, np.concatenate(list(vals), axis=1),
                              (None, "b"))
    got = sc.xor_reduce(parts, mesh, "b")
    want = _ref_xor_psum(n, vals)[0]
    assert np.array_equal(want, np.bitwise_xor.reduce(vals, axis=0))
    assert np.array_equal(got[0, 0].numpy(), want)
    assert all(got[0, j] is None for j in range(1, n))
    if same:
        assert np.array_equal(one.numpy(), vals[0]), "the input was written"


# -- mesh devices and streams ----------------------------------------------------

def test_mesh_names_cuda_devices_by_index():
    """A bare "cuda" becomes the current device's index, so tensors'
    devices, the per-device caches and the mesh's streams agree."""
    with mock.patch("torch.cuda.current_device", lambda: 1):
        mesh = mc.default_ec_mesh([torch.device("cuda")] * 3
                                  + ["cuda:0", CPU])
    assert list(mesh.devices.flat) == [torch.device("cuda", 1)] * 3 + [
        torch.device("cuda", 0), CPU]


def test_issue_waits_for_the_streams_current_before():
    """issue() makes each device's mesh stream wait for the stream that
    was current there, then current; nested, it waits for nothing more."""
    calls, current = [], {}
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)

    class FakeStream:
        def __init__(self, dev):
            self.dev = dev

        def wait_stream(self, other):
            calls.append(("wait", self.dev, other))

    @contextlib.contextmanager
    def make_current(stream):
        prev = current.get(stream.dev, "default")
        current[stream.dev] = stream
        calls.append(("current", stream.dev))
        yield
        current[stream.dev] = prev

    with mock.patch("torch.cuda.Stream", FakeStream), \
            mock.patch("torch.cuda.stream", make_current), \
            mock.patch("torch.cuda.current_stream",
                       lambda dev: current.get(dev, "default")):
        mesh = mc.default_ec_mesh([cuda0, cuda1] * 2)
        with mesh.issue():
            inner = len(calls)
            with mesh.issue():
                pass
        streams = mesh.streams()
    assert calls[:inner] == [("wait", cuda0, "default"), ("current", cuda0),
                             ("wait", cuda1, "default"), ("current", cuda1)]
    assert calls[inner:] == [("current", cuda0), ("current", cuda1)]
    assert current == {cuda0: "default", cuda1: "default"}
    assert set(streams) == {cuda0, cuda1}


# -- volume- and shard-parallel products ---------------------------------------

def test_encode_volumes_matches_reference():
    k, m = 10, 4
    data = rand(30, (8, k, 1024))
    pbits = rs_matrix.parity_bit_matrix(k, m)
    got = sc.encode_volumes(meshlib.make_mesh(4, 2, cpus(8)), pbits, data)
    ref_mesh = ref_meshlib.make_mesh(4, 2, devices=jax.devices()[:8])
    ref = np.asarray(jax.jit(lambda d: ref_sc.encode_volumes(
        ref_mesh, jnp.asarray(pbits), d))(jnp.asarray(data)))
    assert np.array_equal(got, ref)
    gen = rs_matrix.generator_matrix(k, m)
    for v in range(8):
        assert np.array_equal(got[v], gf256.matmul(gen[k:], data[v]))


def _ref_matmul(n_dev, k, m, bits, padded, byte_axis):
    mesh = ref_meshlib.make_mesh(n_dev, 8 // n_dev,
                                 devices=jax.devices()[:8])
    fn, k_pad = ref_sc.make_shard_parallel_matmul(mesh, "v", k, m,
                                                  byte_axis=byte_axis)
    out = fn(jnp.asarray(bits), jnp.asarray(
        padded.reshape(k_pad, 8, -1)))
    return np.asarray(out).reshape(m, -1)


def _port_matmul(n_dev, k, m, bits, padded, byte_axis):
    mesh = meshlib.make_mesh(n_dev, 8 // n_dev, cpus(8))
    fn, k_pad = sc.make_shard_parallel_matmul(mesh, "v", k, m,
                                              byte_axis=byte_axis)
    assert k_pad == padded.shape[0]
    shards = meshlib.shard(mesh, padded, ("v", byte_axis))
    spec = (None, byte_axis)
    return meshlib.gather_begin(mesh, fn(bits, shards), spec,
                                (m, padded.shape[1]))()


@pytest.mark.parametrize("byte_axis", [None, "b"])
@pytest.mark.parametrize("n_dev,k,m", [(8, 10, 4), (4, 16, 8), (8, 28, 4),
                                       (4, 10, 4)])
def test_shard_parallel_encode_matches_reference(n_dev, k, m, byte_axis):
    """k padded to a multiple of the axis with zero shards (10 over 8 is
    16, 10 over 4 is 12, 28 over 8 is 32)."""
    B = 512
    data = rand(40 + k, (k, B))
    k_pad = -(-k // n_dev) * n_dev
    padded = np.zeros((k_pad, B), dtype=np.uint8)
    padded[:k] = data
    full = np.zeros((m, k_pad), dtype=np.uint8)
    full[:, :k] = rs_matrix.generator_matrix(k, m)[k:]
    bits = rs_matrix.bit_matrix(full)
    got = _port_matmul(n_dev, k, m, bits, padded, byte_axis)
    want = gf256.matmul(rs_matrix.generator_matrix(k, m)[k:], data)
    assert np.array_equal(got, want)
    assert np.array_equal(got, _ref_matmul(n_dev, k, m, bits, padded,
                                           byte_axis))
    # the encoder form: the same product with the bit matrix bound
    mesh = meshlib.make_mesh(n_dev, 8 // n_dev, cpus(8))
    enc, k_pad2 = sc.make_shard_parallel_encoder(mesh, "v", k, m)
    assert k_pad2 == k_pad
    out = enc(meshlib.shard(mesh, padded, ("v", None)))
    for pos in mesh.positions():
        if pos[0]:      # reduced onto the first position of the axis
            assert out[pos] is None, pos
        else:
            assert np.array_equal(out[pos].numpy(), want), pos


def test_shard_parallel_reconstruct_matches_reference():
    n_dev, k, m, B = 8, 10, 4, 256
    gen = rs_matrix.generator_matrix(k, m)
    shards = gf256.matmul(gen, rand(50, (k, B)))
    mesh = meshlib.make_mesh(n_dev, 1, cpus(8))
    rec, k_pad = sc.make_shard_parallel_reconstructor(mesh, "v", k, m)
    for lost in ([2, 5, 11, 13], [0, 10]):
        present = [i for i in range(k + m) if i not in lost]
        D = rs_matrix.decode_matrix(gen, present, lost)
        bits = sc.pad_decode_bits(D, m, k, k_pad)
        assert np.array_equal(bits, ref_sc.pad_decode_bits(D, m, k, k_pad))
        chosen = np.zeros((k_pad, B), dtype=np.uint8)
        chosen[:k] = shards[present[:k]]
        out = rec(bits, meshlib.shard(mesh, chosen, ("v", None)))
        got = out[0, 0].numpy()
        assert np.array_equal(got[:len(lost)], shards[lost])
        assert np.array_equal(got, _ref_matmul(n_dev, k, m, bits, chosen,
                                               None))


# -- MeshCodec -------------------------------------------------------------------

@pytest.mark.parametrize("k,m", [(10, 4), (16, 8)])
@pytest.mark.parametrize("shape", [(1111,), (3, 515)], ids=["B1111", "V3"])
def test_mesh_encode_matches_reference(mesh8, ref_mesh8, k, m, shape):
    data = rand(60 + k, shape[:-1] + (k, shape[-1]))
    codec = mc.MeshCodec(k, m, mesh=mesh8)
    assert codec.backend == "mesh"
    got = codec.encode(data)
    assert got.shape == shape[:-1] + (m, shape[-1])
    assert np.array_equal(got, ref_mc.MeshCodec(k, m, mesh=ref_mesh8)
                          .encode(data))
    assert np.array_equal(got, RSCodec(k, m, device="cpu").encode(data))


def _codeword(seed, k=10, m=4, shape=(777,)):
    gen = rs_matrix.generator_matrix(k, m)
    data = rand(seed, shape[:-1] + (k, shape[-1]))
    return np.stack([gf256.matmul(gen, d) for d in data.reshape(
        -1, k, shape[-1])], axis=1).reshape((k + m,) + shape)


@pytest.mark.parametrize("lost", [[0], [1, 12], [0, 4, 9, 13]])
@pytest.mark.parametrize("data_only", [False, True])
def test_mesh_reconstruct_matches_reference(mesh8, ref_mesh8, lost,
                                            data_only):
    shards = _codeword(70)
    holes = [None if i in lost else shards[i] for i in range(14)]
    got = mc.MeshCodec(10, 4, mesh=mesh8).reconstruct(
        list(holes), data_only=data_only)
    ref = ref_mc.MeshCodec(10, 4, mesh=ref_mesh8).reconstruct(
        list(holes), data_only=data_only)
    for i in range(14):
        if data_only and i in lost and i >= 10:
            assert got[i] is None and ref[i] is None
            continue
        assert np.array_equal(got[i], shards[i]), i
        assert np.array_equal(got[i], ref[i]), i


@pytest.mark.parametrize("lost", [[3], [1, 4, 8, 12], [10, 11, 12, 13]])
def test_mesh_reconstruct_rows_decodes_only_targets(mesh8, ref_mesh8, lost):
    """The rebuild's form on the mesh: survivors gathered by the caller,
    the rows of `lost` in the order asked, equal to the JAX package's
    list-form reconstruct, and the decode matrix holds only those rows."""
    shards = _codeword(75)
    used = [i for i in range(14) if i not in lost][:10]
    targets = lost[::-1]
    codec = mc.MeshCodec(10, 4, mesh=mesh8)
    chunks = []
    real = codec.reconstruct_device

    def spy(present, chunk, parts):
        chunks.append(chunk)
        return real(present, chunk, parts)

    with mock.patch.object(codec, "reconstruct_device", spy):
        got = codec.reconstruct_rows_begin(
            np.stack([shards[i] for i in used]), used, targets)()
    assert chunks == [tuple(targets)]
    ref = ref_mc.MeshCodec(10, 4, mesh=ref_mesh8).reconstruct(
        [None if i in lost else shards[i] for i in range(14)])
    assert got.shape == (len(lost), shards[0].shape[-1])
    for row, t in enumerate(targets):
        assert np.array_equal(got[row], shards[t]), t
        assert np.array_equal(got[row], ref[t]), t


def test_mesh_reconstruct_batched_volumes(mesh8, ref_mesh8):
    V, B = 5, 384
    shards = _codeword(80, shape=(V, B))      # [14, V, B]
    lost = [0, 3, 11]
    holes = [None if i in lost else np.ascontiguousarray(shards[i])
             for i in range(14)]
    got = mc.MeshCodec(10, 4, mesh=mesh8).reconstruct(holes)
    ref = ref_mc.MeshCodec(10, 4, mesh=ref_mesh8).reconstruct(holes)
    for i in lost:
        assert got[i].shape == (V, B)
        assert np.array_equal(got[i], shards[i]), i
        assert np.array_equal(got[i], ref[i]), i


def test_mesh_reconstruct_errors_and_verify(mesh8, ref_mesh8):
    codec = mc.MeshCodec(10, 4, mesh=mesh8)
    ref = ref_mc.MeshCodec(10, 4, mesh=ref_mesh8)
    too_few = [np.zeros(128, np.uint8)] * 9 + [None] * 5
    for c in (codec, ref):
        with pytest.raises(ValueError):
            c.reconstruct(list(too_few))
        with pytest.raises(ValueError):
            c.reconstruct([None] * 13)
    shards = list(_codeword(90, shape=(300,)))
    assert codec.verify(shards) and ref.verify(shards)
    bad = list(shards)
    bad[10] = bad[10] ^ np.uint8(1)
    assert not codec.verify(bad) and not ref.verify(bad)
    full = codec.reconstruct(list(shards))
    assert all(a is b for a, b in zip(full, shards))


class Delta:
    """(bytes, dispatches, volumes) added under one label of one package's
    codec metrics since construction."""

    def __init__(self, mod, op):
        self.m, self.label = mod.codec_metrics(), ("rs_mesh", op)
        self.start = self.now()

    def now(self):
        m, lb = self.m, self.label
        return (m.bytes.value(*lb), m.dispatch.value(*lb),
                m.dispatch_volumes.value(*lb))

    def __call__(self):
        return tuple(b - a for a, b in zip(self.start, self.now()))


def test_rs_mesh_metrics_equal_reference(mesh8, ref_mesh8):
    got = {}
    for mod, codec in ((codec_mod, mc.MeshCodec(10, 4, mesh=mesh8)),
                       (ref_codec_mod, ref_mc.MeshCodec(10, 4,
                                                        mesh=ref_mesh8))):
        enc, rec = Delta(mod, "encode"), Delta(mod, "reconstruct")
        codec.encode(rand(100, (10, 500)))
        codec.encode(rand(101, (3, 10, 200)))
        shards = _codeword(102, shape=(4, 96))
        codec.reconstruct([None if i in (1, 12) else shards[i]
                           for i in range(14)])
        codec.reconstruct([None if i == 5 else shards[i, 0]
                           for i in range(14)])
        got[mod.__name__] = (enc(), rec())
    port, ref = got.values()
    assert port == ref == ((5000 + 6000, 2, 4), (10 * 384 + 10 * 96, 2, 5))


# -- the LRC and Clay mesh arms --------------------------------------------------

def test_gf_mesh_encode_lrc_matches_reference(mesh8, ref_mesh8):
    geo = ref_lrc.LrcGeometry(k=10, l=2, r=2)
    rows = np.ascontiguousarray(ref_lrc.generator_matrix(geo)[10:])
    data = rand(110, (10, 3001))
    got = mc.gf_mesh_encode_begin(rows, data, mesh=mesh8)()
    assert np.array_equal(got, ref_mc.gf_mesh_encode_begin(
        rows, data, mesh=ref_mesh8)())
    assert np.array_equal(got, gf256.matmul(rows, data))
    assert np.array_equal(got, codec_mod.gf_apply(rows, data, device="cpu"))


@pytest.mark.parametrize("n_win", [10, 3])
def test_clay_mesh_encode_matches_reference(mesh8, ref_mesh8, n_win):
    """Clay(10,4), 256*16-byte windows: 10 windows over 8 positions pad to
    16 with zero windows, 3 leave five positions all padding."""
    small = 256 * 16
    data = rand(120 + n_win, (10, n_win * small))
    got = mc.clay_mesh_encode_begin(10, 4, data, small, mesh=mesh8)()
    assert got.shape == (4, n_win * small)
    assert np.array_equal(got, ref_mc.clay_mesh_encode_begin(
        10, 4, data, small, mesh=ref_mesh8)())
    single = ec.ClayWindowCodec(ec.EcGeometry(10, 4, small_block_size=small,
                                              code_kind="clay"),
                                device="cpu")
    assert np.array_equal(got, single.encode(data))
