"""The port's GF(2^8) codec (seaweedfs_tpu_torch.ops) against the JAX
package, on the CPU: the same seeded numpy inputs go through the Pallas
kernel (interpret mode), the XLA bit-plane matmul, the numpy GF(2^8) tables
and the port's plain torch version of the CUDA kernel.  The codec is
bit-exact, so every comparison is byte equality (tolerance zero)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf256 as ref_gf256
from seaweedfs_tpu.ops import rs_jax, rs_pallas
from seaweedfs_tpu.ops import rs_matrix as ref_rs_matrix
from seaweedfs_tpu.ops.codec import RSCodec as RefCodec
from seaweedfs_tpu_torch.ops import gf256, rs_cuda, rs_matrix, rs_torch
from seaweedfs_tpu_torch.ops.codec import RSCodec

# one intra-op thread: the plain torch versions are small here, and a
# thread per core would crowd the other test workers on this host
torch.set_num_threads(1)

GEOMETRIES = [(10, 4, "vandermonde"), (16, 8, "vandermonde"),
              (28, 4, "cauchy")]


def _loss(k, m, n_lost, seed):
    """A seeded loss pattern: (present, lost) shard ids."""
    rng = np.random.default_rng(seed)
    lost = sorted(rng.choice(k + m, size=n_lost, replace=False).tolist())
    return [i for i in range(k + m) if i not in lost], lost


def _matrix(k, m, kind, which):
    gen = ref_rs_matrix.generator_matrix(k, m, kind)
    if which == "parity":
        return gen[k:]
    present, lost = _loss(k, m, min(m, 4), seed=k + m)
    return ref_rs_matrix.decode_matrix(gen, present, lost)


@pytest.mark.parametrize("k,m,kind", GEOMETRIES)
def test_tables_and_matrices_match_reference(k, m, kind):
    assert np.array_equal(gf256.MUL_TABLE, ref_gf256.MUL_TABLE)
    vm = ref_rs_matrix.vandermonde(k, k)
    assert np.array_equal(gf256.mat_inv(vm), ref_gf256.mat_inv(vm))
    gen = rs_matrix.generator_matrix(k, m, kind)
    assert np.array_equal(gen, ref_rs_matrix.generator_matrix(k, m, kind))
    assert np.array_equal(rs_matrix.bit_matrix(gen),
                          ref_rs_matrix.bit_matrix(gen))
    present, lost = _loss(k, m, m, seed=1)
    assert np.array_equal(rs_matrix.decode_matrix(gen, present, lost),
                          ref_rs_matrix.decode_matrix(gen, present, lost))


@pytest.mark.parametrize("k,m,kind", GEOMETRIES)
def test_plane_major_matches_reference(k, m, kind):
    bits = ref_rs_matrix.bit_matrix(_matrix(k, m, kind, "decode"))
    mo = bits.shape[0] // 8
    want = rs_pallas.to_plane_major(bits, mo, k)
    assert np.array_equal(rs_cuda.to_plane_major(bits, mo, k), want)
    assert np.array_equal(rs_cuda.from_reference(bits).numpy(), want)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
@pytest.mark.parametrize("which", ["parity", "decode"])
@pytest.mark.parametrize("k,m,kind", GEOMETRIES)
def test_bit_matmul_matches_pallas_xla_and_tables(k, m, kind, which, dtype):
    """gf_matmul_bits_plain and rs_torch.gf_matmul_bits against the Pallas
    shard-major kernel (interpret mode), rs_jax and gf256.matmul."""
    M = _matrix(k, m, kind, which)
    mo = M.shape[0]
    bits = ref_rs_matrix.bit_matrix(M)
    rng = np.random.default_rng(k * 100 + mo)
    d = rng.integers(0, 256, (k, 8, 256), dtype=np.uint8)   # [KI, V, B]
    pallas = np.asarray(rs_pallas.gf_matmul_bits_pallas_sm(
        jnp.asarray(rs_pallas.to_plane_major(bits, mo, k), dtype=jnp.int8),
        jnp.asarray(d), block_b=256, interpret=True))         # [MO, V, B]
    vmajor = np.ascontiguousarray(d.transpose(1, 0, 2))        # [V, KI, B]
    xla = np.asarray(rs_jax.gf_matmul_bits(jnp.asarray(bits),
                                           jnp.asarray(vmajor)))
    planes = rs_cuda.from_reference(bits).to(dtype)
    plain = rs_cuda.gf_matmul_bits_plain(planes,
                                         torch.from_numpy(vmajor)).numpy()
    twin = rs_torch.gf_matmul_bits(torch.from_numpy(bits),
                                   torch.from_numpy(vmajor)).numpy()
    for v in range(8):
        want = ref_gf256.matmul(M, d[:, v, :])
        assert np.array_equal(pallas[:, v, :], want)
        assert np.array_equal(xla[v], want)
        assert np.array_equal(plain[v], want), v
        assert np.array_equal(twin[v], want), v


def test_unpack_pack_match_rs_jax():
    d = np.random.default_rng(0).integers(0, 256, (2, 3, 40), dtype=np.uint8)
    planes = rs_torch.unpack_bits(torch.from_numpy(d))
    assert np.array_equal(planes.numpy(),
                          np.asarray(rs_jax.unpack_bits(jnp.asarray(d))))
    assert np.array_equal(rs_torch.pack_bits(planes).numpy(), d)


@pytest.mark.parametrize("shape", [(10, 1), (10, 1000), (10, 1024 + 17),
                                   (3, 10, 777)])
def test_cuda_wrapper_cpu_path_any_width(shape):
    """The wrapper takes [KI, N] or [V, KI, N] with any N (no TPU block
    padding) and, on CPU tensors, returns the tables' bytes."""
    M = _matrix(10, 4, "vandermonde", "parity")
    d = np.random.default_rng(7).integers(0, 256, shape, dtype=np.uint8)
    out = rs_cuda.gf_matmul_bits_cuda(rs_cuda.matrix_planes(M),
                                      torch.from_numpy(d)).numpy()
    flat = d.reshape(-1, 10, shape[-1])
    got = out.reshape(-1, 4, shape[-1])
    for v in range(flat.shape[0]):
        assert np.array_equal(got[v], ref_gf256.matmul(M, flat[v]))


@pytest.mark.parametrize("bad", ["dtype", "matrix_dtype", "shape", "rank",
                                 "contiguous", "matrix_shape"])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(bad):
    planes = rs_cuda.matrix_planes(_matrix(10, 4, "vandermonde", "parity"))
    d = torch.zeros((10, 64), dtype=torch.uint8)
    if bad == "dtype":
        d = d.to(torch.int32)
    elif bad == "matrix_dtype":
        planes = planes.to(torch.float32)
    elif bad == "shape":
        d = torch.zeros((9, 64), dtype=torch.uint8)
    elif bad == "rank":
        d = torch.zeros((1, 1, 10, 64), dtype=torch.uint8)
    elif bad == "contiguous":
        d = torch.zeros((10, 128), dtype=torch.uint8)[:, ::2]
    else:
        planes = planes[:, :-8]
    with pytest.raises((TypeError, ValueError)):
        rs_cuda.gf_matmul_bits_cuda(planes, d)


# -- RSCodec against the JAX package's RSCodec -----------------------------

@pytest.fixture(scope="module")
def ref_codecs():
    return {
        "pallas": RefCodec(10, 4, backend="pallas", interpret=True,
                           block_b=256),
        "numpy": RefCodec(10, 4, backend="numpy"),
    }


@pytest.fixture(scope="module")
def codec():
    return RSCodec(10, 4, device="cpu")


@pytest.mark.parametrize("shape", [(10, 1000), (3, 10, 300)])
def test_codec_encode_matches_reference(codec, ref_codecs, shape):
    data = np.random.default_rng(11).integers(0, 256, shape, dtype=np.uint8)
    parity = codec.encode(data)
    for ref in ref_codecs.values():
        assert np.array_equal(parity, ref.encode(data))


@pytest.mark.parametrize("data_only", [False, True])
@pytest.mark.parametrize("n_lost", [1, 2, 3, 4])
def test_codec_reconstruct_matches_reference(codec, ref_codecs, n_lost,
                                             data_only):
    rng = np.random.default_rng(20 + n_lost)
    data = rng.integers(0, 256, (10, 700), dtype=np.uint8)
    full = list(data) + list(codec.encode(data))
    _, lost = _loss(10, 4, n_lost, seed=n_lost)
    shards = [None if i in lost else s for i, s in enumerate(full)]
    got = codec.reconstruct(shards, data_only=data_only)
    for ref in ref_codecs.values():
        want = ref.reconstruct(shards, data_only=data_only)
        for i in range(14):
            if want[i] is None:
                assert got[i] is None and data_only and i >= 10
            else:
                assert np.array_equal(got[i], want[i]), i
                assert np.array_equal(got[i], full[i]), i


def test_codec_batched_reconstruct_matches_reference(codec, ref_codecs):
    """[V, B] shards: the fleet-rebuild form."""
    data = np.random.default_rng(3).integers(0, 256, (4, 10, 333),
                                             dtype=np.uint8)
    parity = codec.encode(data)
    full = [data[:, i] for i in range(10)] + [parity[:, i] for i in range(4)]
    shards = [None if i in (0, 5, 12) else s for i, s in enumerate(full)]
    got = codec.reconstruct(shards)
    want = ref_codecs["pallas"].reconstruct(shards)
    for i in range(14):
        assert np.array_equal(got[i], want[i])
        assert np.array_equal(got[i], full[i])


def test_codec_too_few_shards_raises(codec, ref_codecs):
    data = np.zeros((10, 64), dtype=np.uint8)
    full = list(data) + list(codec.encode(data))
    shards = [None if i < 5 else s for i, s in enumerate(full)]
    with pytest.raises(ValueError, match="too few"):
        codec.reconstruct(shards)
    with pytest.raises(ValueError, match="too few"):
        ref_codecs["numpy"].reconstruct(shards)
    with pytest.raises(ValueError):
        codec.reconstruct(full[:13])


def test_codec_verify(codec):
    data = np.random.default_rng(4).integers(0, 256, (10, 128),
                                             dtype=np.uint8)
    full = list(data) + list(codec.encode(data))
    assert codec.verify(full)
    full[12] = full[12] ^ np.uint8(1)
    assert not codec.verify(full)


@pytest.mark.parametrize("k,m,kind", GEOMETRIES[1:])
def test_wide_geometries_match_reference(k, m, kind):
    codec = RSCodec(k, m, kind=kind, device="cpu")
    ref = RefCodec(k, m, kind=kind, backend="numpy")
    data = np.random.default_rng(k).integers(0, 256, (k, 500),
                                             dtype=np.uint8)
    parity = codec.encode(data)
    assert np.array_equal(parity, ref.encode(data))
    full = list(data) + list(parity)
    _, lost = _loss(k, m, m, seed=9)
    shards = [None if i in lost else s for i, s in enumerate(full)]
    got = codec.reconstruct(shards)
    for i in lost:
        assert np.array_equal(got[i], full[i])
