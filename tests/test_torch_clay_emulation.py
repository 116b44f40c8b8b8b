"""Numpy models of the thread programs of the two CUDA clay kernels
(`clay_encode_kernel` and `clay_repair_kernel`,
seaweedfs_tpu_torch/csrc/clay_fused.cu), held byte for byte against the
kernels' plain versions (`clay_fused_encode_plain`,
`clay_fused_repair_plain`), against the JAX package's Pallas kernels run
through the interpreter and, for the repair, against the encoded shard.

The CUDA kernels cannot run on this CPU host.  A model runs every thread of
the launch at once, one numpy element per thread, and repeats the kernel's
steps on packed uint32 words: the items and warps, the two 16-byte loads of
a row and the guarded byte path at the ragged edge (`load_row` /
`store_row`, csrc/bitslice.cuh), `transpose8`, the shared mask expansion,
the plane-domain maps of the GF(2^8) constants, and the mask network.  The
encode's block holds the q layers of one class and exchanges their
uncoupled parity through the block's shared words; the repair's warps each
own one (window, plane rank, tile) item, read their known cells' own and
companion rows and the lost row's helpers, and write the lost node's q
cells of the item.  Clay is exact: every comparison is byte equality
(tolerance zero)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import clay_structured as ref_cs
from seaweedfs_tpu_torch.ops import clay_cuda
from seaweedfs_tpu_torch.ops import clay_structured as cs
from seaweedfs_tpu_torch.ops.clay import GAMMA
from seaweedfs_tpu_torch.ops.clay_matrix import code

torch.set_num_threads(1)

TILE = 1024          # kTileCols: columns per warp tile, 32 per thread
ONES = np.uint32(0xFFFFFFFF)


def gf_mul_byte(a: int, b: int) -> int:
    """The kernel's gf_mul_byte: shift-and-add modulo 0x11D."""
    r = 0
    for _ in range(8):
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a & 0x100:
            a ^= 0x11D
    return r


def swap_bits(a, b, s, m):
    t = ((a >> np.uint32(s)) ^ b) & np.uint32(m)
    return a ^ (t << np.uint32(s)), b ^ t


def transpose8(w):
    """bitslice.cuh transpose8 on 8 word arrays (an involution)."""
    w = list(w)
    for q in range(4):
        w[q], w[q + 4] = swap_bits(w[q], w[q + 4], 4, 0x0F0F0F0F)
    for q in (0, 4):
        w[q], w[q + 2] = swap_bits(w[q], w[q + 2], 2, 0x33333333)
        w[q + 1], w[q + 3] = swap_bits(w[q + 1], w[q + 3], 2, 0x33333333)
    for q in range(0, 8, 2):
        w[q], w[q + 1] = swap_bits(w[q], w[q + 1], 1, 0x55555555)
    return w


def _word_cols(q: int) -> int:
    """First byte column of word q of a thread, relative to its c0."""
    return 4 * q if q < 4 else 512 + 4 * (q - 4)


def load_row(flat, base, c0, n, vec):
    """bitslice.cuh load_row for every thread: two 16-byte loads where
    `vec`, else bytes at or past n read as 0."""
    shape = np.broadcast(base, c0, vec).shape
    base, c0, vec = (np.broadcast_to(a, shape) for a in (base, c0, vec))
    w = [np.zeros(shape, np.uint32) for _ in range(8)]
    if vec.any():
        for half in range(2):
            at = base[vec] + c0[vec] + 512 * half
            v = flat[at[:, None] + np.arange(16)].view("<u4")
            for q in range(4):
                w[4 * half + q][vec] = v[:, q]
    g = ~vec
    if g.any():
        for q in range(8):
            v = np.zeros(int(g.sum()), np.uint32)
            for lb in range(4):
                x = c0[g] + _word_cols(q) + lb
                ok = x < n
                byte = np.where(ok, flat[np.where(ok, base[g] + x, 0)], 0)
                v |= byte.astype(np.uint32) << np.uint32(8 * lb)
            w[q][g] = v
    return w


def store_row(flat, base, c0, n, vec, act, w):
    """bitslice.cuh store_row for the active threads."""
    shape = act.shape
    base, c0, vec = (np.broadcast_to(a, shape) for a in (base, c0, vec))
    sv, sg = act & vec, act & ~vec
    for half in range(2):
        words = np.stack([w[4 * half + q][sv] for q in range(4)], -1)
        at = base[sv] + c0[sv] + 512 * half
        flat[at[:, None] + np.arange(16)] = \
            np.ascontiguousarray(words, "<u4").view(np.uint8)
    for q in range(8):
        for lb in range(4):
            x = c0[sg] + _word_cols(q) + lb
            ok = x < n
            flat[(base[sg] + x)[ok]] = \
                (w[q][sg][ok] >> np.uint32(8 * lb)).astype(np.uint8)


def gf_const_planes(inp, cmap, out):
    """out[b] ^= XOR_j in[j] & map[j][b], map words 0 / ~0."""
    for j in range(8):
        for b in range(8):
            out[b] = out[b] ^ (inp[j] & cmap[j * 8 + b])


def emulate_encode(rbits: np.ndarray, data4: np.ndarray, *, q: int, t: int,
                   gamma: int, det_inv: int) -> np.ndarray:
    """The parity clay_encode_kernel<q> writes for data4 [k, n_win, alpha,
    w_a], every thread of the launch modelled at once."""
    k, n_win, alpha, w_a = data4.shape
    k0, beta, k_out = q * (t - 1), q ** (t - 1), 8 * q
    k_tiles = 8 // q                              # EncodeShape<Q>::kTiles
    pw = [q ** y for y in range(t + 1)]
    flat = np.ascontiguousarray(data4).reshape(-1)
    out = np.zeros(q * n_win * alpha * w_a, np.uint8)
    # prologue: the shared masks, then the gamma and det_inv maps
    rb = np.ascontiguousarray(rbits).reshape(-1)
    s_ix = np.arange(k0 * 8 * k_out)
    o, cj = s_ix % k_out, s_ix // k_out
    masks = np.where(rb[o * (8 * k0) + (cj & 7) * k0 + (cj >> 3)] != 0,
                     ONES, np.uint32(0))
    maps = np.array([ONES if (gf_mul_byte(c, 1 << j) >> b) & 1 else 0
                     for c in (gamma, det_inv) for j in range(8)
                     for b in range(8)], np.uint32)
    gmap, dmap = maps[:64], maps[64:]
    aligned = w_a % 16 == 0

    # the thread grid [item, slot, zt, lane]: block items walk (window,
    # class, tile group); warp = slot * q + zt
    tiles = -(-w_a // TILE)
    groups = -(-tiles // k_tiles)
    items = n_win * beta * groups
    it = np.arange(items).reshape(-1, 1, 1, 1)
    slot = np.arange(k_tiles).reshape(1, -1, 1, 1)
    zt = np.arange(q).reshape(1, 1, -1, 1)
    lane = np.arange(32).reshape(1, 1, 1, -1)
    tile = (it % groups) * k_tiles + slot
    rest = it // groups
    s = rest % beta
    win = rest // beta
    z = s + zt * beta
    shape = np.broadcast(it, slot, zt, lane).shape
    active = np.broadcast_to(tile < tiles, shape)
    c0 = tile * TILE + 16 * lane
    vec = np.broadcast_to(aligned & (c0 + 528 <= w_a), shape)
    zero = np.zeros(shape, np.uint32)

    acc = [zero.copy() for _ in range(k_out)]
    # cell i = y*q + x (the kernel issues cell i+1's loads before cell i's
    # network; the model runs them in program order)
    for i in range(k0):
        y, x = divmod(i, q)
        zy = (s // pw[y]) % q
        comp = y * q + zy
        if i < k:
            u = transpose8(load_row(
                flat, ((i * n_win + win) * alpha + z) * w_a, c0, w_a, vec))
        else:                 # virtual nodes store zeros
            u = [zero.copy() for _ in range(8)]
        has = np.broadcast_to((zy != x) & (comp < k), shape)
        crow = np.where(has, ((comp * n_win + win) * alpha + z
                              + (x - zy) * pw[y]) * w_a, 0)
        cw = transpose8(load_row(flat, crow, c0, w_a, vec & has))
        gu = [a.copy() for a in u]
        gf_const_planes(cw, gmap, gu)
        u = [np.where(has, a, b) for a, b in zip(gu, u)]
        live = has | (i < k)      # a virtual node with no real companion
        for j in range(8):        # adds no term: the kernel skips it
            for oo in range(k_out):
                m = masks[(i * 8 + j) * k_out + oo]
                acc[oo] = np.where(live, acc[oo] ^ (u[j] & m), acc[oo])

    # the exchange: each block's shared words [slot][zt][p][b][32 lanes]
    ex = np.zeros((items, k_tiles * q * q * 8 * 32), np.uint32)
    xs = np.broadcast_to(slot * (q * q * 8 * 32) + lane, shape)
    it_b = np.broadcast_to(it, shape)
    for p in range(q):
        for b in range(8):
            at = xs + ((zt * q + p) * 8 + b) * 32
            ex[it_b[active], at[active]] = acc[b * q + p][active]
    for p in range(q):
        e = [ex[it_b, xs + ((p * q + zt) * 8 + b) * 32] for b in range(8)]
        v = [acc[b * q + p].copy() for b in range(8)]
        gf_const_planes(e, gmap, v)
        w = [zero.copy() for _ in range(8)]
        gf_const_planes(v, dmap, w)
        diag = np.broadcast_to(zt == p, shape)
        w = transpose8([np.where(diag, acc[b * q + p], w[b])
                        for b in range(8)])
        store_row(out, ((p * n_win + win) * alpha + z) * w_a, c0, w_a, vec,
                  active, w)
    return out.reshape(q, n_win, alpha, w_a)


# -- the references -----------------------------------------------------------

N_WIN = 3


def _args(k, m):
    c = code(k, m)
    return dict(q=c.q, t=c.t, gamma=GAMMA, det_inv=int(c._det_inv))


def _plain_parity(data4: np.ndarray, k: int, m: int) -> np.ndarray:
    """clay_fused_encode_plain of data4 [k, n_win, alpha, w_a].  Columns are
    independent code instances, so it runs a window and 1024 columns at a
    time."""
    n_win, w_a = data4.shape[1], data4.shape[3]
    rbits = torch.from_numpy(cs.r_bits_plane_major(k, m))
    plain = np.empty((m,) + data4.shape[1:], np.uint8)
    for wi in range(n_win):
        for c0 in range(0, w_a, TILE):
            part = np.ascontiguousarray(data4[:, wi:wi + 1, :, c0:c0 + TILE])
            plain[:, wi:wi + 1, :, c0:c0 + TILE] = \
                clay_cuda.clay_fused_encode_plain(
                    rbits, torch.from_numpy(part), **_args(k, m)).numpy()
    return plain


def _pallas_padded(call, x: np.ndarray) -> np.ndarray:
    """call(x) through the Pallas interpreter, its tiles multiples of 128
    lanes: x's last axis padded with zero columns, the result cropped."""
    w_a = x.shape[-1]
    padded = np.zeros(x.shape[:-1] + (-(-w_a // 128) * 128,), np.uint8)
    padded[..., :w_a] = x
    import seaweedfs_tpu.ops.codec as ref_codec_mod
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WEED_CLAY_FUSED", "interpret")
        mp.delenv("WEED_EC_BACKEND", raising=False)
        mp.setattr(ref_codec_mod, "device_compute_ok", lambda: True)
        return np.asarray(call(jnp.asarray(padded)))[..., :w_a]


@functools.lru_cache(maxsize=1)   # the cases run in (k, m, w_a) order
def _case(k: int, m: int, w_a: int):
    """(data4 [k, 3, alpha, w_a], the plain version's parity, the Pallas
    interpreter's parity) from one numpy seed."""
    c = code(k, m)
    rng = np.random.default_rng(1000 * k + 10 * m + w_a)
    data4 = rng.integers(0, 256, (k, N_WIN, c.alpha, w_a), dtype=np.uint8)
    pallas = _pallas_padded(
        lambda x: ref_cs.encode_device_fused(k, m, x,
                                             small=c.alpha * x.shape[-1]),
        data4)
    return data4, _plain_parity(data4, k, m), pallas


GEOMETRIES = [(10, 4), (6, 3), (4, 2)]


@pytest.mark.parametrize("n_win", [1, N_WIN])
@pytest.mark.parametrize("w_a", [4096, 4099, 13, 1600])
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_thread_program_matches_plain_and_pallas(k, m, w_a, n_win):
    """w_a 4096: every thread on the two 16-byte loads; 4099 and 13: rows
    not 16-byte aligned, every thread on the guarded byte path (13: one
    partial tile, most warps of the block idle); 1600: aligned rows whose
    second tile mixes both paths within a warp."""
    data4, plain, pallas = _case(k, m, w_a)
    data4 = np.ascontiguousarray(data4[:, :n_win])
    got = emulate_encode(cs.r_bits_plane_major(k, m), data4, **_args(k, m))
    assert np.array_equal(plain, pallas)
    assert np.array_equal(got, plain[:, :n_win])
    assert np.array_equal(got, pallas[:, :n_win])


def test_transpose8_model_is_the_bit_transpose():
    """Plane word j of byte lane L holds bit j of byte L of each word q,
    at bit q; applying it twice gives the words back."""
    rng = np.random.default_rng(5)
    words = [rng.integers(0, 1 << 32, 64, dtype=np.uint32) for _ in range(8)]
    planes = transpose8(words)
    for j in range(8):
        for lb in range(4):
            want = sum((((words[q] >> (8 * lb + j)) & 1) << q)
                       for q in range(8))
            assert np.array_equal((planes[j] >> (8 * lb)) & 0xFF, want)
    assert all(np.array_equal(a, b)
               for a, b in zip(transpose8(planes), words))


@pytest.mark.parametrize("c", [GAMMA, int(code(10, 4)._det_inv), 0x8E, 1])
def test_plane_maps_multiply_by_the_constant(c):
    """The G / D maps in the plane domain equal the byte-wise GF(2^8)
    product of every byte by c."""
    rng = np.random.default_rng(c)
    words = [rng.integers(0, 1 << 32, 16, dtype=np.uint32) for _ in range(8)]
    cmap = np.array([ONES if (gf_mul_byte(c, 1 << j) >> b) & 1 else 0
                     for j in range(8) for b in range(8)], np.uint32)
    out = [np.zeros(16, np.uint32) for _ in range(8)]
    gf_const_planes(transpose8(words), cmap, out)
    got = np.stack(transpose8(out), -1).view(np.uint8)
    src = np.stack(words, -1).view(np.uint8)
    table = np.array([gf_mul_byte(c, v) for v in range(256)], np.uint8)
    assert np.array_equal(got, table[src])


# -- the repair ---------------------------------------------------------------

WARPS = 8            # kThreads / 32: a repair block's warps


def emulate_repair(rbits: np.ndarray, x4: np.ndarray, *, k: int, q: int,
                   t: int, lost: int, gamma: int,
                   inv_gamma: int) -> np.ndarray:
    """The lost shard's windows clay_repair_kernel<q> writes for x4 [k+q-1,
    n_win, beta, w_a], every thread of the launch modelled at once."""
    _, n_win, beta, w_a = x4.shape
    k0, n0, alpha, k_out = q * (t - 1), q * t, q ** t, 8 * q
    pw = [q ** y for y in range(t + 1)]
    flat = np.ascontiguousarray(x4).reshape(-1)
    out = np.zeros(n_win * alpha * w_a, np.uint8)
    lost_int = lost if lost < k else n0 - q + (lost - k)
    # prologue: internal node -> helper row, the shared masks, the gamma
    # and inv_gamma maps
    hidx = []
    for n in range(n0):
        ext = n if n < k else (k + n - (n0 - q) if n >= n0 - q else -1)
        hidx.append(-1 if ext < 0 or n == lost_int
                    else (ext if ext < lost else ext - 1))
    hidx = np.array(hidx)
    rb = np.ascontiguousarray(rbits).reshape(-1)
    s_ix = np.arange(k0 * 8 * k_out)
    o, cj = s_ix % k_out, s_ix // k_out
    masks = np.where(rb[o * (8 * k0) + (cj & 7) * k0 + (cj >> 3)] != 0,
                     ONES, np.uint32(0))
    maps = np.array([ONES if (gf_mul_byte(c, 1 << j) >> b) & 1 else 0
                     for c in (gamma, inv_gamma) for j in range(8)
                     for b in range(8)], np.uint32)
    gmap, imap = maps[:64], maps[64:]
    aligned = w_a % 16 == 0

    # the thread grid [block item group, warp, lane]: warp item = group *
    # WARPS + warp; the last group's warps past the items stay idle
    x0, y0 = lost_int % q, lost_int // q
    tiles = -(-w_a // TILE)
    items = n_win * beta * tiles
    it = (np.arange(-(-items // WARPS)).reshape(-1, 1, 1) * WARPS
          + np.arange(WARPS).reshape(1, -1, 1))
    lane = np.arange(32).reshape(1, 1, -1)
    shape = np.broadcast(it, lane).shape
    live = np.broadcast_to(it < items, shape)
    it = np.minimum(it, items - 1)   # idle warps: in-range rows, no stores
    tile = it % tiles
    rest = it // tiles
    r = rest % beta
    win = rest // beta
    z = (r // pw[y0]) * pw[y0 + 1] + x0 * pw[y0] + r % pw[y0]
    c0 = tile * TILE + 16 * lane
    vec = np.broadcast_to(aligned & (c0 + 528 <= w_a), shape)
    hstride = n_win * beta * w_a
    xw = win * beta * w_a
    zero = np.zeros(shape, np.uint32)

    acc = [zero.copy() for _ in range(k_out)]
    # known cell i: internal node i, or i + q from row y0 on (the kernel
    # issues cell i+1's loads before cell i's network; the model runs them
    # in program order)
    for i in range(k0):
        n = i if i < y0 * q else i + q
        y, x = divmod(n, q)
        py = pw[y if y < y0 else y - 1]   # digit y's stride in the rank
        zy = (r // py) % q
        hc = hidx[y * q + zy]
        if hidx[n] >= 0:
            u = transpose8(load_row(flat, xw + hidx[n] * hstride + r * w_a,
                                    c0, w_a, vec))
        else:                 # virtual nodes store zeros
            u = [zero.copy() for _ in range(8)]
        has = np.broadcast_to((zy != x) & (hc >= 0), shape)
        crow = np.where(has, xw + hc * hstride + (r + (x - zy) * py) * w_a, 0)
        cw = transpose8(load_row(flat, crow, c0, w_a, vec & has))
        gu = [a.copy() for a in u]
        gf_const_planes(cw, gmap, gu)
        u = [np.where(has, a, b) for a, b in zip(gu, u)]
        cell = has | (hidx[n] >= 0)   # U = 0 adds no term: the kernel
        for j in range(8):            # skips the cell
            for oo in range(k_out):
                m = masks[(i * 8 + j) * k_out + oo]
                acc[oo] = np.where(cell, acc[oo] ^ (u[j] & m), acc[oo])

    # row y0 of the lost node: x0 in the plane, C = U; x != x0 out of it,
    # C = IG(U ^ C[helper (x, y0)])
    for x in range(q):
        if x == x0:
            w = [acc[b * q + x] for b in range(8)]
        else:
            hn = hidx[y0 * q + x]
            v = (transpose8(load_row(flat, xw + hn * hstride + r * w_a, c0,
                                     w_a, vec))
                 if hn >= 0 else [zero.copy() for _ in range(8)])
            v = [v[b] ^ acc[b * q + x] for b in range(8)]
            w = [zero.copy() for _ in range(8)]
            gf_const_planes(v, imap, w)
        store_row(out, (win * alpha + z + (x - x0) * pw[y0]) * w_a, c0, w_a,
                  vec, live, transpose8(w))
    return out.reshape(n_win, alpha, w_a)


def _repair_args(k, m, lost):
    c = code(k, m)
    return dict(k=k, q=c.q, t=c.t, lost=lost, gamma=GAMMA,
                inv_gamma=cs.repair_parts(k, m, lost)[3])


@functools.lru_cache(maxsize=1)   # the cases run in (k, m, w_a) order
def _stripe(k: int, m: int, w_a: int, n_win: int) -> np.ndarray:
    """The encoded shards [k+m, n_win, alpha, w_a] of seeded data: the data
    and the plain version's parity (held to the Pallas interpreter's by the
    encode cases above)."""
    c = code(k, m)
    rng = np.random.default_rng(2000 * k + 10 * m + w_a)
    data4 = rng.integers(0, 256, (k, n_win, c.alpha, w_a), dtype=np.uint8)
    return np.concatenate([data4, _plain_parity(data4, k, m)])


def _repair_plain(k, m, lost, x4):
    """clay_fused_repair_plain of x4, a window and 1024 columns at a time."""
    rbits = torch.from_numpy(cs.repair_bits_plane_major(k, m, lost))
    n_win, w_a = x4.shape[1], x4.shape[3]
    out = np.empty((n_win, code(k, m).alpha, w_a), np.uint8)
    for wi in range(n_win):
        for c0 in range(0, w_a, TILE):
            part = np.ascontiguousarray(x4[:, wi:wi + 1, :, c0:c0 + TILE])
            out[wi:wi + 1, :, c0:c0 + TILE] = \
                clay_cuda.clay_fused_repair_plain(
                    rbits, torch.from_numpy(part),
                    **_repair_args(k, m, lost)).numpy()
    return out


REPAIR_CASES = (
    [(10, 4, 4096, 1, lost) for lost in range(14)]
    + [(6, 3, 4096, 1, lost) for lost in range(9)]
    + [(4, 2, 4096, 1, lost) for lost in range(6)]
    + [(10, 4, w_a, N_WIN, lost) for w_a in (4099, 13, 1600)
       for lost in (0, 8, 13)])


@pytest.mark.parametrize("k,m,w_a,n_win,lost", REPAIR_CASES)
def test_repair_thread_program_matches_plain_shard_and_pallas(k, m, w_a,
                                                              n_win, lost):
    """Every lost id at w_a 4096 (every thread on the 16-byte loads; lost 8
    and 9 of Clay(10,4) hold virtual nodes in their grid row); the ragged
    widths as in the encode cases, with a data, a virtual-row and a parity
    loss."""
    sh4 = _stripe(k, m, w_a, n_win)
    helpers, plane, _, _ = cs.repair_parts(k, m, lost)
    x4 = np.ascontiguousarray(sh4[list(helpers)][:, :, list(plane)])
    got = emulate_repair(cs.repair_bits_plane_major(k, m, lost), x4,
                         **_repair_args(k, m, lost))
    assert np.array_equal(got, sh4[lost])
    assert np.array_equal(got, _repair_plain(k, m, lost, x4))
    if (k, m) == (10, 4):
        pallas = _pallas_padded(
            lambda x: ref_cs.repair_device_fused(k, m, lost, x), x4)
        assert np.array_equal(got, pallas)
