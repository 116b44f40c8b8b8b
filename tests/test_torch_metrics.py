"""The port's codec metrics against the JAX package's: the same operations
through both packages give the same families, label keys, byte counts,
dispatch counts and volume counts (the backend label names each package's
executor: `rs_torch` here for `rs_numpy` there), and the port's renderer
writes the JAX package's exposition text byte for byte.  Mirrors
tests/test_tracing_metrics.py's codec cases and the fleet-encode and
dispatch-counter cases of tests/test_clay_fused.py, at CPU sizes.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_tpu import stats as ref_stats
from seaweedfs_tpu.ops import codec as ref_codec_mod
from seaweedfs_tpu.storage import ec as ref_ec
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ops import clay_matrix, codec as codec_mod
from seaweedfs_tpu_torch.ops.codec import RSCodec
from seaweedfs_tpu_torch.storage import ec

# one intra-op thread: the plain torch versions are small here, and a
# thread per core would crowd the other test workers on this host
torch.set_num_threads(1)

FAMILIES = ("seaweedfs_codec_op_seconds", "seaweedfs_codec_bytes_total",
            "seaweedfs_codec_dispatch_total",
            "seaweedfs_codec_dispatch_volumes_total")
# the port's host-stage histograms, after the families both packages have
STAGE_FAMILIES = ("seaweedfs_ec_read_seconds", "seaweedfs_ec_write_seconds",
                  "seaweedfs_ec_queue_wait_seconds",
                  "seaweedfs_codec_submit_seconds",
                  "seaweedfs_codec_wait_seconds",
                  "seaweedfs_needle_parse_seconds",
                  "seaweedfs_ec_plan_seconds")
# the port's count of dispatch input bytes by how they reached the upload
STAGED_FAMILY = "seaweedfs_codec_staged_bytes_total"


class Delta:
    """(bytes, observations, dispatches, volumes) added under one label of
    one package's codec metrics since construction."""

    def __init__(self, mod, backend, op):
        self.m, self.label = mod.codec_metrics(), (backend, op)
        self.start = self.now()

    def now(self):
        m, lb = self.m, self.label
        return (m.bytes.value(*lb), m.seconds._totals.get(lb, 0),
                m.dispatch.value(*lb), m.dispatch_volumes.value(*lb))

    def __call__(self):
        return tuple(b - a for a, b in zip(self.start, self.now()))


# -- the renderer ------------------------------------------------------------

def _fill(mod):
    r = mod.Registry()
    c = r.counter("x_requests_total", "requests", ["op", "path"])
    c.inc("get", 'a"b\\c\nd')
    c.inc("put", "/", value=2.5)
    r.counter("x_plain_total", "no labels").inc(value=3.0)
    h = r.histogram("x_seconds", "latency", ["op"],
                    buckets=[0.01, 0.1, 1.0])
    for v, tid in ((0.005, "t1"), (0.05, ""), (0.5, "t3"), (7.0, "t4")):
        h.observe("get", value=v, trace_id=tid)
    h.observe("put", value=0.2)
    r.histogram("x_default_buckets", "default buckets").observe(value=0.3)
    return r


@pytest.mark.parametrize("exemplars", [False, True])
def test_render_equals_reference_text(exemplars):
    assert _fill(stats).render(exemplars=exemplars) == \
        _fill(ref_stats).render(exemplars=exemplars)


def test_codec_registry_families_and_label_keys():
    RSCodec(4, 2, device="cpu").encode(np.zeros((4, 64), np.uint8))
    text = codec_mod.codec_metrics().registry.render()
    for fam in FAMILIES + STAGE_FAMILIES + (STAGED_FAMILY,):
        kind = "histogram" if fam.endswith("_seconds") else "counter"
        assert f"# TYPE {fam} {kind}" in text
    samples = [ln for ln in text.splitlines() if not ln.startswith("#")]
    assert samples
    for ln in samples:
        keys = re.findall(r'(\w+)="', ln)
        want = [["backend", "op", "path"]] if ln.startswith(STAGED_FAMILY) \
            else [["backend", "op"], ["backend", "op", "le"]]
        assert keys in want, ln
    # the JAX package's four families first, in its order, then exactly
    # the seven stage histograms, in this order, then the staged bytes
    ref_text = ref_codec_mod.codec_metrics().registry.render()
    types = re.findall(r"# TYPE (\S+ \S+)", text)
    ref_types = re.findall(r"# TYPE (\S+ \S+)", ref_text)
    assert len(ref_types) == len(FAMILIES)
    assert types[:len(ref_types)] == ref_types
    assert types[len(ref_types):] == [f"{fam} histogram"
                                      for fam in STAGE_FAMILIES] + [
        f"{STAGED_FAMILY} counter"]


# -- codec calls ---------------------------------------------------------------

def test_codec_metrics_record_encode_and_reconstruct():
    data = np.random.default_rng(1).integers(0, 256, (4, 512),
                                             dtype=np.uint8)
    got = {}
    for mod, codec, backend in (
            (codec_mod, RSCodec(4, 2, device="cpu"), "rs_torch"),
            (ref_codec_mod, ref_codec_mod.RSCodec(4, 2, backend="numpy"),
             "rs_numpy")):
        enc, rec = Delta(mod, backend, "encode"), \
            Delta(mod, backend, "reconstruct")
        parity = codec.encode(data)
        out = codec.reconstruct([data[i] for i in range(4)]
                                + [parity[0], None])
        assert np.array_equal(out[5], parity[1])
        got[backend] = (enc(), rec())
    assert got["rs_torch"] == got["rs_numpy"] == (
        (data.nbytes, 1, 1.0, 1.0), (data.nbytes, 1, 1.0, 1.0))
    text = codec_mod.codec_metrics().registry.render()
    assert 'seaweedfs_codec_bytes_total{backend="rs_torch",op="encode"}' \
        in text


def test_lrc_window_codec_metered():
    data = np.random.default_rng(2).integers(0, 256, (4, 256),
                                             dtype=np.uint8)
    geo = ec.EcGeometry(data_shards=4, parity_shards=4, code_kind="lrc",
                        lrc_locals=2)
    ref_geo = ref_ec.EcGeometry(data_shards=4, parity_shards=4,
                                code_kind="lrc", lrc_locals=2)
    from seaweedfs_tpu.storage.ec.codes import LrcWindowCodec as RefLrc
    d, rd = Delta(codec_mod, "lrc", "encode"), \
        Delta(ref_codec_mod, "lrc", "encode")
    got = ec.LrcWindowCodec(geo, device="cpu").encode(data)
    assert np.array_equal(got, RefLrc(ref_geo).encode(data))
    assert d() == rd() == (data.nbytes, 1, 1.0, 1.0)


def test_dispatch_counters_unit():
    d = Delta(codec_mod, "rs_torch", "encode")
    codec_mod.metered_fetch(lambda: None, "rs_torch", "encode", 128, 0.0,
                            volumes=7)()
    assert d() == (128.0, 1, 1.0, 7.0)


# -- fleet encodes: the batching factor ---------------------------------------

def _raw_fleet(root, sizes, seed):
    rng = np.random.default_rng(seed)
    bases = []
    for v, size in enumerate(sizes):
        d = root / f"v{v}"
        d.mkdir(parents=True)
        with open(d / "1.dat", "wb") as f:
            f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        bases.append(str(d / "1"))
    return bases


def _twin_fleets(tmp_path, sizes, seed):
    port = _raw_fleet(tmp_path / "port", sizes, seed)
    ref = _raw_fleet(tmp_path / "ref", sizes, seed)
    return port, ref


def _same_shards(bases, ref_bases, n):
    for b, rb in zip(bases, ref_bases):
        for i in range(n):
            with open(b + ec.to_ext(i), "rb") as f1, \
                    open(rb + ec.to_ext(i), "rb") as f2:
                assert f1.read() == f2.read(), (b, i)


def test_encode_batch_amortization_rs(tmp_path):
    """A 40-volume RS fleet encodes in fewer dispatches than volumes, with
    the same dispatch and volume counts as the JAX package's, and the same
    shards."""
    n_vol = 40
    geo = ec.EcGeometry(10, 4, large_block_size=1 << 20,
                        small_block_size=4096)
    ref_geo = ref_ec.EcGeometry(10, 4, large_block_size=1 << 20,
                                small_block_size=4096)
    bases, ref_bases = _twin_fleets(tmp_path, [3 * geo.small_row_size()]
                                    * n_vol, 21)
    d = Delta(codec_mod, "rs_torch", "encode")
    ec.encode_ec_files_batch(bases, geo, RSCodec(10, 4, device="cpu"),
                             batch_bytes=1 << 20)
    rd = Delta(ref_codec_mod, "rs_numpy", "encode")
    ref_ec.encode_ec_files_batch(ref_bases, ref_geo,
                                 ref_codec_mod.RSCodec(10, 4,
                                                       backend="numpy"),
                                 batch_bytes=1 << 20)
    got = d()
    assert got == rd()
    _, _, dispatches, volumes = got
    assert 0 < dispatches < n_vol
    assert volumes == n_vol and volumes / dispatches > 10
    _same_shards(bases, ref_bases, 14)


def test_encode_batch_clay_window_codec(tmp_path):
    """Clay volumes fold onto the byte axis: the grouped encode's 'clay'
    dispatch and volume counts equal the JAX package's, and so do the
    shards."""
    alpha = clay_matrix.code(4, 2).alpha
    geo = ec.EcGeometry(4, 2, large_block_size=1 << 20,
                        small_block_size=alpha * 128, code_kind="clay")
    ref_geo = ref_ec.EcGeometry(4, 2, large_block_size=1 << 20,
                                small_block_size=alpha * 128,
                                code_kind="clay")
    sizes = [2 * geo.small_row_size() + v for v in range(6)]
    bases, ref_bases = _twin_fleets(tmp_path, sizes, 31)
    d = Delta(codec_mod, "clay", "encode")
    ec.encode_ec_files_batch(bases, geo,
                             ec.ClayWindowCodec(geo, device="cpu"),
                             batch_bytes=1 << 20)
    rd = Delta(ref_codec_mod, "clay", "encode")
    ref_ec.encode_ec_files_batch(ref_bases, ref_geo, batch_bytes=1 << 20)
    got = d()
    assert got == rd()
    assert 0 < got[2] < len(bases) and got[3] >= len(bases)
    _same_shards(bases, ref_bases, 6)


def test_encode_batch_odd_sizes_degrade(tmp_path):
    """Distinct shard sizes take the per-volume writer: one dispatch per
    volume, as in the JAX package, and the same shards."""
    geo = ec.EcGeometry(10, 4, large_block_size=1 << 20,
                        small_block_size=4096)
    ref_geo = ref_ec.EcGeometry(10, 4, large_block_size=1 << 20,
                                small_block_size=4096)
    sizes = [r * geo.small_row_size() for r in (1, 3)]
    bases, ref_bases = _twin_fleets(tmp_path, sizes, 5)
    d = Delta(codec_mod, "rs_torch", "encode")
    ec.encode_ec_files_batch(bases, geo, RSCodec(10, 4, device="cpu"),
                             batch_bytes=1 << 20)
    rd = Delta(ref_codec_mod, "rs_numpy", "encode")
    ref_ec.encode_ec_files_batch(ref_bases, ref_geo,
                                 ref_codec_mod.RSCodec(10, 4,
                                                       backend="numpy"),
                                 batch_bytes=1 << 20)
    assert d() == rd() and d()[2:] == (2.0, 2.0)
    _same_shards(bases, ref_bases, 14)


# -- the rebuilds' observe points --------------------------------------------

@pytest.mark.parametrize("kind,lost", [("clay", [3]), ("clay", [1, 12]),
                                       ("lrc", [3]), ("lrc", [1, 12])])
def test_rebuild_observes_bytes_read(tmp_path, kind, lost):
    """One 'reconstruct' observation per clay or LRC rebuild, carrying the
    bytes the rebuild read, as the JAX package records it."""
    small = clay_matrix.code(10, 4).alpha * 128
    kw = dict(large_block_size=1 << 20, small_block_size=small,
              code_kind=kind, lrc_locals=2 if kind == "lrc" else 0)
    geo, ref_geo = ec.EcGeometry(10, 4, **kw), ref_ec.EcGeometry(10, 4, **kw)
    (base,), (ref_base,) = _twin_fleets(tmp_path, [geo.small_row_size()
                                                   + 99], 8)
    ec.write_ec_files(base, geo, ec.codes.window_codec_for(geo,
                                                           device="cpu"))
    for b in (base, ref_base):
        ec.save_volume_info(b, 3, dat_size=geo.small_row_size() + 99,
                            data_shards=10, parity_shards=4, **kw)
    for s in range(14):
        shutil.copy(base + ec.to_ext(s), ref_base + ec.to_ext(s))
    for b in (base, ref_base):
        for s in lost:
            os.remove(b + ec.to_ext(s))
    d = Delta(codec_mod, kind, "reconstruct")
    st = {}
    ec.rebuild_ec_files(base, codec=ec.codes.window_codec_for(geo,
                                                              device="cpu"),
                        stats=st)
    rd = Delta(ref_codec_mod, kind, "reconstruct")
    ref_st = {}
    ref_ec.rebuild_ec_files(ref_base, stats=ref_st)
    assert d()[0] == rd()[0] == st["bytes_read"] == ref_st["bytes_read"]
    assert d()[1:] == rd()[1:] == (1, 1.0, 1.0)
    _same_shards([base], [ref_base], 14)


# -- the chip script's count of encode dispatches -----------------------------

@pytest.mark.parametrize("rows,extra", [(0, 1), (0, 10 * 1024), (1, 0),
                                        (1, 777), (2, 3 * 10 * 1024 + 5)])
@pytest.mark.parametrize("batch", [1024, 4096, 8192])
def test_chip_smoke_encode_dispatches_equal_encoder_batches(rows, extra,
                                                            batch):
    """chip_smoke.encode_dispatches, the dispatch count its serving phase
    holds the metrics to, equals the batches write_ec_files encodes."""
    import chip_smoke
    from seaweedfs_tpu_torch.storage.ec.encoder import _iter_encode_batches
    geo = ec.EcGeometry(10, 4, large_block_size=16 * 1024,
                        small_block_size=1024)
    size = rows * geo.large_row_size() + extra
    n = sum(1 for _ in _iter_encode_batches(np.zeros(size, np.uint8), size,
                                            geo, batch))
    assert chip_smoke.encode_dispatches(size, geo, batch) == n
