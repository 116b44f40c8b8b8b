"""The port's host stages and spans (ops/codec.py `stage`, `job`, `span`)
on every EC path, at CPU sizes: each stage family counts one observation
per batch, window, dispatch or read of its path; each thread's stages fit
in the entry call's wall time; under torch.profiler the spans appear by
name inside an entry span of their own thread, which carries the entry's
identifier in its args, on the writer thread too; with the profiler off
no span is opened;
and the shard files and answers stay byte-identical to the JAX package's.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch
from torch.profiler import (ExecutionTraceObserver, ProfilerActivity,
                            _ExperimentalConfig, profile)

from seaweedfs_tpu.storage import ec as ref_ec
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu_torch.ops import codec as codec_mod
from seaweedfs_tpu_torch.storage import ec
from seaweedfs_tpu_torch.storage.ec.encoder import (_iter_encode_batches,
                                                    codec_for)

# one intra-op thread: the plain torch versions are small here, and a
# thread per core would crowd the other test workers on this host
torch.set_num_threads(1)

FAMILIES = tuple(codec_mod.STAGE_SPANS)
KINDS = {"rs": {}, "clay": {"code_kind": "clay"},
         "lrc": {"code_kind": "lrc", "lrc_locals": 2}}
LABEL = {"rs": "rs_torch", "clay": "clay", "lrc": "lrc"}
BATCH = 4096          # bytes per shard and batch: several per row
VID = 7
PRODUCER = ("ec_read", "codec_submit", "ec_queue_wait")
WRITER = ("ec_write", "codec_wait")


def geos(kind):
    """(port, JAX package) geometries: 16 KiB large and 1 KiB small
    blocks, so a volume of ~240 KB has a large row and small rows (the
    Clay windows hold alpha = 256 layers of 4 bytes)."""
    kw = dict(large_block_size=16 * 1024, small_block_size=1024,
              **KINDS[kind])
    return ec.EcGeometry(10, 4, **kw), ref_ec.EcGeometry(10, 4, **kw)


def observed():
    """{(family, backend, op): (count, sum)} of the stage families."""
    m = codec_mod.codec_metrics()
    out = {}
    for fam in FAMILIES:
        h = getattr(m, fam)
        for lb in list(h._totals):
            out[(fam, *lb)] = (h._totals[lb], h._sums[lb])
    return out


class Stages:
    """The stage observations added since construction, and the wall time
    of the calls made inside `timed`."""

    def __init__(self):
        self.before = observed()
        self.wall = 0.0

    def timed(self, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.wall += time.perf_counter() - t0
        return out

    def _delta(self, i):
        after = observed()
        return {k: v[i] - self.before.get(k, (0, 0.0))[i]
                for k, v in after.items()
                if v[0] != self.before.get(k, (0, 0.0))[0]}

    def counts(self):
        return self._delta(0)

    def seconds(self, families):
        return sum(s for (fam, _, _), s in self._delta(1).items()
                   if fam in families)


@pytest.fixture(scope="module")
def needle_volume(tmp_path_factory):
    """A needle volume written by the JAX package (one 160 KiB large row
    plus small rows) with two deletes: {id: (cookie, data)} of the live
    needles."""
    d = tmp_path_factory.mktemp("trace_vol")
    rng = np.random.default_rng(11)
    v = Volume(str(d), "", VID)
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
    return str(d), needles


def _copy(src_dir, dst_dir):
    shutil.copytree(src_dir, dst_dir)
    return os.path.join(dst_dir, str(VID))


def _same_files(base, ref_base, exts):
    for ext in exts:
        with open(base + ext, "rb") as f1, open(ref_base + ext, "rb") as f2:
            assert f1.read() == f2.read(), ext


def _batches(base, geo, batch=BATCH):
    size = os.path.getsize(base + ".dat")
    return sum(1 for _ in _iter_encode_batches(np.zeros(size, np.uint8),
                                               size, geo, batch))


def _shards(n=14):
    return [ec.to_ext(i) for i in range(n)]


# -- the families' counts ------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(KINDS))
def test_write_ec_files_stages(needle_volume, tmp_path, kind):
    """One read, submit, wait and write per batch; one queue wait per
    batch and one for the end of the stream; the producer's and the
    writer's stages each within the call; shards as the JAX package's."""
    src, _ = needle_volume
    geo, ref_geo = geos(kind)
    base = _copy(src, tmp_path / "port")
    ref_base = _copy(src, tmp_path / "ref")
    codec = codec_for(geo, device="cpu")
    st = Stages()
    st.timed(ec.write_ec_files, base, geo, codec, BATCH)
    ref_ec.write_ec_files(ref_base, ref_geo, batch_bytes=BATCH)
    b, lb = _batches(base, geo), LABEL[kind]
    assert b > 4
    assert st.counts() == {
        ("ec_read", lb, "encode"): b, ("codec_submit", lb, "encode"): b,
        ("codec_wait", lb, "encode"): b, ("ec_write", lb, "encode"): b,
        ("ec_queue_wait", lb, "encode"): b + 1}
    assert 0 < st.seconds(PRODUCER) <= st.wall
    assert 0 < st.seconds(WRITER) <= st.wall
    _same_files(base, ref_base, _shards())


@pytest.mark.parametrize("kind", ["rs", "clay"])
def test_encode_batch_stages(needle_volume, tmp_path, kind):
    """A fleet of three same-size volumes: one stage of each kind per
    grouped dispatch, the three volumes' gathers and their stack in one
    read."""
    src, _ = needle_volume
    geo, ref_geo = geos(kind)
    bases = [_copy(src, tmp_path / f"port{v}") for v in range(3)]
    ref_bases = [_copy(src, tmp_path / f"ref{v}") for v in range(3)]
    codec = codec_for(geo, device="cpu")
    st = Stages()
    st.timed(ec.encode_ec_files_batch, bases, geo, codec, BATCH)
    ref_ec.encode_ec_files_batch(ref_bases, ref_geo, batch_bytes=BATCH)
    # the group's per-volume batch width, as encode_ec_files_batch takes it
    vol_batch = max(1024, BATCH // 3 // 1024 * 1024)
    d, lb = _batches(bases[0], geo, vol_batch), LABEL[kind]
    assert st.counts() == {
        ("ec_read", lb, "encode"): d, ("codec_submit", lb, "encode"): d,
        ("codec_wait", lb, "encode"): d, ("ec_write", lb, "encode"): d,
        ("ec_queue_wait", lb, "encode"): d + 1}
    assert st.seconds(PRODUCER) <= st.wall
    assert st.seconds(WRITER) <= st.wall
    for base, ref_base in zip(bases, ref_bases):
        _same_files(base, ref_base, _shards())


@pytest.fixture()
def encoded(needle_volume, tmp_path, request):
    """The volume encoded by the port and, separately, by the JAX package,
    in the kind `request.param`: (kind, geo, port base, JAX base)."""
    kind = request.param
    src, _ = needle_volume
    geo, ref_geo = geos(kind)
    base = _copy(src, tmp_path / "port")
    ref_base = _copy(src, tmp_path / "ref")
    ec.encode_volume_to_ec(base, 3, geo, codec_for(geo, device="cpu"))
    ref_ec.encode_volume_to_ec(ref_base, 3, ref_geo)
    return kind, geo, base, ref_base


@pytest.mark.parametrize("encoded,lost", [
    ("rs", [2, 11]), ("clay", [3]), ("clay", [1, 12]), ("lrc", [3]),
    ("lrc", [1, 12])], indirect=["encoded"])
def test_rebuild_stages(encoded, lost):
    """Per window: RS one reconstruct dispatch (its lazily mapped slices
    read in the submit), a write and a queue wait (plus the end of the
    stream); Clay and LRC a read, a dispatch and a write, in sequence."""
    kind, geo, base, ref_base = encoded
    golden = {}
    for s in lost:
        with open(base + ec.to_ext(s), "rb") as f:
            golden[s] = f.read()
        for b in (base, ref_base):
            os.remove(b + ec.to_ext(s))
    codec = codec_for(geo, device="cpu")
    st = Stages()
    assert st.timed(ec.rebuild_ec_files, base, geo, codec, BATCH) == lost
    ref_ec.rebuild_ec_files(ref_base, batch_bytes=BATCH)
    # windows of BATCH bytes of each shard (Clay: BATCH // 1024 windows)
    w = -(-os.path.getsize(base + ec.to_ext(lost[0])) // BATCH)
    lb = LABEL[kind]
    if kind == "rs":
        want = {("codec_submit", lb, "reconstruct"): w,
                ("codec_wait", lb, "reconstruct"): w,
                ("ec_write", lb, "rebuild"): w,
                ("ec_queue_wait", lb, "rebuild"): w + 1}
        assert st.seconds(PRODUCER) <= st.wall
        assert st.seconds(WRITER) <= st.wall
    else:
        want = {("ec_read", lb, "rebuild"): w,
                ("codec_submit", lb, "reconstruct"): w,
                ("codec_wait", lb, "reconstruct"): w,
                ("ec_write", lb, "rebuild"): w}
        assert st.seconds(FAMILIES) <= st.wall
    assert w > 1
    assert st.counts() == want
    for s in lost:
        with open(base + ec.to_ext(s), "rb") as f:
            assert f.read() == golden[s], s
    _same_files(base, ref_base, _shards())


def _degraded_reads(vol, needles, lost, limit=None):
    """The needles with an interval on the lost shard (at most `limit`),
    and their intervals: [(id, intervals, degraded intervals)]."""
    out = []
    for nid in sorted(needles):
        ivs = vol.locate_ec_shard_needle(nid)[2]
        bad = sum(iv.to_shard_id_and_offset(vol.geo)[0] == lost
                  for iv in ivs)
        if bad:
            out.append((nid, len(ivs), bad))
    return out[:limit]


@pytest.mark.parametrize("encoded", ["rs", "clay", "lrc"],
                         indirect=True)
def test_degraded_read_stages(encoded, needle_volume):
    """Per read: one read stage per interval and one more per degraded
    interval (its survivors), one dispatch per degraded interval, one
    parse; the stages within the reads' time; answers as the JAX
    package's reads of its own encode."""
    kind, geo, base, ref_base = encoded
    _, needles = needle_volume
    lost = 3
    for b in (base, ref_base):
        os.remove(b + ec.to_ext(lost))
    vol = ec.EcVolume(os.path.dirname(base), "", VID, geo,
                      codec_for(geo, device="cpu"))
    ref = ref_ec.EcVolume(os.path.dirname(ref_base), "", VID)
    for s in range(14):
        if s != lost:
            vol.load_shard(s)
            ref.add_shard(s)
    reads = _degraded_reads(vol, needles, lost, limit=4)
    assert reads
    st = Stages()
    for nid, _, _ in reads:
        got = st.timed(vol.read_needle, nid)
        want = ref.read_needle(nid)
        assert (got.cookie, bytes(got.data)) == needles[nid] == \
            (want.cookie, bytes(want.data))
    vol.close()
    ref.close()
    lb = LABEL[kind]
    ivs = sum(r[1] for r in reads)
    bad = sum(r[2] for r in reads)
    assert st.counts() == {("ec_read", lb, "read"): ivs + bad,
                           ("codec_submit", lb, "reconstruct"): bad,
                           ("codec_wait", lb, "reconstruct"): bad,
                           ("needle_parse", lb, "read"): len(reads)}
    assert st.seconds(FAMILIES) <= st.wall


# -- spans under the profiler -----------------------------------------------

ENTRIES = {"ec.encode_volume", "ec.rebuild", "ec.read_needle"}
STAGE_NAMES = set(codec_mod.STAGE_SPANS.values()) | {"codec.build"}


def _profiled(fn, tmp_path):
    """Run fn under torch.profiler (CPU activity, every thread) with an
    execution trace: (the trace's entry and stage spans, the execution
    trace's nodes by id)."""
    et_path = str(tmp_path / "et.json")
    et = ExecutionTraceObserver().register_callback(et_path)
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     execution_trace_observer=et,
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            fn()
    finally:
        et.unregister_callback()
    trace = str(tmp_path / "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X"
                 and e.get("name") in ENTRIES | STAGE_NAMES]
    with open(et_path) as f:
        nodes = {n["id"]: n for n in json.load(f)["nodes"]}
    return spans, nodes


def _check_spans(spans, nodes, entry, ident, names, writer=()):
    """Every span of `names` appears, and each stage span lies in time
    inside an `entry` span of its own thread.  In the execution trace each
    entry span carries `ident` as its args and each stage span sits under
    one.  The `writer` spans are on a thread of their own, inside the
    entry span that the writer opens again there."""
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    assert names <= set(by_name), names - set(by_name)
    entries = by_name[entry]
    for e in spans:
        if e["name"] not in STAGE_NAMES:
            continue
        assert any(o["tid"] == e["tid"] and o["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= o["ts"] + o["dur"] + 1
                   for o in entries), e
    caller = min(entries, key=lambda e: e["ts"])["tid"]
    assert {e["name"] for e in spans if e["tid"] != caller} \
        == ({entry, *writer} if writer else set())
    entry_ids = {i for i, n in nodes.items() if n["name"] == entry}
    assert len(entry_ids) == len(entries)
    seen = set()
    for i, n in nodes.items():
        if i in entry_ids:
            assert n["inputs"]["values"] == [ident], n
        if n["name"] not in STAGE_NAMES:
            continue
        seen.add(n["name"])
        j = n["ctrl_deps"]
        while j in nodes and j not in entry_ids \
                and not nodes[j]["name"].startswith("[pytorch|"):
            j = nodes[j]["ctrl_deps"]
        assert j in entry_ids, n
    assert names - {entry} <= seen


def test_encode_spans(needle_volume, tmp_path):
    """The serving binding's encode: its job holds the codec's build, the
    producer's stages and, on the writer thread, the writes and waits."""
    from seaweedfs_tpu_torch import serving
    src, _ = needle_volume
    geo, _ = geos("rs")
    base = _copy(src, tmp_path / "port")
    bound = serving.bind("cpu")
    spans, nodes = _profiled(
        lambda: bound.encode_volume_to_ec(base, 3, geo), tmp_path)
    _check_spans(spans, nodes, "ec.encode_volume", str(VID),
                 {"ec.encode_volume", "codec.build", "ec.read",
                  "codec.submit", "ec.queue_wait", "ec.write",
                  "codec.wait"}, writer=("ec.write", "codec.wait"))
    # one entry span on the caller's thread, one on the writer's
    assert sum(e["name"] == "ec.encode_volume" for e in spans) == 2


@pytest.mark.parametrize("encoded", ["clay"], indirect=True)
def test_rebuild_spans(encoded, tmp_path):
    kind, geo, base, _ = encoded
    from seaweedfs_tpu_torch import serving
    os.remove(base + ec.to_ext(5))
    bound = serving.bind("cpu")
    spans, nodes = _profiled(lambda: bound.rebuild_ec_files(base),
                             tmp_path)
    _check_spans(spans, nodes, "ec.rebuild", str(VID),
                 {"ec.rebuild", "codec.build", "ec.read", "codec.submit",
                  "codec.wait", "ec.write"})


@pytest.mark.parametrize("encoded", ["rs", "clay"], indirect=True)
def test_read_spans(encoded, needle_volume, tmp_path):
    kind, geo, base, _ = encoded
    _, needles = needle_volume
    os.remove(base + ec.to_ext(3))
    vol = ec.EcVolume(os.path.dirname(base), "", VID, geo,
                      codec_for(geo, device="cpu"))
    for s in range(14):
        if s != 3:
            vol.load_shard(s)
    nid = _degraded_reads(vol, needles, 3, limit=1)[0][0]
    spans, nodes = _profiled(lambda: vol.read_needle(nid), tmp_path)
    vol.close()
    _check_spans(spans, nodes, "ec.read_needle", f"{VID}:{nid:x}",
                 {"ec.read_needle", "ec.read", "codec.submit",
                  "codec.wait", "needle.parse"})


# -- the profiler off ---------------------------------------------------------

def test_no_span_with_the_profiler_off(needle_volume, tmp_path,
                                       monkeypatch):
    """With no profiler recording, the paths open no record_function: the
    stages only observe their families."""
    def refuse(*_a, **_kw):
        raise AssertionError("record_function entered with the profiler "
                             "off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(codec_mod, "_RecordFunctionFast", refuse)
    assert not codec_mod.profiling()
    src, needles = needle_volume
    for kind in ("rs", "lrc"):
        geo, _ = geos(kind)
        base = _copy(src, tmp_path / kind)
        st = Stages()
        ec.encode_volume_to_ec(base, 3, geo, codec_for(geo, device="cpu"))
        os.remove(base + ec.to_ext(3))
        ec.rebuild_ec_files(base, geo, codec_for(geo, device="cpu"), BATCH)
        os.remove(base + ec.to_ext(3))
        vol = ec.EcVolume(os.path.dirname(base), "", VID, geo,
                          codec_for(geo, device="cpu"))
        for s in range(14):
            if s != 3:
                vol.load_shard(s)
        for nid, _, _ in _degraded_reads(vol, needles, 3, limit=2):
            assert bytes(vol.read_needle(nid).data) == needles[nid][1]
        vol.close()
        assert {fam for fam, _, _ in st.counts()} == set(FAMILIES)


# -- the helper ----------------------------------------------------------------

def test_nested_stage_observes_its_own_time():
    """A stage inside another on the same thread: the outer one observes
    its wall time less the inner one's."""
    m = codec_mod.codec_metrics()
    lb = ("test_backend", "nested")
    with codec_mod.stage("ec_write", *lb):
        time.sleep(0.02)
        with codec_mod.stage("codec_wait", *lb):
            time.sleep(0.05)
    outer, inner = m.ec_write._sums[lb], m.codec_wait._sums[lb]
    assert m.ec_write._totals[lb] == m.codec_wait._totals[lb] == 1
    assert inner >= 0.05 and 0.02 <= outer < 0.05


def test_job_inside_a_job_keeps_the_outer_one():
    assert codec_mod.current_job() is None
    with codec_mod.job("ec.rebuild", "a"):
        with codec_mod.job("ec.rebuild", "b"):
            assert codec_mod.current_job() == ("ec.rebuild", "a")
        assert codec_mod.current_job() == ("ec.rebuild", "a")
    assert codec_mod.current_job() is None


def test_gf_apply_observes_only_when_labelled():
    M = np.eye(3, dtype=np.uint8)
    x = np.arange(30, dtype=np.uint8).reshape(3, 10)
    before = observed()
    codec_mod.gf_apply(M, x, device="cpu")
    assert observed() == before
    assert np.array_equal(codec_mod.gf_apply(
        M, x, device="cpu", metered=("test_backend", "apply")), x)
    delta = {k: v[0] - before.get(k, (0, 0.0))[0]
             for k, v in observed().items() if k[1] == "test_backend"
             and k[2] == "apply"}
    assert delta == {("codec_submit", "test_backend", "apply"): 1,
                     ("codec_wait", "test_backend", "apply"): 1}
