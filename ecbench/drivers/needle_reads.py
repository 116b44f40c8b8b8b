"""Closed loop of needle reads through an EC volume with lost shards (the
store's EcVolume.read_needle), one client.

Traffic parameters: `volume_mb`, `lost` (shard ids deleted after the
encode), `zipf_s` (the reads' Zipf exponent over the needles that touch a
lost shard; 0.99 is YCSB's zipfian constant).

The seed orders the popularity ranks and draws the reads, BLOCK at a time
as the window goes.  Popularity rank r takes the needle at a fixed
quantile of the sizes of the needles that touch a lost shard (see
`popularity`): each seed reads other needles at other offsets, with the same profile of
sizes by rank, so a window's percentiles do not hang on whether a seed's
few hottest needles happen to be large.  Each read is timed from its call
to its return; every answer is kept as a digest, after its timing, and
compared with the .dat once the window has closed.
"""

from __future__ import annotations

import hashlib
import os
import struct
import time

import numpy as np

from ecbench import volume
from ecbench.reference import codes, layout, needle

# the quantile of the sizes each popularity rank takes, a fixed stream
RANK_STREAM = 0x0DDBA11
BLOCK = 256          # reads drawn at a time
WARMUP_READS = 32    # reads of the most popular needles in set-up


def prepare(run) -> None:
    c, t = run.config, run.traffic
    n = c["data_shards"] + c["parity_shards"]
    vol = volume.make_volume(os.path.join(run.work, "1"),
                             int(t["volume_mb"] * 2**20), run.seed % 2**64,
                             c["needle_bytes_min"], c["needle_bytes_max"])
    run.system.encode(vol.base)
    lost = set(t["lost"])
    for s in lost:
        os.remove(f"{vol.base}.ec{s:02d}")
    rng = np.random.default_rng(run.seed % 2**64)
    ranked, io = popularity(vol, lost, c, rng)
    cdf = np.cumsum(np.arange(1, len(ranked) + 1, dtype=np.float64)
                    ** -float(t["zipf_s"]))
    reader = run.system.open_volume(
        run.work, 1, [s for s in range(n) if s not in lost])
    run.state.update(volume=vol, ranked=ranked, io=io, cdf=cdf / cdf[-1],
                     rng=rng, reader=reader, answers=[])
    for idx in ranked[:WARMUP_READS].tolist():
        nid = int(vol.ids[idx])
        try:
            run.system.read(reader, nid)
        except Exception as e:   # the window's path failing in set-up
            run.fail(f"warm-up read of needle {nid:x}", e)


def popularity(vol, lost: set, config: dict, rng: np.random.Generator
               ) -> tuple[np.ndarray, dict]:
    """The needles that touch a lost shard, most popular first, and the
    codec's least traffic of each one's read (the code kind's
    degraded_io_bytes of every lost interval).  Rank r takes the needle
    whose size is at quantile u_r among them, u from RANK_STREAM; the seed
    breaks ties."""
    k, small = config["data_shards"], config["small_block_size"]
    code = codes.of(config)
    pop, io = [], {}
    for i, (off, size) in enumerate(zip(vol.offsets.tolist(),
                                        vol.data_sizes.tolist())):
        ivs = [(s, ln) for s, _, ln in layout.locate(
            off, needle.record_size(size), k, small) if s in lost]
        if ivs:
            pop.append(i)
            io[i] = sum(code.degraded_io_bytes(config, s, ln)
                        for s, ln in ivs)
    if not pop:
        raise RuntimeError("no needle touches the lost shards")
    pop = np.array(pop)
    by_size = pop[np.lexsort((rng.random(len(pop)), vol.data_sizes[pop]))]
    u = np.random.default_rng(RANK_STREAM).random(len(pop))
    return by_size[np.argsort(np.argsort(u))], io


def run(run) -> None:
    st = run.state
    vol, ranked, io, cdf, rng = (st["volume"], st["ranked"], st["io"],
                                 st["cdf"], st["rng"])
    reader, answers = st["reader"], st["answers"]
    draws, j = [], 0
    end = time.perf_counter() + run.seconds
    while time.perf_counter() < end:
        if j == len(draws):
            draws = np.minimum(np.searchsorted(cdf, rng.random(BLOCK),
                                               side="right"),
                               len(ranked) - 1).tolist()
            j = 0
        idx = int(ranked[draws[j]])
        j += 1
        nid = int(vol.ids[idx])
        run.attempted += 1
        t0 = time.perf_counter()
        try:
            with run.span("ecbench.op"):
                data = run.system.read(reader, nid)
        except Exception as e:   # a read that raises is a failed answer
            run.fail(f"read of needle {nid:x}", e)
            continue
        t1 = time.perf_counter()
        run.records.append({"latency_s": t1 - t0, "needle": idx,
                            "codec_io_bytes": io[idx]})
        # every answer, as a digest: holding payloads would change the
        # program's allocations during the window
        answers.append((idx, answer_digest(*data)))
    lat = np.array([r["latency_s"] for r in run.records]) * 1e3
    if len(lat) >= 4:
        q = np.percentile(lat, [10, 25, 50, 75, 90, 99])
        run.log("read ms p10 p25 p50 p75 p90 p99: "
                + " ".join(f"{v:.4f}" for v in q) + "; p50 of each quarter"
                " of the window: " + " ".join(
                    f"{np.median(part):.4f}"
                    for part in np.array_split(lat, 4)))
    run.log(f"{len(run.records)} reads of "
            f"{len({r['needle'] for r in run.records})} distinct needles")


def close(run) -> None:
    run.system.close_volume(run.state.pop("reader"))


def verify(run) -> dict:
    """Every answer against its needle's record in the .dat."""
    vol = run.state["volume"]
    dat = np.memmap(vol.base + ".dat", dtype=np.uint8, mode="r")
    want: dict = {}
    differing = 0
    for idx, got in run.state["answers"]:
        if idx not in want:
            off = int(vol.offsets[idx])
            rec = dat[off:off + needle.record_size(int(vol.data_sizes[idx]))]
            want[idx] = answer_digest(*needle.data_of(rec.tobytes()))
        differing += got != want[idx]
    del dat
    run.log(f"compared {len(run.state['answers'])} answers with the .dat")
    return {"answers_differing": (differing, 0)}


def answer_digest(cookie: int, nid: int, data: bytes) -> bytes:
    """A read's answer, the needle's cookie, id and payload, as a
    BLAKE2b digest."""
    h = hashlib.blake2b(digest_size=32)
    h.update(struct.pack(">IQ", cookie, nid))
    h.update(data)
    return h.digest()
