"""Open loop of single-loss `ec.rebuild` jobs (VolumeEcShardsRebuild) on
one seeded volume, encoded by the program in set-up.

Traffic parameters: `volume_mb`, `interval_s` (one job due every
interval), `lost_order` (the shard each job loses, cycled in this fixed
order whatever the seed).

Before a job's due time its lost shard is deleted; the job is timed from
its due time to the return of rebuild_ec_files.  Then, untimed, the
restored shard is recorded as a digest for the check after the window and
removed, and the shard as encoded is linked back (a hard link: no bytes
written), so every job repairs from the same helpers.
"""

from __future__ import annotations

import os

import numpy as np

from ecbench import harness, volume
from ecbench.reference import codes, layout


def prepare(run) -> None:
    c, t = run.config, run.traffic
    vol = volume.make_volume(os.path.join(run.work, "1"),
                             int(t["volume_mb"] * 2**20), run.seed % 2**64,
                             c["needle_bytes_min"], c["needle_bytes_max"])
    run.system.encode(vol.base)
    n = c["data_shards"] + c["parity_shards"]
    encoded = os.path.join(run.work, "encoded")
    os.makedirs(encoded)
    for s in range(n):
        os.link(f"{vol.base}.ec{s:02d}", os.path.join(encoded, f"{s:02d}"))
    run.state.update(volume=vol, encoded=encoded,
                     shard=os.path.getsize(vol.base + ".ec00"))
    # warm-up: every lost shard of the order once on a one-row volume (the
    # codec's tables for each loss), then one job on the cell's volume
    warm = volume.make_volume(os.path.join(run.work, "2"),
                              c["data_shards"] * c["small_block_size"],
                              run.seed % 2**64, c["needle_bytes_min"],
                              c["needle_bytes_max"])
    run.system.encode(warm.base)
    for lost in t["lost_order"]:
        os.remove(f"{warm.base}.ec{lost:02d}")
        run.system.rebuild(warm.base)
    for name in os.listdir(run.work):
        if name.startswith("2."):
            os.remove(os.path.join(run.work, name))
    lost = t["lost_order"][-1]
    os.remove(f"{vol.base}.ec{lost:02d}")
    run.system.rebuild(vol.base)
    os.remove(f"{vol.base}.ec{lost:02d}")
    os.link(os.path.join(encoded, f"{lost:02d}"),
            f"{vol.base}.ec{lost:02d}")


def expected_read(run, lost: int) -> int:
    """Bytes the code's rebuild of shard `lost` alone reads."""
    return codes.of(run.config).single_loss_read_bytes(
        run.config, lost, run.state["shard"])


def run(run) -> None:
    vol, order = run.state["volume"], run.traffic["lost_order"]
    shard = run.state["shard"]

    def path(i):
        return f"{vol.base}.ec{order[i % len(order)]:02d}"

    def before(i):
        os.remove(path(i))

    def job(i):
        stats = run.system.rebuild(vol.base)
        # the codec's least traffic: what the repair must read, and the
        # lost shard written once
        lost = order[i % len(order)]
        return {"lost": lost, "bytes": shard,
                "bytes_read": stats.get("bytes_read"),
                "codec_io_bytes": expected_read(run, lost) + shard}

    def after(i, rec):
        rec["digest"] = harness.file_digest(path(i))
        os.remove(path(i))
        os.link(os.path.join(run.state["encoded"], f"{rec['lost']:02d}"),
                path(i))

    harness.open_loop(run, float(run.traffic["interval_s"]), job, before,
                      after)


def close(run) -> None:
    pass


def verify(run) -> dict:
    """Each restored shard against the reference's, byte for byte, and
    each rebuild's read count against the code's."""
    c = run.config
    k, m = c["data_shards"], c["parity_shards"]
    vol = run.state["volume"]
    dat = np.fromfile(vol.base + ".dat", dtype=np.uint8)
    data = layout.data_shards(dat, k, c["small_block_size"],
                              c["large_block_size"])
    parity = None
    if any(r["lost"] >= k for r in run.records):
        parity = codes.of(c).parity_shards(c, data)
    differing = read_off = 0
    want = {}
    for rec in run.records:
        lost = rec["lost"]
        if lost not in want:
            want[lost] = harness.digest(data[lost] if lost < k
                                        else parity[lost - k])
        differing += rec["digest"] != want[lost]
        got, want_read = rec["bytes_read"], expected_read(run, lost)
        read_off += abs(got - want_read) if got is not None else want_read
    run.log(f"compared {len(run.records)} restored shards and their read "
            f"counts with the reference")
    return {"shards_differing": (differing, 0),
            "read_bytes_off_plan": (read_off, 0)}
