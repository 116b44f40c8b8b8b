"""Open loop of `ec.encode` jobs (VolumeEcShardsGenerate) on a pool of
seeded volumes used in turn.

Traffic parameters: `volume_mb` (each volume's .dat), `volumes` (the pool),
`interval_s` (one job due every interval).  A fixed interval keeps the
bytes a run writes fixed: shard files are 1.4x the .dat, and a closed loop
would write more the faster the program got.

Each job is timed from its due time to the return of
encode_volume_to_ec, when the shards, .ecx and .vif are closed.  Between
jobs, untimed, its shard files and .ecx are recorded as digests and
removed, as ec.encode removes them after spreading them; the digests are
compared with the reference's once the window has closed.  Removing them
keeps the run's dirty pages, and so the host's writeback, the same from
job to job.
"""

from __future__ import annotations

import os

import numpy as np

from ecbench import harness, volume
from ecbench.reference import codes, layout, needle


def _outputs(run) -> list[str]:
    n = run.config["data_shards"] + run.config["parity_shards"]
    return [f".ec{i:02d}" for i in range(n)] + [".ecx", ".vif"]


def prepare(run) -> None:
    c, t = run.config, run.traffic
    vols = [volume.make_volume(os.path.join(run.work, str(v + 1)),
                               int(t["volume_mb"] * 2**20),
                               [run.seed % 2**64, v],
                               c["needle_bytes_min"], c["needle_bytes_max"])
            for v in range(t["volumes"])]
    run.state["volumes"] = vols
    # warm-up: one whole job of the cell's own kind, its outputs dropped
    run.system.encode(vols[0].base)
    for ext in _outputs(run):
        os.remove(vols[0].base + ext)


def run(run) -> None:
    vols = run.state["volumes"]
    c = run.config
    n = c["data_shards"] + c["parity_shards"]

    def job(i):
        v = vols[i % len(vols)]
        run.system.encode(v.base)
        shard = layout.shard_size(v.dat_size, c["data_shards"],
                                  c["small_block_size"],
                                  c["large_block_size"])
        # the codec's least traffic: the data read once, the parity
        # written once (data shards: k * shard, parity: m * shard)
        return {"volume": i % len(vols), "bytes": v.dat_size,
                "codec_io_bytes": n * shard}

    def after(i, rec):
        base = vols[rec["volume"]].base
        rec["digests"] = [harness.file_digest(base + ext)
                          for ext in _outputs(run)[:-1]]
        for ext in _outputs(run):
            if os.path.exists(base + ext):
                os.remove(base + ext)

    harness.open_loop(run, float(run.traffic["interval_s"]), job,
                      after=after)


def close(run) -> None:
    pass


def verify(run) -> dict:
    """Every job's shard files and .ecx against the reference's."""
    c = run.config
    k, m = c["data_shards"], c["parity_shards"]
    shards = ecx = 0
    refs = {}
    for rec in run.records:
        v = run.state["volumes"][rec["volume"]]
        if rec["volume"] not in refs:
            dat = np.fromfile(v.base + ".dat", dtype=np.uint8)
            data = layout.data_shards(dat, k, c["small_block_size"],
                                      c["large_block_size"])
            parity = codes.of(c).parity_shards(c, data)
            order = np.argsort(v.ids)
            body = np.array([needle.body_size(int(s))
                             for s in v.data_sizes], dtype=np.int64)
            refs[rec["volume"]] = [harness.digest(row) for row in data] + [
                harness.digest(row) for row in parity] + [harness.digest(
                    needle.index_bytes(v.ids[order], v.offsets[order],
                                       body[order]))]
        want = refs[rec["volume"]]
        shards += sum(g != w for g, w in zip(rec["digests"][:k + m],
                                             want[:k + m]))
        ecx += rec["digests"][k + m] != want[k + m]
    run.log(f"compared {len(run.records)} jobs' {k + m} shards and .ecx "
            f"with the reference")
    return {"shard_files_differing": (shards, 0),
            "ecx_files_differing": (ecx, 0)}
