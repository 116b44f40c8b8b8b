"""Open loop of multi-loss `ec.rebuild` jobs (VolumeEcShardsRebuild) on
one seeded volume, encoded by the program in set-up: each job loses a set
of shards at once, as a cluster does that loses a rack holding several
of a volume's shards, and one rebuild restores them all.

Traffic parameters: `volume_mb`, `interval_s` (one job due every
interval), `lost_sets` (the shards each job loses, cycled in this fixed
order whatever the seed).

Before a job's due time its lost shards are deleted; the job is timed
from its due time to the return of rebuild_ec_files.  Then, untimed, each
restored shard is recorded as a digest and removed, and the shards as
encoded are linked back (hard links: no bytes written), so every job
rebuilds from the same survivors.

The read plan is RS's (ec_encoder.go RebuildEcFiles): k whole survivors
whatever the losses.  Another code kind is refused until it brings a
multi-loss plan of its own.
"""

from __future__ import annotations

import os

import numpy as np

from ecbench import harness, volume
from ecbench.reference import codes, layout


def _check(config: dict, traffic: dict) -> None:
    if config["code_kind"] != "rs":
        raise ValueError(f"multi_loss_rebuild_jobs has a multi-loss read "
                         f"plan for code kind 'rs' only, not for "
                         f"{config['code_kind']!r}")
    n = config["data_shards"] + config["parity_shards"]
    for lost in traffic["lost_sets"]:
        if not (0 < len(lost) <= config["parity_shards"]
                and len(set(lost)) == len(lost)
                and all(0 <= s < n for s in lost)):
            raise ValueError(f"lost set {lost}: the code restores 1 to "
                             f"{config['parity_shards']} distinct shards "
                             f"of {n}")


def _shard_path(base: str, s: int) -> str:
    return f"{base}.ec{s:02d}"


def prepare(run) -> None:
    c, t = run.config, run.traffic
    _check(c, t)
    vol = volume.make_volume(os.path.join(run.work, "1"),
                             int(t["volume_mb"] * 2**20), run.seed % 2**64,
                             c["needle_bytes_min"], c["needle_bytes_max"])
    run.system.encode(vol.base)
    n = c["data_shards"] + c["parity_shards"]
    encoded = os.path.join(run.work, "encoded")
    os.makedirs(encoded)
    for s in range(n):
        os.link(_shard_path(vol.base, s), os.path.join(encoded, f"{s:02d}"))
    run.state.update(volume=vol, encoded=encoded,
                     shard=os.path.getsize(_shard_path(vol.base, 0)))
    # warm-up: every lost set once on a one-row volume (the codec's decode
    # matrix of each), then one job on the cell's volume
    warm = volume.make_volume(os.path.join(run.work, "2"),
                              c["data_shards"] * c["small_block_size"],
                              run.seed % 2**64, c["needle_bytes_min"],
                              c["needle_bytes_max"])
    run.system.encode(warm.base)
    for lost in t["lost_sets"]:
        for s in lost:
            os.remove(_shard_path(warm.base, s))
        run.system.rebuild(warm.base)
    for name in os.listdir(run.work):
        if name.startswith("2."):
            os.remove(os.path.join(run.work, name))
    lost = t["lost_sets"][-1]
    for s in lost:
        os.remove(_shard_path(vol.base, s))
    run.system.rebuild(vol.base)
    _relink(run, lost)


def _relink(run, lost) -> None:
    """Each restored shard of `lost` removed and the encoded one linked
    back in its place."""
    base = run.state["volume"].base
    for s in lost:
        if os.path.exists(_shard_path(base, s)):
            os.remove(_shard_path(base, s))
        os.link(os.path.join(run.state["encoded"], f"{s:02d}"),
                _shard_path(base, s))


def expected_read(run) -> int:
    """Bytes an RS rebuild of any lost set reads: k whole survivors."""
    return run.config["data_shards"] * run.state["shard"]


def run(run) -> None:
    base, sets = run.state["volume"].base, run.traffic["lost_sets"]
    shard, k = run.state["shard"], run.config["data_shards"]

    def lost_of(i):
        return list(sets[i % len(sets)])

    def before(i):
        for s in lost_of(i):
            os.remove(_shard_path(base, s))

    def job(i):
        stats = run.system.rebuild(base)
        lost = lost_of(i)
        # the codec's least traffic: k survivors read, each lost shard
        # written once
        return {"lost": lost, "bytes": len(lost) * shard,
                "bytes_read": stats.get("bytes_read"),
                "codec_io_bytes": (k + len(lost)) * shard}

    def after(i, rec):
        rec["digests"] = [harness.file_digest(_shard_path(base, s))
                          for s in rec["lost"]]
        _relink(run, rec["lost"])

    harness.open_loop(run, float(run.traffic["interval_s"]), job, before,
                      after)


def close(run) -> None:
    pass


def verify(run) -> dict:
    """Every restored shard of every job against the reference's data or
    parity row, byte for byte, and each rebuild's read count against the
    code's plan."""
    c = run.config
    k = c["data_shards"]
    dat = np.fromfile(run.state["volume"].base + ".dat", dtype=np.uint8)
    data = layout.data_shards(dat, k, c["small_block_size"],
                              c["large_block_size"])
    parity = None
    if any(s >= k for r in run.records for s in r["lost"]):
        parity = codes.of(c).parity_shards(c, data)
    plan = expected_read(run)
    differing = read_off = 0
    want = {}
    for rec in run.records:
        for s, got in zip(rec["lost"], rec["digests"]):
            if s not in want:
                want[s] = harness.digest(data[s] if s < k
                                         else parity[s - k])
            differing += got != want[s]
        got = rec["bytes_read"]
        read_off += abs(got - plan) if got is not None else plan
    run.log(f"compared {sum(len(r['lost']) for r in run.records)} "
            f"restored shards of {len(run.records)} jobs and their read "
            f"counts with the reference")
    return {"shards_differing": (differing, 0),
            "read_bytes_off_plan": (read_off, 0)}
