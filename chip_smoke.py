#!/usr/bin/env python3
"""Smoke run of seaweedfs_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's erasure-coding path on the card, in five phases; any
mismatch or failure exits non-zero:

1. Build every native source of the port (`seaweedfs_tpu_torch/csrc/`) into
   the git-ignored `seaweedfs_tpu_torch/build/`, compilers in parallel.
2. The GF(2^8) kernel against its plain torch version on the card, byte for
   byte: RS(10,4) parity, the 4-lost decode matrix, RS(16,8), Cauchy
   RS(28,4), ragged widths; and against the numpy `gf256.matmul` tables on
   a 64 KiB slice.
3. A fleet-sized device batch: RSCodec encode and 4-lost reconstruct of
   [V=64, k=10, 8 MiB], timed with CUDA events (median of 7 after warm-up)
   beside the HBM bound, and held against the plain version volume by
   volume.
4. The on-disk main path on a 2 GiB volume of seeded needles (1 KiB-1 MiB):
   encode_volume_to_ec, rebuild of 4 deleted shards (byte-identical),
   1,000 degraded needle reads with 2 data shards gone, decode back to a
   byte-identical .dat; then the fleet forms on 4 volumes of 256 MiB:
   encode_ec_files_batch (byte-identical to write_ec_files) and
   rebuild_ec_files_batch of 4 deleted shards (byte-identical).  The
   kernel's launch count is zeroed just before this phase and read just
   after it; it must be > 0.  Then one more encode_volume_to_ec of the
   2 GiB volume under torch.profiler gives the device's busy share and
   the kernel's and copies' shares of that call.
5. The kernels line (JSON), the card line, then the result line.

Every number is printed beside the card's name and power limit.  Needs a
CUDA device; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12        # H100 SXM dense int8 tensor-core peak

PRESENT = [0, 2, 3, 5, 6, 7, 9, 10, 11, 13]
LOST = [1, 4, 8, 12]
MIB = 1 << 20


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def bound_ms(in_bytes: int, out_bytes: int, ops: int) -> tuple[float, str]:
    """Least time the card could take: bytes over HBM rate vs int8 ops
    over the tensor-core peak, the larger of the two."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gf_ops(mo: int, ki: int, columns: int) -> int:
    """Multiply-adds of the bit-plane product, counted as 2 ops each."""
    return 2 * (8 * mo) * (8 * ki) * columns


def time_cuda(torch, fn, reps: int = 7, warmup: int = 2) -> float:
    """Median ms of `fn` over `reps` runs, each bracketed by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 2 ---------------------------------------------------------------

def kernel_cases(rs_matrix):
    """(name, GF matrix, data shape) on the main path's shapes."""
    gen = rs_matrix.generator_matrix(10, 4)
    decode = rs_matrix.decode_matrix(gen, PRESENT, LOST)
    return [
        ("rs10_4_parity", gen[10:], (10, 8 * MIB)),
        ("rs10_4_decode_4lost", decode, (10, 8 * MIB)),
        ("rs16_8_parity", rs_matrix.generator_matrix(16, 8)[16:],
         (16, 8 * MIB)),
        ("rs28_4_cauchy_parity",
         rs_matrix.generator_matrix(28, 4, "cauchy")[28:], (28, 8 * MIB)),
        ("rs10_4_parity_ragged", gen[10:], (10, MIB + 17)),
        ("rs10_4_parity_ragged_batched", gen[10:], (3, 10, MIB + 17)),
        ("rs10_4_decode_needle_interval", decode, (10, 4099)),
    ]


def phase_kernel_vs_plain(torch, device, cases, card, gen_seed=1):
    from seaweedfs_tpu_torch.ops import gf256, rs_cuda
    g = torch.Generator(device=device).manual_seed(gen_seed)
    worst = 0
    for name, M, shape in cases:
        planes = rs_cuda.matrix_planes(M, device)
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=device,
                          generator=g)
        got = rs_cuda.gf_matmul_bits_cuda(planes, x)
        want = rs_cuda.gf_matmul_bits_plain(planes, x)
        err = int((got.int() - want.int()).abs().max())
        bad = int((got != want).sum())
        check(bad == 0, f"{name}: {bad} bytes differ from the plain version")
        # independent oracle: the numpy GF(2^8) tables on a 64 KiB slice
        xs = x.reshape(-1, shape[-2], shape[-1])[0, :, :64 * 1024]
        oracle = gf256.matmul(M, xs.cpu().numpy())
        gs = got.reshape(-1, M.shape[0], shape[-1])[0, :, :64 * 1024]
        check(np.array_equal(gs.cpu().numpy(), oracle),
              f"{name}: differs from gf256.matmul")
        worst = max(worst, err)
        print(f"[kernel] {name} {list(shape)}: 0 bytes differ from plain, "
              f"gf256 slice equal  [{card}]")
    return worst


# -- phase 3 ---------------------------------------------------------------

def phase_fleet(torch, device, card, volumes=64, width=8 * MIB, reps=7):
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.ops.codec import RSCodec
    k, m = 10, 4
    codec = RSCodec(k, m, device=device)
    g = torch.Generator(device=device).manual_seed(2)
    data = torch.randint(0, 256, (volumes, k, width), dtype=torch.uint8,
                         device=device, generator=g)
    cols = volumes * width
    res = {}

    parity = rs_cuda.gf_matmul_bits_cuda(codec.parity_planes, data)
    res["encode_ms"] = time_cuda(
        torch, lambda: rs_cuda.gf_matmul_bits_cuda(codec.parity_planes, data),
        reps=reps)
    # survivors of the 4-lost mask, rebuilt back to the lost shards
    chosen = torch.empty_like(data)
    for j, s in enumerate(PRESENT):
        chosen[:, j] = data[:, s] if s < k else parity[:, s - k]
    planes = codec.decode_planes(tuple(PRESENT), tuple(LOST))
    rebuilt = rs_cuda.gf_matmul_bits_cuda(planes, chosen)
    for j, s in enumerate(LOST):
        lost = data[:, s] if s < k else parity[:, s - k]
        check(torch.equal(rebuilt[:, j], lost),
              f"fleet reconstruct: shard {s} differs from the original")
    res["reconstruct_ms"] = time_cuda(
        torch, lambda: rs_cuda.gf_matmul_bits_cuda(planes, chosen), reps=reps)

    # plain version, one volume at a time (its float32 bit-planes take 32
    # bytes per input byte); timed with events around each chunk
    worst = 0
    plain_ms = {"encode": 0.0, "reconstruct": 0.0}
    for op, pl, src, out in (("encode", codec.parity_planes, data, parity),
                             ("reconstruct", planes, chosen, rebuilt)):
        for v in range(volumes):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = rs_cuda.gf_matmul_bits_plain(pl, src[v])
            end.record()
            end.synchronize()
            plain_ms[op] += start.elapsed_time(end)
            bad = int((want != out[v]).sum())
            check(bad == 0, f"fleet {op}: volume {v}: {bad} bytes differ "
                            f"from the plain version")
            worst = max(worst, int((want.int() - out[v].int()).abs().max()))
    res["encode_plain_ms"] = plain_ms["encode"]
    res["reconstruct_plain_ms"] = plain_ms["reconstruct"]
    res["encode_bound_ms"], res["encode_bound_by"] = bound_ms(
        k * cols, m * cols, gf_ops(m, k, cols))
    res["reconstruct_bound_ms"], res["reconstruct_bound_by"] = bound_ms(
        k * cols, len(LOST) * cols, gf_ops(len(LOST), k, cols))
    res["max_abs_err"] = worst
    gb_in = k * cols / 1e9
    for op in ("encode", "reconstruct"):
        print(f"[fleet] {op} [{volumes}, {k}, {width}]: kernel "
              f"{res[op + '_ms']:.3f} ms ({gb_in / res[op + '_ms'] * 1e3:.1f}"
              f" GB/s of shard input), HBM bound "
              f"{res[op + '_bound_ms']:.3f} ms ({res[op + '_bound_by']}), "
              f"plain {res[op + '_plain_ms']:.1f} ms  [{card}]")
    del data, parity, chosen, rebuilt
    torch.cuda.empty_cache()
    return res


# -- phase 4 ---------------------------------------------------------------

def build_volume(base: str, total_bytes: int, seed: int,
                 min_size: int = 1024, max_size: int = MIB):
    """A version-3 volume (<base>.dat + <base>.idx) of seeded needles with
    payload sizes uniform in [min_size, max_size], written through the
    port's Needle, idx and SuperBlock.  Returns [(id, offset, size)] of the
    payloads."""
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.idx import idx_entry_bytes
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.super_block import SuperBlock
    rng = np.random.default_rng(seed)
    needles = []
    with open(base + ".dat", "wb") as dat, open(base + ".idx", "wb") as idx:
        offset = dat.write(SuperBlock(version=t.VERSION3).to_bytes())
        nid = 0
        while offset < total_bytes:
            nid += 1
            size = int(rng.integers(min_size, max_size + 1))
            n = Needle(id=nid, cookie=int(rng.integers(0, 1 << 32)),
                       data=rng.bytes(size),
                       append_at_ns=1_700_000_000_000_000_000 + nid)
            record = n.to_bytes(t.VERSION3)
            dat.write(record)
            idx.write(idx_entry_bytes(nid, offset, n.size))
            needles.append((nid, offset, size))
            offset += len(record)
    return needles


def _files_equal(a: str, b: str) -> bool:
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    if os.path.getsize(a) == 0:
        return True
    return bool(np.array_equal(np.memmap(a, dtype=np.uint8, mode="r"),
                               np.memmap(b, dtype=np.uint8, mode="r")))


def phase_main_path(device, card, work_dir, volume_bytes=2 << 30,
                    reads=1000, geo=None, seed=3, codec=None):
    """encode -> rebuild -> degraded reads -> decode on one volume."""
    from seaweedfs_tpu_torch.ops import gf256
    from seaweedfs_tpu_torch.ops.codec import RSCodec
    from seaweedfs_tpu_torch.storage import ec
    from seaweedfs_tpu_torch.storage import types as t
    geo = geo or ec.DEFAULT_GEOMETRY
    k = geo.data_shards
    codec = codec or RSCodec(k, geo.parity_shards, device=device)
    base = os.path.join(work_dir, "1")
    t0 = time.perf_counter()
    needles = build_volume(base, volume_bytes, seed)
    dat_size = os.path.getsize(base + ".dat")
    res = {"needles": len(needles), "dat_bytes": dat_size,
           "build_volume_s": time.perf_counter() - t0}
    print(f"[disk] volume: {len(needles)} needles, {dat_size} bytes in "
          f"{res['build_volume_s']:.1f} s ({work_dir})  [{card}]")

    def path(s):
        return base + ec.to_ext(s)

    # encode: shards + .ecx + .vif
    t0 = time.perf_counter()
    ec.encode_volume_to_ec(base, version=t.VERSION3, geo=geo, codec=codec)
    res["encode_s"] = time.perf_counter() - t0
    shard_size = os.path.getsize(path(0))
    check(shard_size == geo.shard_file_size(dat_size), "shard size")
    # parity of the first 64 KiB of every stripe column, against the tables
    head = min(shard_size, 64 * 1024)
    data_head = np.stack([np.fromfile(path(s), dtype=np.uint8, count=head)
                          for s in range(k)])
    parity_head = np.stack([np.fromfile(path(k + p), dtype=np.uint8,
                                        count=head)
                            for p in range(geo.parity_shards)])
    check(np.array_equal(parity_head, gf256.matmul(codec.gen[k:], data_head)),
          "encoded parity differs from gf256.matmul")

    # rebuild 4 lost shards, byte-identical to the encoded ones
    lost = [0, 7, 10, 13]
    for s in lost:
        os.replace(path(s), path(s) + ".orig")
    t0 = time.perf_counter()
    rebuilt = ec.rebuild_ec_files(base, codec=codec)
    res["rebuild_s"] = time.perf_counter() - t0
    check(rebuilt == lost, f"rebuilt {rebuilt}, expected {lost}")
    for s in lost:
        check(_files_equal(path(s), path(s) + ".orig"),
              f"rebuilt shard {s} differs")
        os.remove(path(s) + ".orig")

    # degraded reads with data shards 1 and 4 gone
    gone = [1, 4]
    for s in gone:
        os.replace(path(s), path(s) + ".orig")
    ev = ec.EcVolume(work_dir, "", 1, codec=codec)
    for s in range(geo.total_shards):
        if s not in gone:
            ev.add_shard(s)
    rng = np.random.default_rng(seed + 1)
    touching = [nd for nd in needles
                if any(iv.to_shard_id_and_offset(geo)[0] in gone
                       for iv in ev.locate_ec_shard_needle(nd[0])[2])]
    check(len(touching) > 0, "no needle touches the lost shards")
    picks = rng.choice(len(touching), size=reads,
                       replace=len(touching) < reads)
    dat = np.memmap(base + ".dat", dtype=np.uint8, mode="r")
    lat = []
    for i in picks:
        nid, off, size = touching[int(i)]
        t0 = time.perf_counter()
        n = ev.read_needle(nid)
        lat.append((time.perf_counter() - t0) * 1e3)
        start = off + t.NEEDLE_HEADER_SIZE + 4   # v2+: dataSize(4) first
        check(bytes(n.data) == dat[start:start + size].tobytes(),
              f"degraded read of needle {nid} differs")
    ev.close()
    del dat
    res["degraded_reads"] = len(lat)
    res["degraded_distinct_needles"] = len(set(int(i) for i in picks))
    res["degraded_p50_ms"] = float(np.percentile(lat, 50))
    res["degraded_p99_ms"] = float(np.percentile(lat, 99))

    # decode back to .dat (rebuilds the 2 missing data shards first)
    os.replace(base + ".dat", base + ".dat.orig")
    os.replace(base + ".idx", base + ".idx.orig")
    t0 = time.perf_counter()
    ec.decode_ec_to_volume(base, codec=codec)
    res["decode_s"] = time.perf_counter() - t0
    check(_files_equal(base + ".dat", base + ".dat.orig"),
          "decoded .dat differs from the original")
    for s in gone:
        check(_files_equal(path(s), path(s) + ".orig"),
              f"shard {s} rebuilt by decode differs")
        os.remove(path(s) + ".orig")
    os.remove(base + ".dat.orig")
    os.remove(base + ".idx.orig")

    res["encode_gbps"] = dat_size / res["encode_s"] / 1e9
    res["rebuild_gbps"] = k * shard_size / res["rebuild_s"] / 1e9
    print(f"[disk] encode_volume_to_ec: {res['encode_s']:.2f} s, "
          f"{res['encode_gbps']:.2f} GB/s of .dat  [{card}]")
    print(f"[disk] rebuild of shards {lost}: {res['rebuild_s']:.2f} s, "
          f"{res['rebuild_gbps']:.2f} GB/s of survivor bytes read, "
          f"byte-identical  [{card}]")
    print(f"[disk] degraded read_needle x{len(lat)} "
          f"({res['degraded_distinct_needles']} distinct, shards {gone} "
          f"gone): p50 {res['degraded_p50_ms']:.3f} ms, p99 "
          f"{res['degraded_p99_ms']:.3f} ms, payloads equal  [{card}]")
    print(f"[disk] decode_ec_to_volume: {res['decode_s']:.2f} s, .dat "
          f"byte-identical  [{card}]")
    return res


def phase_fleet_disk(card, work_dir, codec, volumes=4,
                     volume_bytes=256 * MIB + 12345, geo=None, seed=5):
    """The fleet forms on disk: `volumes` .dat files of one size through
    encode_ec_files_batch, held byte for byte against write_ec_files of
    each volume alone; then the same 4 shards deleted from every volume,
    rebuild_ec_files_batch, and the rebuilt shards held against the
    encoded ones."""
    from seaweedfs_tpu_torch.storage import ec
    from seaweedfs_tpu_torch.storage import types as t
    geo = geo or ec.DEFAULT_GEOMETRY
    rng = np.random.default_rng(seed)
    bases = [os.path.join(work_dir, f"f{v}") for v in range(volumes)]
    for b in bases:
        with open(b + ".dat", "wb") as f:
            f.write(rng.bytes(volume_bytes))
        # the geometry rebuild_ec_files_batch reads back
        ec.save_volume_info(b, t.VERSION3, dat_size=volume_bytes,
                            data_shards=geo.data_shards,
                            parity_shards=geo.parity_shards,
                            large_block_size=geo.large_block_size,
                            small_block_size=geo.small_block_size)
    res = {"volumes": volumes, "dat_bytes": volume_bytes}

    t0 = time.perf_counter()
    ec.encode_ec_files_batch(bases, geo, codec)
    res["encode_s"] = time.perf_counter() - t0
    for v, b in enumerate(bases):
        single = os.path.join(work_dir, f"single{v}")
        os.symlink(b + ".dat", single + ".dat")
        ec.write_ec_files(single, geo, codec)
        for s in range(geo.total_shards):
            check(_files_equal(b + ec.to_ext(s), single + ec.to_ext(s)),
                  f"fleet encode: volume {v} shard {s} differs from "
                  f"write_ec_files")
            os.remove(single + ec.to_ext(s))
        os.remove(single + ".dat")

    lost = [2, 5, 11, 12]
    for b in bases:
        for s in lost:
            os.replace(b + ec.to_ext(s), b + ec.to_ext(s) + ".orig")
    t0 = time.perf_counter()
    rebuilt = ec.rebuild_ec_files_batch(bases, codec=codec)
    res["rebuild_s"] = time.perf_counter() - t0
    for b in bases:
        check(rebuilt[b] == lost, f"fleet rebuild of {b}: {rebuilt[b]}")
        for s in lost:
            check(_files_equal(b + ec.to_ext(s), b + ec.to_ext(s) + ".orig"),
                  f"fleet rebuild: {b} shard {s} differs")
    for b in bases:
        for f in os.listdir(work_dir):
            if f.startswith(os.path.basename(b) + "."):
                os.remove(os.path.join(work_dir, f))

    total = volumes * volume_bytes
    res["encode_gbps"] = total / res["encode_s"] / 1e9
    res["rebuild_gbps"] = (volumes * geo.data_shards
                           * geo.shard_file_size(volume_bytes)
                           / res["rebuild_s"] / 1e9)
    print(f"[fleet-disk] encode_ec_files_batch of {volumes} x "
          f"{volume_bytes} B: {res['encode_s']:.2f} s, "
          f"{res['encode_gbps']:.2f} GB/s of .dat, byte-identical to "
          f"write_ec_files  [{card}]")
    print(f"[fleet-disk] rebuild_ec_files_batch of shards {lost}: "
          f"{res['rebuild_s']:.2f} s, {res['rebuild_gbps']:.2f} GB/s of "
          f"survivor bytes read, byte-identical  [{card}]")
    return res


def phase_profile_encode(torch, card, base, codec):
    """encode_volume_to_ec of `base` once more under torch.profiler: the
    device's busy share of the call's wall time (union of every device
    interval), and the kernel's and the copies' shares."""
    from torch.profiler import ProfilerActivity, profile
    from seaweedfs_tpu_torch.storage import ec
    from seaweedfs_tpu_torch.storage import types as t
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ec.encode_volume_to_ec(base, version=t.VERSION3, codec=codec)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = {"kernel": [], "h2d": [], "d2h": [], "other": []}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.lower()
        kind = ("h2d" if "htod" in name else "d2h" if "dtoh" in name
                else "kernel" if "gf2" in name else "other")
        spans[kind].append((e.time_range.start, e.time_range.end))
    res = {"wall_s": wall_us / 1e6,
           "device_events": sum(len(v) for v in spans.values())}
    if not res["device_events"]:
        print(f"[profile] torch.profiler saw no device activity: device "
              f"busy share not measured  [{card}]")
        return res
    for kind, iv in spans.items():
        res[kind + "_share"] = sum(e - s for s, e in iv) / wall_us
        res[kind + "_events"] = len(iv)
    busy, end = 0.0, float("-inf")    # union of all device intervals
    for s, e in sorted(iv for v in spans.values() for iv in v):
        if e > end:
            busy += e - max(s, end)
            end = e
    res["busy_share"] = busy / wall_us
    print(f"[profile] encode_volume_to_ec under torch.profiler: "
          f"{res['wall_s']:.2f} s wall; device busy "
          f"{100 * res['busy_share']:.2f}% (kernel "
          f"{100 * res['kernel_share']:.3f}% in {res['kernel_events']}, "
          f"h2d {100 * res['h2d_share']:.2f}% in {res['h2d_events']}, "
          f"d2h {100 * res['d2h_share']:.2f}% in {res['d2h_events']}, "
          f"other {100 * res['other_share']:.3f}%)  [{card}]")
    return res


def work_dir_for(volume_bytes: int) -> str:
    """/dev/shm when it has 4x the volume free, else the temp dir."""
    shm = "/dev/shm"
    if os.path.isdir(shm) and shutil.disk_usage(shm).free >= 4 * volume_bytes:
        return tempfile.mkdtemp(prefix="chip_smoke_", dir=shm)
    return tempfile.mkdtemp(prefix="chip_smoke_")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from seaweedfs_tpu_torch.ops import _build, rs_cuda, rs_matrix
    from seaweedfs_tpu_torch.ops.codec import RSCodec

    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    print(f"[build] {sorted(_build.SOURCES)} in {build_s:.1f} s  [{card}]")
    for line in _build.build_logs.get("gf2_matmul", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")

    # 2. kernel vs plain
    worst = phase_kernel_vs_plain(torch, device, kernel_cases(rs_matrix),
                                  card)

    # 3. fleet-sized device batch
    fleet = phase_fleet(torch, device, card)
    worst = max(worst, fleet["max_abs_err"])

    # 4. on-disk main path and its fleet forms, launches counted from zero;
    # then one more encode of the same volume under the profiler
    work = work_dir_for(2 << 30)
    try:
        codec = RSCodec(device=device)
        rs_cuda.launches.reset()
        disk = phase_main_path(device, card, work, codec=codec)
        fleet_disk = phase_fleet_disk(card, work, codec)
        main_launches = rs_cuda.launches.value
        profiled = phase_profile_encode(torch, card, os.path.join(work, "1"),
                                        codec)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(main_launches > 0, "the main path launched the kernel no time")
    print(f"[disk] gf2_matmul launches on the main path: {main_launches}"
          f"  [{card}]")

    # 5. kernels line, card line, result line
    kernels = {"kernels": [{
        "name": "gf2_matmul",
        "route": "cuda",
        "source": "seaweedfs_tpu_torch/csrc/gf2_matmul.cu",
        "replaces": "seaweedfs_tpu/ops/rs_pallas.py:165",
        "launches": main_launches,
        "max_abs_err": worst,
        "ms": fleet["encode_ms"],
        "plain_ms": fleet["encode_plain_ms"],
        "bound_ms": fleet["encode_bound_ms"],
        "bound_by": fleet["encode_bound_by"],
        "library_ms": None,
    }]}
    details = {"card": card, "build_s": build_s, "fleet": fleet,
               "disk": disk, "fleet_disk": fleet_disk, "profile": profiled}
    print("details: " + json.dumps(details))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
