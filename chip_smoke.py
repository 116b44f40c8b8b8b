#!/usr/bin/env python3
"""Smoke run of seaweedfs_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's erasure-coding paths on the card, RS(10,4), Clay(10,4)
and LRC(10,2,2), in eight phases; any mismatch or failure exits non-zero:

1. Build every native source of the port (`seaweedfs_tpu_torch/csrc/`) into
   the git-ignored `seaweedfs_tpu_torch/build/`, compilers in parallel, and
   print each CUDA kernel's registers and spill bytes from ptxas.
2. Every kernel against its plain torch version on the card, byte for
   byte.  The GF(2^8) kernel: RS(10,4) parity, the 4-lost decode matrix,
   RS(16,8), Cauchy RS(28,4), ragged widths, and the numpy `gf256.matmul`
   tables on a 64 KiB slice; its column-tiled and volume-major entries.
   The fused Clay kernels: encode at Clay(10,4), (6,3), (4,2) and at
   ragged window widths (4099, 13, and 1600, whose second tile mixes the
   16-byte and the guarded byte path in one warp); repair of every lost
   shard 0..13 of Clay(10,4), and of shards 0, 9, 10, 13 at the ragged
   widths, each also held against the encoded shard.
3. Fleet-sized device batches timed with CUDA events (min, quartiles and
   median of 21 runs after warm-up) beside their bounds and held against the plain versions: RS
   encode and 4-lost reconstruct of [V=64, k=10, 8 MiB] (shard-major and
   volume-major entries; the volume-major entry has no caller in the
   package, and its first call here, counted from zero, is its drive);
   Clay(10,4) fused encode of [10, 512, 256, 4096] and fused repair of
   [13, 512, 64, 4096] (each also alone at the on-disk path's per-call
   shape, [10, 8, 256, 4096] and [13, 8, 64, 4096]), and the tiled path
   (elementwise uncouple/couple around the column-tiled entry) at the
   encode's shape.
4. The RS on-disk main path on a 2 GiB volume of seeded needles (1 KiB-1
   MiB): encode_volume_to_ec, rebuild of 4 deleted shards (byte-identical),
   1,000 degraded needle reads with 2 data shards gone, decode back to a
   byte-identical .dat; then the fleet forms on 4 volumes of 256 MiB:
   encode_ec_files_batch (byte-identical to write_ec_files) and
   rebuild_ec_files_batch of 4 deleted shards.  The GF(2^8) kernel's
   launch count is zeroed just before this phase and read just after it,
   and must be > 0.  Then one
   more encode_volume_to_ec of the 2 GiB volume under torch.profiler gives
   the device's busy share and the kernel's and copies' shares of that call.
5. The Clay on-disk path on a 1 GiB volume of seeded needles, default
   geometry (1 GiB large / 1 MiB small blocks: q=4, t=4, alpha=256,
   beta=64, k0=12, w_a=4096): encode_volume_to_ec (data shards identical to
   an RS encode's, the first window's parity equal to the plain version),
   single-loss rebuilds of .ec03 and .ec12 (clay-plane-fused, helper bytes
   read against RS's k shards), a 2-loss rebuild (clay-decode), 300
   degraded reads with shards 1 and 4 gone, decode back to a byte-identical
   .dat, and the fleet forms on 4 volumes of 256 MiB.  The two Clay launch
   counts are zeroed just before this phase and must be > 0 after it.
6. The serving binding (`seaweedfs_tpu_torch.serving.bind`), driven with
   the calls the volume server's EC RPCs and its store make: a 1 GiB
   volume as LRC(10,2,2) (`ec.encode -kind lrc -lrcLocals 2`), its parity
   held against the numpy oracle, a single-loss rebuild of .ec03 on the
   local plan (5 shards read) and a 2-loss rebuild of .ec03 and .ec13 on
   the global plan, 300 degraded reads through EcVolume + load_shard,
   file_count / deleted_count after 10 deletes, decode back to a
   byte-identical .dat and destroy; then the same for an RS(10,4) and a
   Clay(10,4) volume of 256 MiB.  Every kernel's launch count is zeroed
   before it; gf2_matmul and both clay kernels must launch, and the codec
   metrics' dispatch counts must equal the dispatches the phase made.
7. The device mesh (`seaweedfs_tpu_torch.parallel`): the pickers
   (`multi_device_host()` is `device_count() > 1`; with no device given,
   `codec_for(geo)` is an RSCodec on cuda whatever the GPU count).  On virtual meshes of the card
   repeated 4 times (s=2, b=2) and 8 times (s=4, b=2), and on every GPU
   when there is more than one: MeshCodec's encode of [64, 10, 8 MiB] and
   reconstruct of the 4 lost [1, 4, 8, 12] at [64, 8 MiB], the LRC(10,2,2)
   rows through gf_mesh_encode_begin and Clay(10,4) through
   clay_mesh_encode_begin on 64 windows of 1 MiB, each byte-identical to
   the single-device codec, each launching its kernel exactly once per
   position (counted from zero), each device program timed with CUDA
   events (median and quartiles of 7 runs) beside the single-device
   codec's kernel; then, with every launch count zeroed, a 1 GiB RS needle
   volume through `codec_for(geo, device=mesh)` (encode and a rebuild of
   4 deleted shards, byte-identical to RSCodec's) and `serving.bind(mesh)`
   on one LRC(10,2,2) and one Clay(10,4) volume of 256 MiB (encode equal
   to `serving.bind(device)`'s, single-loss rebuild, decode).  A virtual
   mesh runs the whole mesh program (per-position launches, zero-shard
   padding, column blocks, the XOR reduce) on one card; its times are not
   multi-GPU numbers.
8. The kernels line (JSON; each kernel's median time at its fleet shape
   over 21 runs, with min and quartiles, and its launches on each path),
   the card line, then the result line.

Every number is printed beside the card's name and power limit.  Needs a
CUDA device; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
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


class Tally:
    """Per kernel, every comparison of a kernel's output with its plain
    version: bytes compared, bytes that differ (any differing byte fails
    the run) and the largest absolute byte difference."""

    def __init__(self):
        self.by_kernel: dict[str, dict] = {}

    def hold(self, name: str, what: str, got, want) -> None:
        bad = int((got != want).sum())
        err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
        t = self.by_kernel.setdefault(
            name, {"compared_bytes": 0, "mismatches": 0, "max_abs_err": 0})
        t["compared_bytes"] += got.numel()
        t["mismatches"] += bad
        t["max_abs_err"] = max(t["max_abs_err"], err)
        check(bad == 0, f"{what}: {bad} bytes differ from the plain version")


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


# runs of each kernel at its fleet shape: enough for its quartiles
SPREAD_RUNS = 21


def time_cuda(torch, fn, reps: int = SPREAD_RUNS, warmup: int = 2) -> dict:
    """ms of `fn` over `reps` runs, each bracketed by CUDA events: the
    median ("ms"), min, 25th and 75th percentiles, and the run count."""
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
    p25, p50, p75 = np.percentile(times, [25, 50, 75])
    return {"ms": float(p50), "min": min(times), "p25": float(p25),
            "p75": float(p75), "runs": reps}


def spread_line(tag: str, what: str, t: dict, bound: float, card: str
                ) -> str:
    return (f"[{tag}] spread of {what} over {t['runs']} runs: min "
            f"{t['min']:.3f}, p25 {t['p25']:.3f}, median {t['ms']:.3f}, p75 "
            f"{t['p75']:.3f} ms; bound {bound:.3f} ms  [{card}]")


def _kernel_name(entry: str) -> str:
    """`name<N>` of a mangled template kernel `..<len>name ILi<N>E..`: the
    identifier is the one whose length prefix fits (a namespace hash may
    end in digits too); any other entry as it is."""
    m = re.search(r"ILi(\d+)E", entry)
    if m:
        end = m.start()
        for start in range(end - 1, 0, -1):
            if entry[start].isalpha() and \
                    entry[:start].endswith(str(end - start)):
                return f"{entry[start:end]}<{m.group(1)}>"
    return entry


def ptxas_report(log: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads", "stack"}} from
    nvcc's `-Xptxas -v` output; template kernels named as `name<N>`."""
    report, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = _kernel_name(m.group(1))
            report[kernel] = {}
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            report[kernel].update(stack=int(m.group(1)),
                                  spill_stores=int(m.group(2)),
                                  spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[kernel]["registers"] = int(m.group(1))
    return report


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


def phase_kernel_vs_plain(torch, device, cases, card, tally, gen_seed=1):
    from seaweedfs_tpu_torch.ops import gf256, rs_cuda
    g = torch.Generator(device=device).manual_seed(gen_seed)
    for name, M, shape in cases:
        planes = rs_cuda.matrix_planes(M, device)
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=device,
                          generator=g)
        got = rs_cuda.gf_matmul_bits_cuda(planes, x)
        tally.hold("gf2_matmul", name, got,
                   rs_cuda.gf_matmul_bits_plain(planes, x))
        # independent oracle: the numpy GF(2^8) tables on a 64 KiB slice
        xs = x.reshape(-1, shape[-2], shape[-1])[0, :, :64 * 1024]
        oracle = gf256.matmul(M, xs.cpu().numpy())
        gs = got.reshape(-1, M.shape[0], shape[-1])[0, :, :64 * 1024]
        check(np.array_equal(gs.cpu().numpy(), oracle),
              f"{name}: differs from gf256.matmul")
        print(f"[kernel] {name} {list(shape)}: 0 bytes differ from plain, "
              f"gf256 slice equal  [{card}]")


# -- phase 3 ---------------------------------------------------------------

def phase_fleet(torch, device, card, tally, volumes=64, width=8 * MIB,
                reps=SPREAD_RUNS):
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
    res["encode_spread"] = time_cuda(
        torch, lambda: rs_cuda.gf_matmul_bits_cuda(codec.parity_planes, data),
        reps=reps)
    res["encode_ms"] = res["encode_spread"]["ms"]
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
        torch, lambda: rs_cuda.gf_matmul_bits_cuda(planes, chosen),
        reps=reps)["ms"]
    # the volume-major entry on the same stack: it has no caller in the
    # package (nor has its TPU kernel), so this call, counted from zero, is
    # its drive
    rs_cuda.vm_launches.reset()
    vm_parity = rs_cuda.gf_matmul_bits_vm_cuda(codec.parity_planes, data)
    res["vm_launches"] = rs_cuda.vm_launches.value
    check(res["vm_launches"] > 0,
          "the volume-major entry's drive launched it no time")
    check(torch.equal(vm_parity, parity),
          "volume-major entry differs from the shard-major one")
    res["vm_spread"] = time_cuda(
        torch, lambda: rs_cuda.gf_matmul_bits_vm_cuda(codec.parity_planes,
                                                      data), reps=reps)
    res["vm_ms"] = res["vm_spread"]["ms"]
    del vm_parity

    # plain version, one volume at a time (its float32 bit-planes take 32
    # bytes per input byte); timed with events around each chunk
    plain_ms = {"encode": 0.0, "reconstruct": 0.0, "vm": 0.0}
    for op, pl, src, out in (("encode", codec.parity_planes, data, parity),
                             ("reconstruct", planes, chosen, rebuilt),
                             ("vm", codec.parity_planes, data, parity)):
        plain = rs_cuda.gf_matmul_bits_vm_plain if op == "vm" \
            else rs_cuda.gf_matmul_bits_plain
        for v in range(volumes):
            src_v = src[v:v + 1] if op == "vm" else src[v]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = plain(pl, src_v).reshape(out[v].shape)
            end.record()
            end.synchronize()
            plain_ms[op] += start.elapsed_time(end)
            tally.hold("gf2_matmul_vm" if op == "vm" else "gf2_matmul",
                       f"fleet {op}: volume {v}", out[v], want)
    res["encode_plain_ms"] = plain_ms["encode"]
    res["reconstruct_plain_ms"] = plain_ms["reconstruct"]
    res["vm_plain_ms"] = plain_ms["vm"]
    res["encode_bound_ms"], res["encode_bound_by"] = bound_ms(
        k * cols, m * cols, gf_ops(m, k, cols))
    res["reconstruct_bound_ms"], res["reconstruct_bound_by"] = bound_ms(
        k * cols, len(LOST) * cols, gf_ops(len(LOST), k, cols))
    gb_in = k * cols / 1e9
    print(f"[fleet] encode through the volume-major entry [{volumes}, {k}, "
          f"{width}]: {res['vm_ms']:.3f} ms, plain {res['vm_plain_ms']:.1f} "
          f"ms  [{card}]")
    for op in ("encode", "vm"):
        print(spread_line("fleet", f"{op} [{volumes}, {k}, {width}]",
                          res[op + "_spread"], res["encode_bound_ms"], card))
    for op in ("encode", "reconstruct"):
        print(f"[fleet] {op} [{volumes}, {k}, {width}]: kernel "
              f"{res[op + '_ms']:.3f} ms ({gb_in / res[op + '_ms'] * 1e3:.1f}"
              f" GB/s of shard input), HBM bound "
              f"{res[op + '_bound_ms']:.3f} ms ({res[op + '_bound_by']}), "
              f"plain {res[op + '_plain_ms']:.1f} ms  [{card}]")
    del data, parity, chosen, rebuilt
    torch.cuda.empty_cache()
    return res


# -- clay: phase 2 and 3 ---------------------------------------------------

CLAY_K, CLAY_M = 10, 4
CLAY_W_A = 4096     # 1 MiB small block / alpha 256


def _clay_args(code):
    from seaweedfs_tpu_torch.ops.clay import GAMMA
    return dict(q=code.q, t=code.t, gamma=GAMMA)


def _repair_input(torch, shards, helpers, plane):
    """x4 [H, n_win, beta, w_a]: the helpers' plane layers, gathered on the
    card from the shards [n, n_win, alpha, w_a] (a list of tensors)."""
    idx = torch.as_tensor(plane, device=shards[0].device)
    return torch.stack([shards[h].index_select(1, idx) for h in helpers])


def phase_clay_kernels_vs_plain(torch, device, card, tally, n_win=8,
                                w_a=CLAY_W_A, seed=4):
    """The matmul's column-tiled and volume-major entries and the fused
    Clay kernels against their plain versions at the main path's per-call
    shapes (one 8 MiB-per-shard batch = 8 windows) and at ragged widths;
    the repair also against the encoded shard itself."""
    from seaweedfs_tpu_torch.ops import clay_cuda, rs_cuda, rs_matrix
    from seaweedfs_tpu_torch.ops import clay_structured as cs
    from seaweedfs_tpu_torch.ops.clay_matrix import code
    g = torch.Generator(device=device).manual_seed(seed)
    held = tally.hold

    def rand(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8,
                             device=device, generator=g)

    rbits = cs.solve_planes(CLAY_K, CLAY_M, None, device)
    # the tiled path's batch [k0, n_win*alpha*w_a/128, 128]; a ragged X
    for x in (max(1, n_win * 256 * w_a // 128), 1001):
        u = rand((12, x, 128))
        held("gf2_matmul_cols", f"cols entry [12, {x}, 128]",
             rs_cuda.gf_matmul_bits_cols_cuda(rbits, u),
             rs_cuda.gf_matmul_bits_cols_plain(rbits, u))
        print(f"[kernel] gf2_matmul_cols [12, {x}, 128]: 0 bytes differ "
              f"from plain  [{card}]")
    gen = rs_matrix.generator_matrix(10, 4)
    # the RS fleet forms' windows: 4 volumes of 2 MiB per shard
    width = n_win * w_a * 64
    for name, M, shape in (
            ("rs10_4_parity", gen[10:], (4, 10, width)),
            ("rs10_4_decode_4lost",
             rs_matrix.decode_matrix(gen, PRESENT, LOST), (4, 10, width)),
            ("rs10_4_parity_ragged", gen[10:], (3, 10, width // 2 + 17))):
        pl = rs_cuda.matrix_planes(M, device)
        d = rand(shape)
        held("gf2_matmul_vm", f"vm entry {name}",
             rs_cuda.gf_matmul_bits_vm_cuda(pl, d),
             rs_cuda.gf_matmul_bits_vm_plain(pl, d))
        print(f"[kernel] gf2_matmul_vm {name} {list(shape)}: 0 bytes differ "
              f"from plain  [{card}]")

    cases = [((10, 4), n_win, w_a), ((6, 3), n_win, w_a),
             ((4, 2), n_win, w_a), ((10, 4), 3, w_a + 3), ((10, 4), 2, 13),
             ((10, 4), 2, 1600)]
    full_w_a = w_a
    for (k, m), n_win, w_a in cases:
        c = code(k, m)
        data = rand((k, n_win, c.alpha, w_a))
        rb = cs.solve_planes(k, m, None, device)
        args = dict(_clay_args(c), det_inv=int(c._det_inv))
        parity = clay_cuda.clay_fused_encode(rb, data, **args)
        held("clay_fused_encode", f"clay{(k, m)} encode w_a={w_a}", parity,
             clay_cuda.clay_fused_encode_plain(rb, data, **args))
        print(f"[kernel] clay_fused_encode Clay{(k, m)} "
              f"{list(data.shape)}: 0 bytes differ from plain  [{card}]")
        if (k, m) != (10, 4):
            continue
        shards = list(data) + list(parity)
        losses = range(k + m) if w_a == full_w_a else (0, 9, 10, 13)
        for lost in losses:
            helpers, plane, _, inv_gamma = cs.repair_parts(k, m, lost)
            x4 = _repair_input(torch, shards, helpers, plane)
            rp = cs.solve_planes(k, m, lost, device)
            args = dict(_clay_args(c), k=k, lost=lost, inv_gamma=inv_gamma)
            got = clay_cuda.clay_fused_repair(rp, x4, **args)
            held("clay_fused_repair", f"clay repair of {lost} w_a={w_a}",
                 got, clay_cuda.clay_fused_repair_plain(rp, x4, **args))
            check(torch.equal(got, shards[lost]),
                  f"clay repair of {lost} differs from the encoded shard")
        print(f"[kernel] clay_fused_repair Clay{(k, m)} lost "
              f"{list(losses)} [{k + m - 1}, {n_win}, {c.beta}, {w_a}]: 0 "
              f"bytes differ from plain, equal to the encoded shards  "
              f"[{card}]")


def _plain_chunked(torch, tally, name, fn, n_win, step, out, what):
    """Sum of CUDA-event times of fn(w0, w1) over window chunks (the plain
    versions materialise 32 bytes of float32 planes per input byte), each
    chunk held against the kernel's output slice out(w0, w1)."""
    total = 0.0
    for w0 in range(0, n_win, step):
        w1 = min(n_win, w0 + step)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = fn(w0, w1)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
        tally.hold(name, f"{what}: windows {w0}-{w1}", out(w0, w1), want)
    return total


def phase_clay_fleet(torch, device, card, tally, n_win=512, lost=3,
                     reps=SPREAD_RUNS, per_call_windows=8):
    """Clay(10,4) at a fleet-sized device batch (512 windows of 1 MiB per
    shard): the fused encode, the fused repair of one lost shard, and the
    tiled path with its column-tiled product, timed with CUDA events beside
    their HBM bounds and held against their plain versions.  The tiled path
    runs once with the column-tiled entry's launch count zeroed: that run
    is the tiled path's drive."""
    from seaweedfs_tpu_torch.ops import clay_cuda, rs_cuda
    from seaweedfs_tpu_torch.ops import clay_structured as cs
    from seaweedfs_tpu_torch.ops.clay_matrix import code
    k, m, w_a = CLAY_K, CLAY_M, CLAY_W_A
    c = code(k, m)
    small = c.alpha * w_a
    g = torch.Generator(device=device).manual_seed(6)
    data = torch.randint(0, 256, (k, n_win, c.alpha, w_a), dtype=torch.uint8,
                         device=device, generator=g)
    rbits = cs.solve_planes(k, m, None, device)
    enc_args = dict(_clay_args(c), det_inv=int(c._det_inv))
    res = {"shape_encode": list(data.shape)}

    parity = cs.encode_device_fused(k, m, data, small=small)
    res["encode_spread"] = time_cuda(
        torch, lambda: cs.encode_device_fused(k, m, data, small=small),
        reps=reps)
    res["encode_ms"] = res["encode_spread"]["ms"]
    res["encode_plain_ms"] = _plain_chunked(
        torch, tally, "clay_fused_encode",
        lambda a, b: clay_cuda.clay_fused_encode_plain(
            rbits, data[:, a:b].contiguous(), **enc_args),
        n_win, 8, lambda a, b: parity[:, a:b], "clay fleet encode")
    cols = n_win * c.alpha * w_a
    res["encode_bound_ms"], res["encode_bound_by"] = bound_ms(
        k * cols, m * cols, gf_ops(m, c.k0, cols))
    # the kernel alone at the on-disk path's per-call shape: one 8 MiB-per-
    # shard batch, 8 windows; launches in a row, timed together
    per_call = data[:, :per_call_windows].contiguous()
    res["shape_encode_per_call"] = list(per_call.shape)
    check(torch.equal(clay_cuda.clay_fused_encode(rbits, per_call,
                                                  **enc_args),
                      parity[:, :per_call_windows]),
          "clay encode at the per-call shape differs from the fleet batch")
    runs = 20
    res["encode_per_call_ms"] = time_cuda(
        torch, lambda: [clay_cuda.clay_fused_encode(rbits, per_call,
                                                    **enc_args)
                        for _ in range(runs)], reps=5)["ms"] / runs
    pc_cols = per_call_windows * c.alpha * w_a
    res["encode_per_call_bound_ms"], res["encode_per_call_bound_by"] = \
        bound_ms(k * pc_cols, m * pc_cols, gf_ops(m, c.k0, pc_cols))
    del per_call

    helpers, plane, _, inv_gamma = cs.repair_parts(k, m, lost)
    shards = list(data) + list(parity)
    x4 = _repair_input(torch, shards, helpers, plane)
    res["shape_repair"] = list(x4.shape)
    rebuilt = cs.repair_device_fused(k, m, lost, x4)
    check(torch.equal(rebuilt, shards[lost]),
          f"clay fleet repair of {lost} differs from the encoded shard")
    res["repair_spread"] = time_cuda(
        torch, lambda: cs.repair_device_fused(k, m, lost, x4), reps=reps)
    res["repair_ms"] = res["repair_spread"]["ms"]
    rp = cs.solve_planes(k, m, lost, device)
    rep_args = dict(_clay_args(c), k=k, lost=lost, inv_gamma=inv_gamma)
    # alone at the per-call shape too, as the encode above
    per_call = x4[:, :per_call_windows].contiguous()
    res["shape_repair_per_call"] = list(per_call.shape)
    check(torch.equal(clay_cuda.clay_fused_repair(rp, per_call, **rep_args),
                      rebuilt[:per_call_windows]),
          "clay repair at the per-call shape differs from the fleet batch")
    res["repair_per_call_ms"] = time_cuda(
        torch, lambda: [clay_cuda.clay_fused_repair(rp, per_call, **rep_args)
                        for _ in range(runs)], reps=5)["ms"] / runs
    pc_pcols = per_call_windows * c.beta * w_a
    res["repair_per_call_bound_ms"], res["repair_per_call_bound_by"] = \
        bound_ms((k + m - 1) * pc_pcols, per_call_windows * c.alpha * w_a,
                 gf_ops(m, c.k0, pc_pcols))
    del per_call
    res["repair_plain_ms"] = _plain_chunked(
        torch, tally, "clay_fused_repair",
        lambda a, b: clay_cuda.clay_fused_repair_plain(
            rp, x4[:, a:b].contiguous(), **rep_args),
        n_win, 8, lambda a, b: rebuilt[a:b], "clay fleet repair")
    pcols = n_win * c.beta * w_a
    res["repair_bound_ms"], res["repair_bound_by"] = bound_ms(
        (k + m - 1) * pcols, n_win * c.alpha * w_a, gf_ops(m, c.k0, pcols))
    del x4, rebuilt, shards

    # the tiled path: its drive (launches counted), then its timing
    data5 = data.view(k, n_win, c.alpha, w_a // 128, 128)
    rs_cuda.cols_launches.reset()
    tiled = cs.encode_device_tiled(k, m, data5, small=small)
    torch.cuda.synchronize()
    res["tiled_path_cols_launches"] = rs_cuda.cols_launches.value
    check(res["tiled_path_cols_launches"] > 0,
          "the tiled path launched the column-tiled entry no time")
    check(torch.equal(tiled.view(parity.shape), parity),
          "tiled path differs from the fused encode")
    del tiled
    res["tiled_ms"] = time_cuda(
        torch, lambda: cs.encode_device_tiled(k, m, data5, small=small),
        reps=3, warmup=1)["ms"]
    # its column-tiled product alone, on the uncoupled operand's shape
    u = torch.randint(0, 256, (c.k0, n_win * c.alpha * w_a // 128, 128),
                      dtype=torch.uint8, device=device, generator=g)
    u_par = rs_cuda.gf_matmul_bits_cols_cuda(rbits, u)
    res["cols_spread"] = time_cuda(
        torch, lambda: rs_cuda.gf_matmul_bits_cols_cuda(rbits, u), reps=reps)
    res["cols_ms"] = res["cols_spread"]["ms"]
    per_win = c.alpha * w_a // 128
    res["cols_plain_ms"] = _plain_chunked(
        torch, tally, "gf2_matmul_cols",
        lambda a, b: rs_cuda.gf_matmul_bits_cols_plain(
            rbits, u[:, a * per_win:b * per_win].contiguous()),
        n_win, 8, lambda a, b: u_par[:, a * per_win:b * per_win],
        "cols entry")
    res["cols_bound_ms"], res["cols_bound_by"] = bound_ms(
        c.k0 * cols, m * cols, gf_ops(m, c.k0, cols))
    del data, data5, parity, u, u_par
    torch.cuda.empty_cache()
    for op, what in (("encode", f"fused encode {res['shape_encode']}"),
                     ("repair", f"fused repair of {lost} "
                                f"{res['shape_repair']}"),
                     ("cols", f"cols entry [{c.k0}, {cols // 128}, 128]")):
        print(f"[clay-fleet] {what}: kernel {res[op + '_ms']:.3f} ms, bound "
              f"{res[op + '_bound_ms']:.3f} ms ({res[op + '_bound_by']}), "
              f"plain {res[op + '_plain_ms']:.1f} ms  [{card}]")
    for op in ("encode", "repair", "cols"):
        print(spread_line("clay-fleet", op, res[op + "_spread"],
                          res[op + "_bound_ms"], card))
    for op in ("encode", "repair"):
        print(f"[clay-fleet] fused {op} at the per-call shape "
              f"{res['shape_' + op + '_per_call']}: kernel "
              f"{res[op + '_per_call_ms']:.4f} ms per launch, bound "
              f"{res[op + '_per_call_bound_ms']:.4f} ms "
              f"({res[op + '_per_call_bound_by']})  [{card}]")
    print(f"[clay-fleet] tiled path {res['shape_encode']}: "
          f"{res['tiled_ms']:.3f} ms (elementwise torch passes + cols "
          f"entry), equal to the fused encode  [{card}]")
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


def open_ec_volume(work_dir, vid, geo, gone, ec_volume=None, codec=None):
    """An EcVolume of `vid` with every shard but `gone` loaded, as the store
    builds it: `ec_volume(dir, collection, vid)`, then load_shard."""
    if ec_volume is None:
        from seaweedfs_tpu_torch.storage import ec
        ev = ec.EcVolume(work_dir, "", vid, codec=codec)
    else:
        ev = ec_volume(work_dir, "", vid)
    for s in range(geo.total_shards):
        if s not in gone:
            ev.load_shard(s)
    return ev


def degraded_reads(ev, dat_path, needles, geo, gone, reads, seed):
    """`reads` needle reads through the EcVolume `ev` with the shards
    `gone` missing, drawn (seeded) from the needles that touch them; each
    payload is held against the .dat at `dat_path`.  Returns the latency
    percentiles and how many intervals were reconstructed."""
    from seaweedfs_tpu_torch.storage import types as t
    rng = np.random.default_rng(seed)
    touching = []
    for nd in needles:
        hit = sum(iv.to_shard_id_and_offset(geo)[0] in gone
                  for iv in ev.locate_ec_shard_needle(nd[0])[2])
        if hit:
            touching.append((nd, hit))
    check(len(touching) > 0, "no needle touches the lost shards")
    picks = rng.choice(len(touching), size=reads,
                       replace=len(touching) < reads)
    dat = np.memmap(dat_path, dtype=np.uint8, mode="r")
    lat, intervals = [], 0
    for i in picks:
        (nid, off, size), hit = touching[int(i)]
        t0 = time.perf_counter()
        n = ev.read_needle(nid)
        lat.append((time.perf_counter() - t0) * 1e3)
        intervals += hit
        start = off + t.NEEDLE_HEADER_SIZE + 4   # v2+: dataSize(4) first
        check(bytes(n.data) == dat[start:start + size].tobytes(),
              f"degraded read of needle {nid} differs")
    del dat
    return {"degraded_reads": len(lat),
            "degraded_distinct_needles": len(set(int(i) for i in picks)),
            "degraded_intervals": intervals,
            "degraded_p50_ms": float(np.percentile(lat, 50)),
            "degraded_p99_ms": float(np.percentile(lat, 99))}


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
    ev = open_ec_volume(work_dir, 1, geo, gone, codec=codec)
    res.update(degraded_reads(ev, base + ".dat", needles, geo, gone, reads,
                              seed + 1))
    ev.close()

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
    print(f"[disk] degraded read_needle x{res['degraded_reads']} "
          f"({res['degraded_distinct_needles']} distinct, shards {gone} "
          f"gone): p50 {res['degraded_p50_ms']:.3f} ms, p99 "
          f"{res['degraded_p99_ms']:.3f} ms, payloads equal  [{card}]")
    print(f"[disk] decode_ec_to_volume: {res['decode_s']:.2f} s, .dat "
          f"byte-identical  [{card}]")
    return res


def phase_clay_disk(torch, card, work_dir, codec, rs_codec,
                    volume_bytes=1 << 30, reads=300, seed=7):
    """The Clay path on one needle volume, default geometry: encode (data
    shards held against an RS encode of the same .dat, the first window's
    parity against the plain version), single-loss rebuilds of a data and
    a parity shard (clay-plane-fused), a 2-loss rebuild (clay-decode),
    degraded reads, decode back to the .dat."""
    from seaweedfs_tpu_torch.ops import clay_cuda
    from seaweedfs_tpu_torch.ops import clay_structured as cs
    from seaweedfs_tpu_torch.storage import ec
    from seaweedfs_tpu_torch.storage import types as t
    geo, c = codec.geo, codec.code
    k, m, small = geo.data_shards, geo.parity_shards, geo.small_block_size
    vid = 2
    base = os.path.join(work_dir, str(vid))
    t0 = time.perf_counter()
    needles = build_volume(base, volume_bytes, seed)
    dat_size = os.path.getsize(base + ".dat")
    res = {"needles": len(needles), "dat_bytes": dat_size,
           "geometry": {"k": k, "m": m, "q": c.q, "t": c.t,
                        "alpha": c.alpha, "beta": c.beta, "k0": c.k0,
                        "w_a": small // c.alpha},
           "build_volume_s": time.perf_counter() - t0}
    print(f"[clay-disk] volume: {len(needles)} needles, {dat_size} bytes, "
          f"geometry {res['geometry']}  [{card}]")

    def path(s, b=base):
        return b + ec.to_ext(s)

    t0 = time.perf_counter()
    ec.encode_volume_to_ec(base, version=t.VERSION3, geo=geo, codec=codec)
    res["encode_s"] = time.perf_counter() - t0
    shard_size = os.path.getsize(path(0))
    check(shard_size == geo.shard_file_size(dat_size), "clay shard size")
    # both codes are systematic: the data shards equal an RS encode's
    rs_base = os.path.join(work_dir, "3")
    os.symlink(base + ".dat", rs_base + ".dat")
    t0 = time.perf_counter()
    ec.write_ec_files(rs_base, dataclasses.replace(geo, code_kind="rs"),
                      rs_codec)
    res["rs_encode_s"] = time.perf_counter() - t0
    for s in range(k):
        check(_files_equal(path(s), path(s, rs_base)),
              f"clay data shard {s} differs from the RS encode's")
    for s in range(geo.total_shards):
        os.remove(path(s, rs_base))
    os.remove(rs_base + ".dat")
    # the first window's parity against the plain version
    first = np.stack([np.fromfile(path(s), dtype=np.uint8, count=small)
                      for s in range(k)])
    d4 = torch.from_numpy(first.reshape(k, 1, c.alpha, -1)).to(codec.device)
    want = clay_cuda.clay_fused_encode_plain(
        cs.solve_planes(k, m, None, codec.device), d4, **_clay_args(c),
        det_inv=int(c._det_inv)).cpu().numpy().reshape(m, small)
    got = np.stack([np.fromfile(path(k + p), dtype=np.uint8, count=small)
                    for p in range(m)])
    check(np.array_equal(got, want),
          "first window's clay parity differs from the plain version")

    def rebuild(lost, plan_kind):
        for s in lost:
            os.replace(path(s), path(s) + ".orig")
        stats = {}
        t0 = time.perf_counter()
        rebuilt = ec.rebuild_ec_files(base, codec=codec, stats=stats)
        dt = time.perf_counter() - t0
        check(rebuilt == lost, f"clay rebuilt {rebuilt}, expected {lost}")
        check(stats["plan_kind"] == plan_kind,
              f"clay rebuild of {lost}: plan {stats['plan_kind']}")
        for s in lost:
            check(_files_equal(path(s), path(s) + ".orig"),
                  f"clay rebuilt shard {s} differs")
            os.remove(path(s) + ".orig")
        rs_bytes = k * shard_size
        print(f"[clay-disk] rebuild of {lost}: {plan_kind}, {dt:.2f} s, "
              f"read {stats['bytes_read']} B against RS's k shards "
              f"{rs_bytes} B ({stats['bytes_read'] / rs_bytes:.4f}), "
              f"byte-identical  [{card}]")
        return {"s": dt, "bytes_read": stats["bytes_read"],
                "rs_bytes_read": rs_bytes, "plan_kind": plan_kind}

    res["rebuild_3"] = rebuild([3], "clay-plane-fused")
    res["rebuild_12"] = rebuild([12], "clay-plane-fused")
    res["rebuild_0_11"] = rebuild([0, 11], "clay-decode")

    gone = [1, 4]
    for s in gone:
        os.replace(path(s), path(s) + ".orig")
    ev = open_ec_volume(work_dir, vid, geo, gone, codec=codec)
    res.update(degraded_reads(ev, base + ".dat", needles, geo, gone, reads,
                              seed + 1))
    ev.close()
    os.replace(base + ".dat", base + ".dat.orig")
    os.replace(base + ".idx", base + ".idx.orig")
    t0 = time.perf_counter()
    ec.decode_ec_to_volume(base, codec=codec)
    res["decode_s"] = time.perf_counter() - t0
    check(_files_equal(base + ".dat", base + ".dat.orig"),
          "clay-decoded .dat differs from the original")
    for s in gone:
        check(_files_equal(path(s), path(s) + ".orig"),
              f"clay shard {s} rebuilt by decode differs")
    for f in os.listdir(work_dir):
        if f.startswith(f"{vid}."):
            os.remove(os.path.join(work_dir, f))

    res["encode_gbps"] = dat_size / res["encode_s"] / 1e9
    print(f"[clay-disk] encode_volume_to_ec: {res['encode_s']:.2f} s, "
          f"{res['encode_gbps']:.2f} GB/s of .dat (RS encode of the same "
          f".dat {res['rs_encode_s']:.2f} s); data shards equal RS's, first "
          f"window's parity equal to plain  [{card}]")
    print(f"[clay-disk] degraded read_needle x{res['degraded_reads']} "
          f"({res['degraded_distinct_needles']} distinct, shards {gone} "
          f"gone): p50 {res['degraded_p50_ms']:.3f} ms, p99 "
          f"{res['degraded_p99_ms']:.3f} ms, payloads equal  [{card}]")
    print(f"[clay-disk] decode_ec_to_volume: {res['decode_s']:.2f} s, .dat "
          f"byte-identical  [{card}]")
    return res


def phase_fleet_disk(card, work_dir, codec, volumes=4,
                     volume_bytes=256 * MIB + 12345, geo=None, seed=5,
                     lost=(2, 5, 11, 12)):
    """The fleet forms on disk: `volumes` .dat files of one size through
    encode_ec_files_batch, held byte for byte against write_ec_files of
    each volume alone; then the same `lost` shards deleted from every
    volume, rebuild_ec_files_batch, and the rebuilt shards held against
    the encoded ones."""
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
                            small_block_size=geo.small_block_size,
                            code_kind=geo.code_kind)
    res = {"volumes": volumes, "dat_bytes": volume_bytes,
           "code_kind": geo.code_kind}
    tag = f"[fleet-disk {geo.code_kind}]"

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

    lost = list(lost)
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
    print(f"{tag} encode_ec_files_batch of {volumes} x "
          f"{volume_bytes} B: {res['encode_s']:.2f} s, "
          f"{res['encode_gbps']:.2f} GB/s of .dat, byte-identical to "
          f"write_ec_files  [{card}]")
    print(f"{tag} rebuild_ec_files_batch of shards {lost}: "
          f"{res['rebuild_s']:.2f} s, {res['rebuild_gbps']:.2f} GB/s of "
          f"k shards' bytes per volume, byte-identical  [{card}]")
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


# -- phase 6: the serving binding ---------------------------------------------

SERVING_BATCH = 8 * MIB     # encoder.DEFAULT_BATCH_BYTES


def encode_dispatches(dat_size: int, geo, batch_bytes: int = SERVING_BATCH
                      ) -> int:
    """The encode calls write_ec_files makes for a .dat of `dat_size`: each
    large row in `batch_bytes` column slices, then the small rows
    `batch_bytes // small` at a time."""
    large_rows = 0
    while dat_size - large_rows * geo.large_row_size() >= \
            geo.large_row_size():
        large_rows += 1
    rest = dat_size - large_rows * geo.large_row_size()
    small_rows = -(-rest // geo.small_row_size())
    per_batch = max(1, batch_bytes // geo.small_block_size)
    return (large_rows * -(-geo.large_block_size // batch_bytes)
            + -(-small_rows // per_batch))


def serve_volume(bound, card, work_dir, kind, label, vid, volume_bytes,
                 reads, seed, expected):
    """One volume through the calls the volume server's EC RPCs and its
    store make, on the binding `bound`: VolumeEcShardsGenerate's
    encode_volume_to_ec(base, version=, geo=); two VolumeEcShardsRebuild
    rebuild_ec_files(base, stats=) (a single loss of .ec03, then .ec03 and
    .ec13); degraded reads through EcVolume(dir, "", vid) + load_shard;
    deletes; VolumeEcShardsToVolume's decode_ec_to_volume(base); and
    destroy.  Adds the codec dispatches it makes to `expected`, under the
    codec metrics' backend `label`."""
    from seaweedfs_tpu_torch.ops import lrc
    from seaweedfs_tpu_torch.storage import types as t
    geo = bound.EcGeometry(code_kind=kind,
                           lrc_locals=2 if kind == "lrc" else 0)
    base = os.path.join(work_dir, str(vid))
    tag = f"[serving {kind}]"

    def path(s):
        return base + bound.to_ext(s)

    needles = build_volume(base, volume_bytes, seed)
    dat_size = os.path.getsize(base + ".dat")
    res = {"needles": len(needles), "dat_bytes": dat_size}
    t0 = time.perf_counter()
    bound.encode_volume_to_ec(base, version=t.VERSION3, geo=geo)
    res["encode_s"] = time.perf_counter() - t0
    expected[(label, "encode")] += encode_dispatches(dat_size, geo)
    shard_size = os.path.getsize(path(0))
    check(shard_size == geo.shard_file_size(dat_size), f"{kind} shard size")
    check(bound.geometry_from_vif(base) == geo, f"{kind} .vif geometry")
    # the shell deletes the volume once it is encoded; its files stay
    # aside here for the decode's comparison
    for ext in (".dat", ".idx"):
        os.replace(base + ext, base + ext + ".orig")
    if kind == "lrc":
        # parity over the first and last 8 MiB of every shard against the
        # numpy oracle
        lgeo = lrc.LrcGeometry(10, 2, 2)
        span = min(8 * MIB, shard_size)
        for off in (0, shard_size - span):
            data, parity = (
                np.stack([np.fromfile(path(s), np.uint8, count=span,
                                      offset=off) for s in rows])
                for rows in (range(10), range(10, 14)))
            check(np.array_equal(parity, lrc.encode_shards(lgeo, data)[10:]),
                  f"LRC parity at shard offset {off} differs from the oracle")

    windows = -(-shard_size // SERVING_BATCH)
    plans = {"rs": ("rs-full", "rs-full"),
             "clay": ("clay-plane-fused", "clay-decode"),
             "lrc": ("local", "global")}[kind]
    res["rebuilds"] = []
    for lost, plan in zip(([3], [3, 13]), plans):
        for s in lost:
            os.replace(path(s), path(s) + ".orig")
        stats = {}
        t0 = time.perf_counter()
        rebuilt = bound.rebuild_ec_files(base, stats=stats)
        dt = time.perf_counter() - t0
        expected[(label, "reconstruct")] += windows if kind == "rs" else 1
        check(rebuilt == lost, f"{kind} rebuilt {rebuilt}, expected {lost}")
        check(stats["plan_kind"] == plan,
              f"{kind} rebuild of {lost}: plan {stats['plan_kind']}")
        for s in lost:
            check(_files_equal(path(s), path(s) + ".orig"),
                  f"{kind} rebuilt shard {s} differs")
            os.remove(path(s) + ".orig")
        rb = {"lost": lost, "plan_kind": plan, "s": dt,
              "bytes_read": stats["bytes_read"],
              "read_shards": stats.get("read_shards"),
              "rs_bytes_read": 10 * shard_size}
        res["rebuilds"].append(rb)
        print(f"{tag} rebuild_ec_files of {lost}: {plan}, {dt:.2f} s, read "
              f"{rb['bytes_read']} B against RS's {rb['rs_bytes_read']} B "
              f"({rb['bytes_read'] / rb['rs_bytes_read']:.4f}), shards "
              f"{rb['read_shards']}, byte-identical  [{card}]")
    if kind == "lrc":
        single, double = res["rebuilds"]
        check(single["read_shards"] == [0, 1, 2, 4, 10]
              and single["bytes_read"] == 5 * shard_size,
              f"LRC single-loss rebuild read {single['read_shards']}, "
              f"{single['bytes_read']} B")
        check(double["bytes_read"] == 10 * shard_size,
              f"LRC 2-loss rebuild read {double['bytes_read']} B")

    gone = [1, 7]
    for s in gone:
        os.replace(path(s), path(s) + ".orig")
    ev = open_ec_volume(work_dir, vid, geo, gone, ec_volume=bound.EcVolume)
    res.update(degraded_reads(ev, base + ".dat.orig", needles, geo, gone,
                              reads, seed + 1))
    if kind == "rs":
        expected[(label, "reconstruct")] += res["degraded_intervals"]
    # deletes: 10 needles, never the last (decode sizes the .dat by it)
    rng = np.random.default_rng(seed + 2)
    victims = rng.choice(len(needles) - 1, size=10, replace=False)
    for i in victims:
        ev.delete_needle(needles[int(i)][0])
    res["file_count"], res["deleted_count"] = ev.file_count(), \
        ev.deleted_count()
    check((res["file_count"], res["deleted_count"])
          == (len(needles) - 10, 10),
          f"{kind} file_count / deleted_count {res['file_count']} / "
          f"{res['deleted_count']} after 10 deletes of {len(needles)}")
    ev.close()

    # decode: rebuilds the 2 missing data shards, then stitches the .dat
    t0 = time.perf_counter()
    bound.decode_ec_to_volume(base)
    res["decode_s"] = time.perf_counter() - t0
    expected[(label, "reconstruct")] += windows if kind == "rs" else 1
    check(_files_equal(base + ".dat", base + ".dat.orig"),
          f"{kind}-decoded .dat differs from the original")
    for s in gone:
        check(_files_equal(path(s), path(s) + ".orig"),
              f"{kind} shard {s} rebuilt by decode differs")
        os.remove(path(s) + ".orig")

    ev = open_ec_volume(work_dir, vid, geo, [], ec_volume=bound.EcVolume)
    ev.destroy()
    family = {bound.to_ext(s) for s in range(geo.total_shards)} | {
        ".ecx", ".ecj", ".vif"}
    left = [f for f in os.listdir(work_dir) if f.startswith(f"{vid}.")
            and f[len(str(vid)):] in family]
    check(not left, f"{kind} destroy left {left}")
    for f in os.listdir(work_dir):
        if f.startswith(f"{vid}."):
            os.remove(os.path.join(work_dir, f))

    res["encode_gbps"] = dat_size / res["encode_s"] / 1e9
    print(f"{tag} encode_volume_to_ec of {dat_size} B: {res['encode_s']:.2f} "
          f"s, {res['encode_gbps']:.2f} GB/s of .dat  [{card}]")
    print(f"{tag} degraded read_needle x{res['degraded_reads']} through "
          f"EcVolume + load_shard ({res['degraded_distinct_needles']} "
          f"distinct, shards {gone} gone): p50 {res['degraded_p50_ms']:.3f} "
          f"ms, p99 {res['degraded_p99_ms']:.3f} ms, payloads equal  [{card}]")
    print(f"{tag} after 10 deletes: file_count {res['file_count']}, "
          f"deleted_count {res['deleted_count']}; decode_ec_to_volume "
          f"{res['decode_s']:.2f} s, .dat byte-identical; destroy left no "
          f"file of the family  [{card}]")
    return res


def phase_serving(card, work_dir, device, lrc_bytes=1 << 30,
                  other_bytes=256 * MIB, reads=300):
    """The serving binding (seaweedfs_tpu_torch.serving.bind) driven as the
    volume server's EC RPCs and its store drive it: LRC(10,2,2), what
    `ec.encode -kind lrc -lrcLocals 2` asks for, on a 1 GiB volume, then
    RS(10,4) and Clay(10,4) on `other_bytes` each.  The codec metrics'
    dispatch counts must equal the dispatches the phase made."""
    from seaweedfs_tpu_torch import serving
    from seaweedfs_tpu_torch.ops.codec import codec_metrics
    bound = serving.bind(device)
    mets = codec_metrics()
    # RSCodec's executor label: the kernel on the card, its plain version
    # on the CPU
    labels = {"rs": "rs_cuda" if bound.device.type == "cuda" else "rs_torch",
              "clay": "clay", "lrc": "lrc"}
    keys = [(b, op) for b in labels.values()
            for op in ("encode", "reconstruct")]
    before = {lb: mets.dispatch.value(*lb) for lb in keys}
    expected = dict.fromkeys(keys, 0)
    t0 = time.perf_counter()
    res = {kind: serve_volume(bound, card, work_dir, kind, labels[kind], vid,
                              size, reads, seed, expected)
           for kind, vid, size, seed in (("lrc", 21, lrc_bytes, 7),
                                         ("rs", 22, other_bytes, 9),
                                         ("clay", 23, other_bytes, 11))}
    res["s"] = time.perf_counter() - t0
    got = {lb: mets.dispatch.value(*lb) - before[lb] for lb in keys}
    res["dispatches"] = {f"{b}/{op}": [got[(b, op)], expected[(b, op)]]
                         for b, op in keys}
    text = mets.registry.render()
    for line in text.splitlines():
        if line.startswith("seaweedfs_codec_dispatch_total"):
            print(f"[serving] /metrics: {line}")
    for lb in keys:
        check(got[lb] == expected[lb],
              f"codec metrics count {got[lb]} {lb} dispatches, the phase "
              f"made {expected[lb]}")
    print(f"[serving] codec dispatches (counted, made): {res['dispatches']}; "
          f"phase {res['s']:.1f} s  [{card}]")
    return res


# -- phase 7: the device mesh -------------------------------------------------

MESH_RUNS = 7     # timed runs of each mesh program and its single-device twin


def time_on_mesh(torch, mesh, fn, reps: int = MESH_RUNS) -> dict:
    """time_cuda of `fn`, which issues on the mesh's streams: on a mesh of
    one device the events go on its mesh stream; across devices the host
    clock runs from a synchronised start to every device's end."""
    streams = mesh.streams()
    if len(streams) == 1:
        with mesh.issue():
            return time_cuda(torch, fn, reps=reps)

    def sync():
        for d in streams:
            torch.cuda.synchronize(d)
    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    p25, p50, p75 = np.percentile(times, [25, 50, 75])
    return {"ms": float(p50), "min": min(times), "p25": float(p25),
            "p75": float(p75), "runs": reps}


def _split(torch, mesh, full, row_blocks: int = 1):
    """Mesh array of `full`'s blocks as the codec lays them out: the last
    axis over every position (row_blocks 1), or rows over "s" and the last
    axis over "b" (row_blocks = the "s" size).  Contiguous copies on each
    position's device: set-up, not the codec's host split.  They are made
    on the current streams, which Mesh.issue() makes the mesh's wait for."""
    arr = np.empty(mesh.devices.shape, dtype=object)
    rows = full.shape[-2] // row_blocks
    n_col = mesh.size if row_blocks == 1 else mesh.shape["b"]
    cols = full.shape[-1] // n_col
    for idx, pos in enumerate(mesh.positions()):
        r = 0 if row_blocks == 1 else pos[0]
        c = idx if row_blocks == 1 else pos[1]
        arr[pos] = full[..., r * rows:(r + 1) * rows,
                        c * cols:(c + 1) * cols].contiguous().to(
                            mesh.devices[pos])
    return arr


def phase_mesh_programs(torch, mesh, card, label, volumes=64, width=8 * MIB,
                        clay_windows=64, reps=MESH_RUNS):
    """One mesh's programs at full width against the single-device codecs
    on its first position, byte for byte, each launching its kernel exactly
    once per position (counted from zero): MeshCodec's encode of [volumes,
    10, width] and its reconstruct of LOST from PRESENT at [volumes,
    width]; the LRC(10,2,2) rows through gf_mesh_encode_begin against
    gf_apply (host API, one batch of `width`) and on resident blocks; Clay
    (10,4) through clay_mesh_encode_begin on `clay_windows` windows of 1
    MiB against ClayWindowCodec (host API) and on resident blocks.  With
    reps, each device program and its single-device twin are timed."""
    from seaweedfs_tpu_torch.ops import clay_cuda, lrc, rs_cuda, rs_matrix
    from seaweedfs_tpu_torch.ops import clay_structured as cs
    from seaweedfs_tpu_torch.ops.codec import RSCodec, gf_apply
    from seaweedfs_tpu_torch.parallel import mesh_codec as mc
    from seaweedfs_tpu_torch.parallel import sharded_codec as sc
    from seaweedfs_tpu_torch.storage.ec import ClayWindowCodec, EcGeometry
    n = mesh.size
    dev0 = mesh.devices.flat[0]
    cuda = sc.mesh_is_cuda(mesh)
    codec = mc.MeshCodec(10, 4, mesh=mesh)
    single = RSCodec(10, 4, device=dev0)
    g = torch.Generator(device=dev0).manual_seed(21)
    res = {"mesh": label, "positions": n, "shape": dict(mesh.shape)}
    tag = f"[mesh {label}]"

    def rand(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev0,
                             generator=g)

    def counted(counter, fn):
        counter.reset()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        # CPU positions run the plain versions: no launch
        check(counter.value == (n if cuda else 0), f"{tag} "
              f"{counter.value} launches for {n} positions")
        return out

    def timed(op, mesh_fn, single_fn):
        if reps:
            res[op] = {"mesh": time_on_mesh(torch, mesh, mesh_fn, reps),
                       "single": time_cuda(torch, single_fn, reps=reps)}

    def hold(what, parts, want, row_blocks=1):
        """Each position's block against its slice of `want`, once the
        mesh's streams are done; with row_blocks, the product was reduced
        over "s" and only the positions of s index 0 hold it."""
        if cuda:
            torch.cuda.synchronize()
        n_col = mesh.size if row_blocks == 1 else mesh.shape["b"]
        cols = want.shape[-1] // n_col
        for idx, pos in enumerate(mesh.positions()):
            if row_blocks > 1 and pos[0]:
                check(parts[pos] is None, f"{tag} {what}: position {pos} "
                      f"holds a block off the reduce's target")
                continue
            c = idx if row_blocks == 1 else pos[1]
            check(torch.equal(parts[pos].to(dev0),
                              want[..., c * cols:(c + 1) * cols]),
                  f"{tag} {what}: position {pos} differs from the "
                  f"single-device codec")

    # RS encode: each volume's byte axis over every position
    full = rand((volumes, 10, width))
    blocks = _split(torch, mesh, full)
    parts = counted(rs_cuda.launches, lambda: codec.encode_device(blocks))
    want = rs_cuda.gf_matmul_bits_cuda(single.parity_planes, full)
    hold("encode", parts, want)
    timed("encode", lambda: codec.encode_device(blocks),
          lambda: rs_cuda.gf_matmul_bits_cuda(single.parity_planes, full))
    del full, blocks, parts, want

    # RS reconstruct: volumes folded onto the byte axis, k padded to k_pad
    # zero shards over "s"
    s_n = mesh.shape["s"]
    chosen = rand((codec.k_pad, volumes * width))
    chosen[10:] = 0
    blocks = _split(torch, mesh, chosen, s_n)
    present, lost = tuple(PRESENT), tuple(LOST)
    parts = counted(rs_cuda.launches,
                    lambda: codec.reconstruct_device(present, lost, blocks))
    planes = single.decode_planes(present, lost)
    want = rs_cuda.gf_matmul_bits_cuda(planes, chosen[:10])
    hold("reconstruct", parts, want, s_n)
    timed("reconstruct",
          lambda: codec.reconstruct_device(present, lost, blocks),
          lambda: rs_cuda.gf_matmul_bits_cuda(planes, chosen[:10]))
    del chosen, blocks, parts, want

    # LRC(10,2,2) parity rows on the GF(2^8) kernel at every position
    rows = np.ascontiguousarray(
        lrc.generator_matrix(lrc.LrcGeometry(10, 2, 2))[10:])
    x = rand((10, width)).cpu().numpy()
    got = counted(rs_cuda.launches,
                  lambda: mc.gf_mesh_encode_begin(rows, x, mesh)())
    check(np.array_equal(got, gf_apply(rows, x, device=dev0)),
          f"{tag} LRC rows differ from gf_apply")
    full = rand((10, volumes * width))
    blocks = _split(torch, mesh, full)
    pm = rs_cuda.to_plane_major(rs_matrix.bit_matrix(rows), 4, 10)
    planes = sc.mesh_planes(mesh, None, [pm])
    lrc_planes = torch.from_numpy(pm).to(dev0)
    hold("LRC", sc.local_products(mesh, planes, blocks),
         rs_cuda.gf_matmul_bits_cuda(lrc_planes, full))
    timed("lrc", lambda: sc.local_products(mesh, planes, blocks),
          lambda: rs_cuda.gf_matmul_bits_cuda(lrc_planes, full))
    del x, got, full, blocks

    # Clay(10,4): whole 1 MiB windows over every position
    geo = EcGeometry(CLAY_K, CLAY_M, code_kind="clay")
    small = geo.small_block_size
    full = rand((10, clay_windows * small))
    x = full.cpu().numpy()
    got = counted(clay_cuda.encode_launches,
                  lambda: mc.clay_mesh_encode_begin(10, 4, x, small,
                                                    mesh)())
    check(np.array_equal(got, ClayWindowCodec(geo, device=dev0).encode(x)),
          f"{tag} clay mesh encode differs from ClayWindowCodec")
    blocks = _split(torch, mesh, full)
    hold("clay", mc.clay_mesh_device(10, 4, blocks, small, mesh),
         cs.encode_device(10, 4, full, small=small))
    timed("clay", lambda: mc.clay_mesh_device(10, 4, blocks, small, mesh),
          lambda: cs.encode_device(10, 4, full, small=small))
    del x, got, full, blocks
    if cuda:
        torch.cuda.empty_cache()
    for op, shape in (("encode", [volumes, 10, width]),
                      ("reconstruct", [volumes, width]),
                      ("lrc", [10, volumes * width]),
                      ("clay", [10, clay_windows, 256, CLAY_W_A])):
        if op in res:
            t = res[op]
            print(f"{tag} {op} {shape} as a virtual mesh on one card: mesh "
                  f"program median {t['mesh']['ms']:.3f} ms (p25 "
                  f"{t['mesh']['p25']:.3f}, p75 {t['mesh']['p75']:.3f}), "
                  f"single-device codec {t['single']['ms']:.3f} ms (p25 "
                  f"{t['single']['p25']:.3f}, p75 {t['single']['p75']:.3f})"
                  f", {reps} runs each; byte-identical, {n} launches  "
                  f"[{card}]")
    return res


def phase_mesh_disk(card, work_dir, mesh, device, counters,
                    volume_bytes=1 << 30, serve_bytes=256 * MIB, seed=13):
    """The mesh through the entry points a user calls: a needle volume
    through `codec_for(geo, device=mesh)` (MeshCodec): encode_volume_to_ec
    and a rebuild of 4 deleted shards, every shard byte-identical to
    RSCodec's write_ec_files of the same .dat; then `serving.bind(mesh)`
    for one LRC(10,2,2) and one Clay(10,4) volume: encode (shards equal to
    `serving.bind(device)`'s), the single-loss rebuild of .ec03, and a
    decode with .ec01 gone back to a byte-identical .dat.  The launches of
    the single-device encodes it compares with are taken out of
    `counters` ({name: LaunchCounter}) into res["comparison_launches"]."""
    from seaweedfs_tpu_torch import serving
    from seaweedfs_tpu_torch.ops.codec import RSCodec
    from seaweedfs_tpu_torch.parallel.mesh_codec import MeshCodec
    from seaweedfs_tpu_torch.storage import ec
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec.encoder import codec_for
    res = {"comparison_launches": dict.fromkeys(counters, 0)}

    def compared(fn, *args, **kwargs):
        """A single-device run to compare with; its launches are counted
        apart."""
        before = {name: c.value for name, c in counters.items()}
        fn(*args, **kwargs)
        for name, c in counters.items():
            res["comparison_launches"][name] += c.value - before[name]

    def twin(base, name):
        """A second volume on the same .dat and .idx (symlinks)."""
        other = os.path.join(work_dir, name)
        for ext in (".dat", ".idx"):
            os.symlink(base + ext, other + ext)
        return other

    def same_shards(a, b, n, what):
        for s in range(n):
            check(_files_equal(a + ec.to_ext(s), b + ec.to_ext(s)),
                  f"{what}: shard {s} differs")

    geo = ec.DEFAULT_GEOMETRY
    base = os.path.join(work_dir, "m1")
    build_volume(base, volume_bytes, seed)
    codec = codec_for(geo, device=mesh)
    check(isinstance(codec, MeshCodec), f"codec_for(mesh) gave {codec}")
    t0 = time.perf_counter()
    ec.encode_volume_to_ec(base, version=t.VERSION3, geo=geo, codec=codec)
    res["rs_encode_s"] = time.perf_counter() - t0
    single = twin(base, "m1s")
    t0 = time.perf_counter()
    compared(ec.write_ec_files, single, geo, RSCodec(device=device))
    res["rs_single_encode_s"] = time.perf_counter() - t0
    same_shards(base, single, geo.total_shards, "mesh RS encode vs RSCodec")
    lost = [0, 7, 10, 13]
    for s in lost:
        os.remove(base + ec.to_ext(s))
    t0 = time.perf_counter()
    rebuilt = ec.rebuild_ec_files(base, codec=codec_for(geo, device=mesh))
    res["rs_rebuild_s"] = time.perf_counter() - t0
    check(rebuilt == lost, f"mesh RS rebuilt {rebuilt}, expected {lost}")
    same_shards(base, single, geo.total_shards, "mesh RS rebuild")
    res["rs_dat_bytes"] = os.path.getsize(base + ".dat")
    for f in os.listdir(work_dir):
        if f.startswith("m1"):
            os.remove(os.path.join(work_dir, f))
    print(f"[mesh disk] RS volume of {res['rs_dat_bytes']} B through "
          f"codec_for(geo, device=mesh): encode_volume_to_ec "
          f"{res['rs_encode_s']:.2f} s (RSCodec write_ec_files "
          f"{res['rs_single_encode_s']:.2f} s), rebuild of {lost} "
          f"{res['rs_rebuild_s']:.2f} s; every shard byte-identical to "
          f"RSCodec's  [{card}]")

    bound, bound_single = serving.bind(mesh), serving.bind(device)
    for kind, vid, vseed in (("lrc", 41, seed + 1), ("clay", 42, seed + 2)):
        geo = bound.EcGeometry(code_kind=kind,
                               lrc_locals=2 if kind == "lrc" else 0)
        base = os.path.join(work_dir, str(vid))
        build_volume(base, serve_bytes, vseed)
        t0 = time.perf_counter()
        bound.encode_volume_to_ec(base, version=t.VERSION3, geo=geo)
        r = {"encode_s": time.perf_counter() - t0}
        single = twin(base, f"{vid}s")
        compared(bound_single.encode_volume_to_ec, single,
                 version=t.VERSION3, geo=geo)
        same_shards(base, single, geo.total_shards,
                    f"bind(mesh) {kind} encode vs bind(device)")
        os.replace(base + ec.to_ext(3), base + ".orig3")
        t0 = time.perf_counter()
        check(bound.rebuild_ec_files(base) == [3],
              f"bind(mesh) {kind} rebuild")
        r["rebuild_s"] = time.perf_counter() - t0
        check(_files_equal(base + ec.to_ext(3), base + ".orig3"),
              f"bind(mesh) {kind}: rebuilt .ec03 differs")
        for ext in (".dat", ".idx"):
            os.replace(base + ext, base + ext + ".orig")
        os.remove(base + ec.to_ext(1))
        t0 = time.perf_counter()
        bound.decode_ec_to_volume(base)
        r["decode_s"] = time.perf_counter() - t0
        check(_files_equal(base + ".dat", base + ".dat.orig"),
              f"bind(mesh) {kind}: decoded .dat differs")
        check(_files_equal(base + ec.to_ext(1), single + ec.to_ext(1)),
              f"bind(mesh) {kind}: .ec01 rebuilt by decode differs")
        res[kind] = r
        for f in os.listdir(work_dir):
            if f.startswith(str(vid)):
                os.remove(os.path.join(work_dir, f))
        print(f"[mesh disk] serving.bind(mesh) {kind} on {serve_bytes} B: "
              f"encode {r['encode_s']:.2f} s (shards equal to "
              f"bind(device)'s), rebuild of .ec03 {r['rebuild_s']:.2f} s, "
              f"decode with .ec01 gone {r['decode_s']:.2f} s; "
              f"byte-identical  [{card}]")
    return res


def phase_mesh_picker(torch, card):
    """The production picker on this machine: RSCodec on cuda whatever
    the GPU count (the mesh is the caller's choice), and
    multi_device_host() reporting whether there is more than one GPU."""
    from seaweedfs_tpu_torch.ops.codec import RSCodec
    from seaweedfs_tpu_torch.parallel import mesh_codec as mc
    from seaweedfs_tpu_torch.storage import ec
    from seaweedfs_tpu_torch.storage.ec.encoder import codec_for
    count = torch.cuda.device_count()
    check(mc.multi_device_host() == (count > 1),
          f"multi_device_host() with {count} GPUs")
    codec = codec_for(ec.DEFAULT_GEOMETRY)
    check(type(codec) is RSCodec and codec.device.type == "cuda",
          f"{count} GPU(s): picked {codec}")
    print(f"[mesh] {count} GPU(s): multi_device_host() "
          f"{mc.multi_device_host()}, codec_for(RS(10,4)) is "
          f"{type(codec).__name__}  [{card}]")
    return {"gpus": count, "picked": type(codec).__name__}


def phase_mesh(torch, card, work_dir, device, programs=None, disk=None):
    """Phase 7: the pickers; the mesh programs on virtual meshes of
    `device` repeated 4 times (s=2, b=2) and 8 times (s=4, b=2), and on
    every GPU when there is more than one; then the mesh's on-disk and
    serving drive on the 4-position mesh (and on the real one), with every
    kernel's launch count zeroed just before it and read just after.
    `programs` and `disk` are keyword arguments (sizes) for
    phase_mesh_programs and phase_mesh_disk."""
    from seaweedfs_tpu_torch.ops import clay_cuda, rs_cuda
    from seaweedfs_tpu_torch.parallel.mesh_codec import default_ec_mesh
    res = {"picker": phase_mesh_picker(torch, card)}
    meshes = {"virtual4": default_ec_mesh([device] * 4),
              "virtual8": default_ec_mesh([device] * 8)}
    if torch.cuda.device_count() > 1:
        meshes["gpus"] = default_ec_mesh()
    res["programs"] = [phase_mesh_programs(torch, mesh, card, label,
                                           **(programs or {}))
                       for label, mesh in meshes.items()]
    counters = {"gf2_matmul": rs_cuda.launches,
                "clay_fused_encode": clay_cuda.encode_launches,
                "clay_fused_repair": clay_cuda.repair_launches}
    for counter in counters.values():
        counter.reset()
    res["disk"] = {label: phase_mesh_disk(card, work_dir, meshes[label],
                                          device, counters, **(disk or {}))
                   for label in ("virtual4", "gpus") if label in meshes}
    res["launches"] = {name: c.value - sum(
        d["comparison_launches"][name] for d in res["disk"].values())
        for name, c in counters.items()}
    for name, n in res["launches"].items():
        check(n > 0, f"the mesh path launched {name} no time")
    print(f"[mesh] launches on the mesh path: {res['launches']} (the "
          f"single-device encodes compared with: "
          f"{[d['comparison_launches'] for d in res['disk'].values()]})  "
          f"[{card}]")
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
    from seaweedfs_tpu_torch.ops import _build, clay_cuda, rs_cuda, rs_matrix
    from seaweedfs_tpu_torch.ops.codec import RSCodec
    from seaweedfs_tpu_torch.storage.ec import ClayWindowCodec, EcGeometry

    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    print(f"[build] {sorted(_build.SOURCES)} in {build_s:.1f} s  [{card}]")
    ptxas = {}
    for name in ("gf2_matmul", "clay_fused"):
        report = ptxas_report(_build.build_logs.get(name, ""))
        if not report:
            print(f"[build] ptxas {name}: no report (the library was "
                  f"loaded from an earlier build)")
        for kernel, r in report.items():
            ptxas[kernel] = r
            print(f"[build] ptxas {name} {kernel}: {r.get('registers')} "
                  f"registers, {r.get('spill_stores')} B spill stores, "
                  f"{r.get('spill_loads')} B spill loads, {r.get('stack')} "
                  f"B stack frame")

    # 2. kernel vs plain
    tally = Tally()
    phase_kernel_vs_plain(torch, device, kernel_cases(rs_matrix), card,
                          tally)
    phase_clay_kernels_vs_plain(torch, device, card, tally)

    # 3. fleet-sized device batches
    fleet = phase_fleet(torch, device, card, tally)
    clay_fleet = phase_clay_fleet(torch, device, card, tally)

    # 4. RS on-disk main path and its fleet forms, launches counted from
    # zero; then one more encode of the same volume under the profiler.
    # 5. the Clay on-disk path and its fleet forms, the same way.
    # 6. the serving binding: LRC, RS and Clay volumes, the same way.
    work = work_dir_for(2 << 30)
    try:
        codec = RSCodec(device=device)
        rs_cuda.launches.reset()
        disk = phase_main_path(device, card, work, codec=codec)
        fleet_disk = phase_fleet_disk(card, work, codec)
        main_launches = rs_cuda.launches.value
        profiled = phase_profile_encode(torch, card, os.path.join(work, "1"),
                                        codec)
        for f in os.listdir(work):
            if f.startswith("1."):
                os.remove(os.path.join(work, f))

        clay_geo = EcGeometry(CLAY_K, CLAY_M, code_kind="clay")
        clay_codec = ClayWindowCodec(clay_geo, device=device)
        clay_cuda.encode_launches.reset()
        clay_cuda.repair_launches.reset()
        clay_disk = phase_clay_disk(torch, card, work, clay_codec, codec)
        clay_fleet_disk = phase_fleet_disk(card, work, clay_codec,
                                           geo=clay_geo, seed=8, lost=(5,))
        encode_launches = clay_cuda.encode_launches.value
        repair_launches = clay_cuda.repair_launches.value

        # 6. the serving binding, every kernel's count from zero
        for counter in (rs_cuda.launches, clay_cuda.encode_launches,
                        clay_cuda.repair_launches):
            counter.reset()
        serving = phase_serving(card, work, device)
        serving_launches = {
            "gf2_matmul": rs_cuda.launches.value,
            "clay_fused_encode": clay_cuda.encode_launches.value,
            "clay_fused_repair": clay_cuda.repair_launches.value}

        # 7. the device mesh
        mesh = phase_mesh(torch, card, work, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(main_launches > 0, "the RS main path launched the kernel no time")
    check(encode_launches > 0, "the clay path launched its encode no time")
    check(repair_launches > 0, "the clay path launched its repair no time")
    print(f"[disk] launches on the RS path: gf2_matmul {main_launches}; on "
          f"the clay path: clay_fused_encode {encode_launches}, "
          f"clay_fused_repair {repair_launches}; on the tiled path: "
          f"gf2_matmul_cols {clay_fleet['tiled_path_cols_launches']}; in the "
          f"volume-major entry's drive: gf2_matmul_vm "
          f"{fleet['vm_launches']}  [{card}]")
    for name, n in serving_launches.items():
        check(n > 0, f"the serving binding launched {name} no time")
    print(f"[serving] launches through the binding: {serving_launches}  "
          f"[{card}]")

    # 8. kernels line, card line, result line
    pallas = "seaweedfs_tpu/ops/rs_pallas.py"
    csrc = "seaweedfs_tpu_torch/csrc"

    def entry(name, source, line, launches, spread, plain_ms, bound,
              bound_by):
        held = tally.by_kernel[name]
        return {"name": name, "route": "cuda", "source": f"{csrc}/{source}",
                "replaces": f"{pallas}:{line}", "launches": launches,
                "max_abs_err": held["max_abs_err"],
                "mismatches": held["mismatches"],
                "compared_bytes": held["compared_bytes"], "ms": spread["ms"],
                "ms_min": spread["min"], "ms_p25": spread["p25"],
                "ms_p75": spread["p75"], "runs": spread["runs"],
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                "library_ms": None,
                "serving_launches": serving_launches.get(name, 0),
                "mesh_launches": mesh["launches"].get(name, 0)}

    cf = clay_fleet
    kernels = {"kernels": [
        entry("gf2_matmul", "gf2_matmul.cu", 165, main_launches,
              fleet["encode_spread"], fleet["encode_plain_ms"],
              fleet["encode_bound_ms"], fleet["encode_bound_by"]),
        entry("gf2_matmul_vm", "gf2_matmul.cu", 101, fleet["vm_launches"],
              fleet["vm_spread"], fleet["vm_plain_ms"],
              fleet["encode_bound_ms"], fleet["encode_bound_by"]),
        entry("gf2_matmul_cols", "gf2_matmul.cu", 207,
              cf["tiled_path_cols_launches"], cf["cols_spread"],
              cf["cols_plain_ms"], cf["cols_bound_ms"],
              cf["cols_bound_by"]),
        entry("clay_fused_encode", "clay_fused.cu", 433, encode_launches,
              cf["encode_spread"], cf["encode_plain_ms"],
              cf["encode_bound_ms"], cf["encode_bound_by"]),
        entry("clay_fused_repair", "clay_fused.cu", 533, repair_launches,
              cf["repair_spread"], cf["repair_plain_ms"],
              cf["repair_bound_ms"], cf["repair_bound_by"]),
    ]}
    details = {"card": card, "build_s": build_s, "ptxas": ptxas,
               "fleet": fleet,
               "clay_fleet": clay_fleet, "disk": disk,
               "fleet_disk": fleet_disk, "profile": profiled,
               "clay_disk": clay_disk, "clay_fleet_disk": clay_fleet_disk,
               "serving": serving, "serving_launches": serving_launches,
               "mesh": mesh,
               "held_against_plain": tally.by_kernel}
    print("details: " + json.dumps(details))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
