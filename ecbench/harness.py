"""One run of one benchmark cell: set-up, the measured window, the check
against the plain reference, and the contract's result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name: the cell in BENCHMARK.json names a configuration (its JSON
file) and a traffic mix (`ecbench/traffic/<name>.json`); the traffic names
its operation driver (`ecbench/drivers/<driver>.py`); every metric is a
reader of its own (`ecbench/metrics/<metric>.py`).  A driver has four
functions, each taking the `Run`:

    prepare(run)  set-up: make the volumes, encode, warm up
    run(run)      the window: append one record per operation
    close(run)    free the program's state
    verify(run)   {check name: (value, limit)} against the reference

A metric reader has `read(run) -> float | None`; None leaves the metric
out of the line.

The result line's `setup_built` says whether set-up built a kernel or
library (a new file in the program's or the benchmark's build directory):
such a run's setup_s holds the compilers' time.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules no run may have loaded once its window has closed
BANNED = ("jax", "jaxlib", "flax", "seaweedfs_tpu")


def load_module(kind: str, name: str):
    """ecbench/<kind>/<name>.py, loaded by its path (metric names hold
    dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"ecbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell, configuration, traffic) of a workload name."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return bench, cell, config, traffic


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): those that list it, or list no cells at all."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def written_bytes() -> int:
    """Bytes this process has handed to write(2) so far (/proc/self/io
    wchar)."""
    with open("/proc/self/io") as f:
        for line in f:
            if line.startswith("wchar:"):
                return int(line.split()[1])
    raise RuntimeError("/proc/self/io has no wchar")


def built_files(dirs) -> set:
    """The files now in the build directories `dirs`."""
    return {os.path.join(d, f) for d in dirs if os.path.isdir(d)
            for f in os.listdir(d)}


def work_dir() -> str:
    """A fresh directory under TMPDIR; never under /dev/shm."""
    parent = os.path.realpath(tempfile.gettempdir())
    if parent == "/dev/shm" or parent.startswith("/dev/shm/"):
        raise RuntimeError(f"refusing to work under /dev/shm ({parent}); "
                           f"set TMPDIR to a directory on disk")
    return tempfile.mkdtemp(prefix="ecbench-", dir=parent)


class Run:
    """What a driver and a metric reader see of one run."""

    def __init__(self, workload, cell, config, traffic, seed, seconds,
                 trace, device, work, system):
        self.workload, self.cell = workload, cell
        self.config, self.traffic = config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.work, self.system = device, work, system
        self.state: dict = {}
        self.records: list[dict] = []
        self.attempted = 0
        self.failed = 0
        self.setup_s: "float | None" = None
        self.window_s: "float | None" = None
        self.counters_before: dict = {}
        self.counters_after: dict = {}
        self.device_trace = None        # trace.DeviceTrace of a traced run
        self.kind = "cpu"               # the card's name on CUDA

    def log(self, msg: str) -> None:
        print(f"ecbench: {msg}", flush=True)

    def span(self, name: str):
        """A host span in the profiler's trace (traced runs only)."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def fail(self, what: str, exc: BaseException) -> None:
        self.failed += 1
        if self.failed <= 3:
            print(f"ecbench: {what} failed: {exc!r}", file=sys.stderr)
            traceback.print_exc(file=sys.stderr)

    def counter_delta(self, sample: str, backend: str, op: str) -> float:
        key = (sample, backend, op)
        return (self.counters_after.get(key, 0.0)
                - self.counters_before.get(key, 0.0))


def open_loop(run: Run, interval: float, job, before=None, after=None
              ) -> None:
    """Jobs due every `interval` seconds from now until the window closes:
    `before(i)` runs ahead of job i's due time (untimed), `job(i)` -> a
    record, timed from its due time to its return, then `after(i, record)`
    (untimed).  One job at a time: a late job starts late and its wait
    counts."""
    start = time.perf_counter()
    i = 0
    while start + i * interval < start + run.seconds:
        due = start + i * interval
        if before is not None:
            before(i)
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        began = time.perf_counter()
        run.attempted += 1
        try:
            with run.span("ecbench.op"):
                rec = job(i)
        except Exception as e:   # a job that raises is a failed answer
            run.fail(f"job {i}", e)
            rec = None
        end = time.perf_counter()
        if rec is not None:
            rec.update(due=due, began=began, end=end, job=i)
            run.records.append(rec)
            if after is not None:
                after(i, rec)
        i += 1
    late = [r["began"] - r["due"] for r in run.records]
    if late:
        run.log(f"job generator lateness: max {max(late):.6f} s, mean "
                f"{sum(late) / len(late):.6f} s over {len(late)} jobs")
        run.log("job seconds from due to return: " + " ".join(
            f"{r['end'] - r['due']:.4f}" for r in run.records))


def digest(data) -> str:
    """BLAKE2b of a bytes-like object or a uint8 array."""
    return hashlib.blake2b(np.ascontiguousarray(data), digest_size=32
                           ).hexdigest()


def file_digest(path: str) -> "str | None":
    """BLAKE2b of a file's bytes (None when it is missing), read through
    one reused buffer."""
    if not os.path.exists(path):
        return None
    h = hashlib.blake2b(digest_size=32)
    buf = bytearray(8 << 20)
    view = memoryview(buf)
    with open(path, "rb", buffering=0) as f:
        while n := f.readinto(buf):
            h.update(view[:n])
    return h.hexdigest()


def _make_system(kind: str, device, config: dict, traffic: dict):
    if kind == "program":
        from .system import Program
        return Program(device, config)
    if kind == "control":
        from .control.system import Control
        return Control(config, traffic)
    raise ValueError(f"unknown system {kind!r}")


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: "float | None" = None,
             system: str = "program", overrides: "dict | None" = None
             ) -> dict:
    """One run of `workload`; returns the result line's object.
    `overrides` replace traffic parameters (the CPU tests' small sizes)."""
    t0 = time.perf_counter() if t0 is None else t0
    bench, cell, config, traffic = load_cell(workload)
    traffic = {**traffic, **(overrides or {})}
    work = work_dir()
    wrote0 = written_bytes()
    try:
        import torch
        dev = torch.device(device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(dev)
            torch.zeros(1, device=dev)
        if traffic["volume_mb"] > config["volume_size_limit_mb"]:
            raise ValueError(f"{cell['traffic']}: volume_mb "
                             f"{traffic['volume_mb']} is over the "
                             f"configuration's volume size limit")
        run = Run(workload, cell, config, traffic, seed, seconds, trace,
                  dev, work, _make_system(system, dev, config, traffic))
        if dev.type == "cuda":
            run.kind = torch.cuda.get_device_name(dev)
        from . import volume
        build_dirs = [volume.BUILD_DIR] + run.system.cache_dirs()
        before = built_files(build_dirs)
        driver = load_module("drivers", traffic["driver"])
        driver.prepare(run)
        run.sync()
        # the set-up's files go to disk now, not during the window
        os.sync()
        run.setup_s = time.perf_counter() - t0
        built = sorted(built_files(build_dirs) - before)
        wrote_setup = written_bytes() - wrote0
        run.log(f"set-up {run.setup_s:.3f} s, {wrote_setup} bytes written; "
                f"built in set-up: "
                f"{', '.join(map(os.path.basename, built)) or 'nothing'}")
        run.counters_before = run.system.counters()
        from .trace import traced
        with traced(run) if trace else contextlib.nullcontext():
            w0 = time.perf_counter()
            driver.run(run)
            run.sync()
            run.window_s = time.perf_counter() - w0
        run.counters_after = run.system.counters()
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        driver.close(run)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        wrote = written_bytes() - wrote0
        run.log(f"window {run.window_s:.3f} s, {run.attempted} operations; "
                f"bytes written by this run: {wrote} "
                f"({wrote / 2**30:.3f} GiB)")
        checks = driver.verify(run)
        metrics = {}
        for m in metrics_of(bench, workload, trace):
            value = load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        correct = (run.attempted > 0 and run.failed == 0
                   and all(v <= lim for v, lim in checks.values()))
        result = {"correct": correct, "attempted": run.attempted,
                  "failed": run.failed, "metrics": metrics,
                  "device": _device(torch, dev, cell, peak, run)}
        if trace and run.device_trace is not None:
            result["breakdown"] = run.device_trace.breakdown()
        result["setup_built"] = bool(built)
        result["checks"] = {name: {"value": v, "limit": lim}
                            for name, (v, lim) in checks.items()}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _device(torch, dev, cell: dict, peak: int, run: Run) -> dict:
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": run.kind,
               "count": cell["chips"], "memory_peak_bytes": int(peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if run.device_trace is not None:
        out["busy_s"] = run.device_trace.busy_s()
        out["window_s"] = run.device_trace.window_s()
    return out


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is one of BANNED."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(BANNED))
