"""The device trace of a traced run (`--trace 1`), reduced to what the
per-layer metrics and the breakdown read.

torch.profiler records the window with CPU and CUDA activity; the
benchmark marks the window (`ecbench.window`) and each operation
(`ecbench.op`) as host spans, so kernels, copies and the operations share
one clock.  The trace is exported as Chrome JSON into the run's work
directory, read back and deleted.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
from collections import defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW, OP = "ecbench.window", "ecbench.op"
TOP = 10


@contextlib.contextmanager
def traced(run):
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield
    path = os.path.join(run.work, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    run.device_trace = DeviceTrace(events)


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged, sorted [n, 2] intervals."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out, dtype=np.float64)


def _overlap(a: np.ndarray, b: np.ndarray) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i, 0], b[j, 0])
        hi = min(a[i, 1], b[j, 1])
        if hi > lo:
            total += hi - lo
        if a[i, 1] < b[j, 1]:
            i += 1
        else:
            j += 1
    return total


class DeviceTrace:
    """Times in microseconds on the profiler's clock."""

    def __init__(self, events: list[dict]):
        dev, host, ops, window = [], [], [], None
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            s = float(e["ts"])
            iv = (s, s + float(e["dur"]))
            if cat in DEVICE_CATS:
                dev.append((iv, name, cat))
            elif cat == "user_annotation" and name == WINDOW:
                window = iv
            elif cat == "user_annotation" and name == OP:
                ops.append(iv)
            elif cat in HOST_CATS:
                host.append((iv, name))
        if window is None:
            raise RuntimeError("the trace has no ecbench.window span")
        self.window = window
        self.device = [d for d in dev
                       if d[0][1] > window[0] and d[0][0] < window[1]]
        self.ops = _union(np.array(ops, dtype=np.float64).reshape(-1, 2))
        host.sort()
        self.host_starts = [h[0][0] for h in host]
        self.host = host

    def _device_iv(self, cats=DEVICE_CATS) -> np.ndarray:
        return np.array([d[0] for d in self.device if d[2] in cats],
                        dtype=np.float64).reshape(-1, 2)

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds in the window with any kernel or copy running."""
        w = np.array([self.window], dtype=np.float64)
        return _overlap(_union(self._device_iv()), w) / 1e6

    def busy_share(self, scope: np.ndarray) -> "float | None":
        """Share of the merged intervals `scope` with a kernel or copy
        running."""
        length = float(np.sum(scope[:, 1] - scope[:, 0])) if len(scope) \
            else 0.0
        if length <= 0 or not self.device:
            return None
        return _overlap(_union(self._device_iv()), scope) / length

    def kernel_s(self, scope: np.ndarray) -> float:
        """Seconds of kernels (not copies or memsets) inside `scope`."""
        return _overlap(_union(self._device_iv(("kernel",))), scope) / 1e6

    def window_scope(self) -> np.ndarray:
        return np.array([self.window], dtype=np.float64)

    def _host_at(self, t: float) -> str:
        """The innermost traced host event running at time t."""
        i = bisect.bisect_right(self.host_starts, t) - 1
        for j in range(i, max(-1, i - 256), -1):
            (s, e), name = self.host[j]
            if e >= t:
                return name
        return "host work with no traced torch op"

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps
        inside the operations' intervals summed by what the host was
        doing, in seconds."""
        by_op: dict[str, float] = defaultdict(float)
        for (s, e), name, _ in self.device:
            by_op[name[:120]] += (e - s) / 1e6
        busy = _union(self._device_iv())
        gaps: dict[str, float] = defaultdict(float)
        scope = self.ops if len(self.ops) else self.window_scope()
        for lo, hi in scope:
            t = lo
            k = int(np.searchsorted(busy[:, 1], lo)) if len(busy) else 0
            while t < hi:
                if k < len(busy) and busy[k, 0] <= t:
                    t = max(t, busy[k, 1])
                    k += 1
                    continue
                end = min(hi, busy[k, 0]) if k < len(busy) else hi
                if end > t:
                    gaps[self._host_at((t + end) / 2)] += (end - t) / 1e6
                t = end
        top = lambda d: [[n, v] for n, v in sorted(    # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}
