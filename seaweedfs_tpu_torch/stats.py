"""Prometheus text exposition for the port's codec metrics.

The same format as seaweedfs_tpu's metric registry (counters and
histograms with label sets, the 0.0.4 text page, and the OpenMetrics form
with bucket exemplars when `render(exemplars=True)`), so a volume server's
GET /metrics can append `codec_metrics().registry.render(...)` to its own
page whichever package computes the codes.
"""

from __future__ import annotations

import bisect
import itertools
import threading
from collections import defaultdict

_BUCKETS = [0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0]


def escape_label_value(value) -> str:
    """Backslash, double quote and newline escaped, as the text format's
    label values need."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(label_names: list, labels: tuple) -> str:
    return ",".join(f'{n}="{escape_label_value(v)}"'
                    for n, v in zip(label_names, labels))


def _fmt_exemplar(ex: "tuple[str, float] | None") -> str:
    """OpenMetrics exemplar suffix of a bucket line:
    ` # {trace_id="..."} <value>`."""
    if ex is None:
        return ""
    tid, value = ex
    return f' # {{trace_id="{escape_label_value(tid)}"}} {value}'


class Counter:
    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._values: dict[tuple, float] = defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, *labels, value: float = 1.0) -> None:
        with self._lock:
            self._values[labels] += value

    def value(self, *labels) -> float:
        return self._values.get(labels, 0.0)

    def render(self, label_names: list[str],
               exemplars: bool = False) -> str:
        """With `exemplars` (the OpenMetrics page) the family is named
        without its `_total` suffix and the samples keep it; the 0.0.4 page
        names both with it."""
        fam = sample = self.name
        if exemplars:
            fam = fam[:-len("_total")] if fam.endswith("_total") else fam
            sample = fam + "_total"
        out = [f"# HELP {fam} {self.help}", f"# TYPE {fam} counter"]
        with self._lock:
            items = sorted(self._values.items())
        for labels, v in items:
            sel = _fmt_labels(label_names, labels)
            out.append(f"{sample}{{{sel}}} {v}" if sel else f"{sample} {v}")
        return "\n".join(out)


class Histogram:
    def __init__(self, name: str, help_text: str,
                 buckets: "list[float] | None" = None):
        self.name = name
        self.help = help_text
        self.buckets = buckets or _BUCKETS
        # labels -> observations per bucket, each counted once, in the
        # first bucket that holds it (the page's counts are cumulative)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = defaultdict(float)
        self._totals: dict[tuple, int] = defaultdict(int)
        # labels -> {bucket index: (trace id, value)}, the last exemplar of
        # each bucket; index len(buckets) is +Inf
        self._exemplars: dict[tuple, dict[int, tuple[str, float]]] = {}
        self._lock = threading.Lock()

    def observe(self, *labels, value: float, trace_id: str = "") -> None:
        bucket_idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            counts = self._counts.setdefault(
                labels, [0] * (len(self.buckets) + 1))
            counts[bucket_idx] += 1
            self._sums[labels] += value
            self._totals[labels] += 1
            if trace_id:
                self._exemplars.setdefault(labels, {})[bucket_idx] = \
                    (trace_id, value)

    def render(self, label_names: list[str],
               exemplars: bool = False) -> str:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            items = [(labels, list(itertools.accumulate(counts[:-1])),
                      self._sums[labels],
                      self._totals[labels],
                      dict(self._exemplars.get(labels, {}))
                      if exemplars else {})
                     for labels, counts in sorted(self._counts.items())]
        for labels, counts, label_sum, label_total, exes in items:
            base = _fmt_labels(label_names, labels)
            for i, (b, c) in enumerate(zip(self.buckets, counts)):
                sel = (base + "," if base else "") + f'le="{b}"'
                out.append(f"{self.name}_bucket{{{sel}}} {c}"
                           + _fmt_exemplar(exes.get(i)))
            sel_inf = (base + "," if base else "") + 'le="+Inf"'
            out.append(f"{self.name}_bucket{{{sel_inf}}} {label_total}"
                       + _fmt_exemplar(exes.get(len(self.buckets))))
            sfx = f"{{{base}}}" if base else ""
            out.append(f"{self.name}_sum{sfx} {label_sum}")
            out.append(f"{self.name}_count{sfx} {label_total}")
        return "\n".join(out)


class Registry:
    def __init__(self):
        self._metrics: list[tuple[object, list[str]]] = []
        self._lock = threading.Lock()

    def counter(self, name: str, help_text: str,
                label_names: "list[str] | None" = None) -> Counter:
        c = Counter(name, help_text)
        with self._lock:
            self._metrics.append((c, label_names or []))
        return c

    def histogram(self, name: str, help_text: str,
                  label_names: "list[str] | None" = None,
                  buckets: "list[float] | None" = None) -> Histogram:
        h = Histogram(name, help_text, buckets=buckets)
        with self._lock:
            self._metrics.append((h, label_names or []))
        return h

    def render(self, exemplars: bool = False) -> str:
        with self._lock:
            return "\n".join(m.render(names, exemplars=exemplars)
                             for m, names in self._metrics) + "\n"
