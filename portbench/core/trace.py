"""Reading a torch.profiler Chrome trace: device busy time, idle shares
within the benchmark's own spans, kernel time by name, and the
breakdown of the device's operations and of its idle gaps.

Times in a trace are microseconds; the host's and the device's events
share one clock. The benchmark marks its units with record_function
spans named "portbench.<kind>" (user annotations in the trace).
"""

from __future__ import annotations

import json

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function", "user_annotation")
SPAN_PREFIX = "portbench."
NAME_CHARS = 120


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Trace:
    def __init__(self, events):
        self.device = []  # (start, end, name)
        host = []  # (start, end, name)
        self.spans = {}  # span name -> [(start, end)]
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append((a, b, e.get("name", "")))
            elif cat in HOST_CATS:
                name = e.get("name", "")
                if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
                    self.spans.setdefault(name, []).append((a, b))
                else:
                    host.append((a, b, name))
        self.busy = merge((a, b) for a, b, _ in self.device)
        self._busy_a = np.array([a for a, _ in self.busy], dtype=np.float64)
        self._busy_b = np.array([b for _, b in self.busy], dtype=np.float64)
        self._host = host
        self._host_a = np.array([a for a, _, _ in host], dtype=np.float64)
        self._host_b = np.array([b for _, b, _ in host], dtype=np.float64)

    @classmethod
    def from_file(cls, path) -> "Trace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    def window(self):
        """(start, end) of the "portbench.window" span."""
        (w,) = self.spans[SPAN_PREFIX + "window"]
        return w

    def busy_us(self, a: float, b: float) -> float:
        """Microseconds of [a, b] in which some operation ran on the device."""
        if b <= a or not self.busy:
            return 0.0
        lo = np.clip(self._busy_a, a, b)
        hi = np.clip(self._busy_b, a, b)
        return float((hi - lo).sum())

    def idle_pct(self, spans) -> float:
        """The share of the spans' time in which nothing ran on the device."""
        total = sum(b - a for a, b in spans)
        if total <= 0:
            raise ValueError("no span time")
        return 100.0 * (1.0 - sum(self.busy_us(a, b) for a, b in spans) / total)

    def device_us(self, substrings, a=None, b=None) -> float:
        """The device time of the operations whose name holds any of
        `substrings`, within [a, b] (the whole trace by default)."""
        a = -np.inf if a is None else a
        b = np.inf if b is None else b
        return sum(min(e, b) - max(s, a) for s, e, n in self.device
                   if s < b and e > a and any(k in n for k in substrings))

    def top_device_ops(self, n: int = 10):
        """[[name, seconds], ...]: the device operations that took most time."""
        tot = {}
        for a, b, name in self.device:
            key = name[:NAME_CHARS]
            tot[key] = tot.get(key, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, a: float, b: float, n: int = 10, longest: int = 400):
        """[[what the host was doing, seconds], ...]: the device's idle time
        within [a, b], of its `longest` gaps, summed by the innermost host
        event over each gap's midpoint and the benchmark span around it."""
        gaps = []  # (length, midpoint)
        prev = a
        for s, e in self.busy:
            if e <= a:
                continue
            if s >= b:
                break
            if s > prev:
                gaps.append((s - prev, 0.5 * (prev + s)))
            prev = max(prev, e)
        if b > prev:
            gaps.append((b - prev, 0.5 * (prev + b)))
        gaps.sort(reverse=True)
        tot = {}
        for length, mid in gaps[:longest]:
            key = f"{self._span_at(mid)}: {self._host_at(mid)}"
            tot[key] = tot.get(key, 0.0) + length * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def _span_at(self, t: float) -> str:
        best = None
        for name, ivs in self.spans.items():
            if name == SPAN_PREFIX + "window":
                continue
            for a, b in ivs:
                if a <= t <= b and (best is None or b - a < best[0]):
                    best = (b - a, name[len(SPAN_PREFIX):])
        return best[1] if best else "between units"

    def _host_at(self, t: float) -> str:
        if not self._host:
            return "host python"
        hit = np.nonzero((self._host_a <= t) & (self._host_b >= t))[0]
        if hit.size == 0:
            return "host python"
        i = hit[np.argmin(self._host_b[hit] - self._host_a[hit])]
        return self._host[i][2][:NAME_CHARS]
