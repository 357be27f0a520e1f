"""In-memory metrics sink: the port's copy of frave_tpu/metrics.py.

Scalars and arrays recorded by name, thread-safe, optionally echoed
(verbose). The encode records encode/bpp an image; under
EncoderOptions.verbose or emit_coefficients the per-context entropies,
and under emit_coefficients the per-context symbol histograms; the
predictor search of the CLI reads encode/mean_abs_residual_ch{c}.
profiling.stage_timer and pipeline_torch.StageTimes record stage wall
times (seconds) here.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._scalars: Dict[str, List[float]] = defaultdict(list)
        self._series: Dict[str, List[Any]] = defaultdict(list)
        self.verbose = False

    def record(self, name: str, value: float) -> None:
        with self._lock:
            self._scalars[name].append(float(value))
        if self.verbose:
            print(f"[frave] {name} = {value}")

    def record_array(self, name: str, value) -> None:
        """Bulk payloads (histograms)."""
        with self._lock:
            self._series[name].append(value)

    def last(self, name: str) -> Optional[float]:
        with self._lock:
            v = self._scalars.get(name)
            return v[-1] if v else None

    def mean(self, name: str) -> Optional[float]:
        with self._lock:
            v = self._scalars.get(name)
            return sum(v) / len(v) if v else None

    def arrays(self, name: str) -> List[Any]:
        with self._lock:
            return list(self._series.get(name, []))

    def snapshot(self) -> Dict[str, List[float]]:
        with self._lock:
            return {k: list(v) for k, v in self._scalars.items()}

    def reset(self) -> None:
        with self._lock:
            self._scalars.clear()
            self._series.clear()

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)


_global = Metrics()


def get_metrics() -> Metrics:
    return _global
