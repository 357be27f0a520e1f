"""What every traffic loop shares: the pool, the seeded order, the work
done and failed, the outputs kept for the judge, the timed window and
the spans pass.

A traffic mix (traffic/<mix>.json) names its loop in "loop"; the loop is
the class `Loop` of loops/<loop>.py, a subclass of `BaseLoop` that
defines `unit` (one closed-loop step: a stream call, a request pair) and
`values` (the end-to-end metrics it has). A new kind of traffic is a new
file there, and the harness finds it by name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import sys
import time
import traceback
from typing import List, Optional

import numpy as np

from . import stats
from .pool import SEED_MASK, request_order

MIN_UNITS = 2  # units of the spans pass and of the profiled pass, at least


@dataclasses.dataclass
class Sample:
    """One output kept for the judge."""

    index: int  # pool index of the input
    blob: bytes
    decoded: Optional[np.ndarray]  # [h, w, c] uint8, None where none came


@dataclasses.dataclass
class Batch:
    """One decode batch of the profiled pass, as kernels/<family>.py counts
    its work: the pool indices of its inputs and their containers."""

    indices: List[int]
    blobs: List[bytes]


@dataclasses.dataclass
class Unit:
    """One encode or decode call of the spans pass."""

    kind: str  # "encode" or "decode": one batch, or one request
    wall_ms: float  # host wall of the call, until its bytes or pixels are on the host
    stages: dict  # the program's StageTimes of the call: stage -> ms


def no_span(name):
    return contextlib.nullcontext()


class BaseLoop:
    ORDERED = False  # next_indices in the seed's order rather than the pool's

    def __init__(self, prog, pool: List[np.ndarray], seed: int):
        self.prog, self.pool, self.seed = prog, pool, seed
        self.traffic = prog.traffic
        self.rasters = [prog.raster(a) for a in pool]
        self.order = request_order(len(pool), seed)
        self.keep_rng = np.random.default_rng([seed & SEED_MASK, 2])
        self.cursor = 0
        self.samples: List[Sample] = []
        self.captured: Optional[List[Batch]] = None  # decode batches, while profiling
        self.logged_error = False
        self.reset()

    def reset(self):
        """Forget the work done so far (the warm-up's), not the cursor."""
        self.attempted = self.failed = 0
        self.pixels = self.container_bytes = 0

    # to be defined by each loop
    def unit(self, keep: bool = True, span=None):
        raise NotImplementedError

    def values(self, window_s: float) -> dict:
        """The end-to-end metrics this loop has, besides setup_s and bpp."""
        raise NotImplementedError

    def latency_lines(self) -> List[str]:
        return []

    # shared
    def next_indices(self, n: int) -> List[int]:
        """The next n pool indices: the pool in order, cyclically, or (where
        the loop is ORDERED) in the seed's order, every image once a cycle."""
        k = len(self.pool)
        idx = [int(self.order[(self.cursor + j) % k]) if self.ORDERED else (self.cursor + j) % k
               for j in range(n)]
        self.cursor += n
        return idx

    def fail(self, n: int):
        self.failed += n
        if not self.logged_error:  # the first failure's traceback, once
            self.logged_error = True
            print(traceback.format_exc(), file=sys.stderr)

    def done(self, idx: List[int], blobs: List[bytes]):
        """Count the images of `idx` whose containers came, and their bytes."""
        h, w = self.prog.config["height"], self.prog.config["width"]
        self.pixels += len(blobs) * h * w
        self.container_bytes += sum(len(b) for b in blobs)
        if self.captured is not None:
            bs = self.traffic["batch_size"]
            for b0 in range(0, len(blobs), bs):
                self.captured.append(Batch(idx[b0:b0 + bs], list(blobs[b0:b0 + bs])))

    def bpp(self) -> dict:
        if not self.pixels:
            return {}
        return {"bpp": stats.bits_per_pixel(self.container_bytes, self.pixels)}

    def run_for(self, seconds: float, span=None, min_units: int = 1) -> float:
        """Units until `seconds` have passed and at least `min_units` ran;
        returns the seconds they took. The window closes at the end of the
        first unit that ends past `seconds`, so a rate is all the work over
        all the time and a tail is over every request."""
        t0 = time.perf_counter()
        n = 0
        while True:
            self.unit(span=span)
            n += 1
            if n >= min_units and time.perf_counter() - t0 >= seconds:
                return time.perf_counter() - t0

    def staged_units(self, seconds: float) -> List[Unit]:
        """The spans pass: the loop's images through the program's batch
        calls with StageTimes, unpipelined: batch_size images encoded, then
        their containers decoded, batch after batch."""
        bs = self.traffic["batch_size"]
        units: List[Unit] = []
        t_end = time.perf_counter() + seconds
        n = 0
        while n < MIN_UNITS or time.perf_counter() < t_end:
            n += 1
            idx = self.next_indices(bs)
            self.attempted += len(idx)
            try:
                self.prog.sync()
                t0 = time.perf_counter()
                blobs, est = self.prog.encode_staged([self.rasters[i] for i in idx])
                t1 = time.perf_counter()
                outs, dst = self.prog.decode_staged(blobs)
                t2 = time.perf_counter()
            except Exception:  # noqa: BLE001 -- a failed call is counted, the pass goes on
                self.fail(len(idx))
                continue
            units += [Unit("encode", (t1 - t0) * 1e3, est), Unit("decode", (t2 - t1) * 1e3, dst)]
            done = min(len(blobs), len(outs))
            self.failed += len(idx) - done
            if done:
                j = int(self.keep_rng.integers(done))
                self.samples.append(Sample(idx[j], blobs[j], np.array(outs[j])))
        return units


def latency_line(name: str, ms: List[float]) -> str:
    """Count, median and p95 of a unit's times, and the medians of the
    window's four quarters (drift within a run against spread between runs)."""
    q = max(1, len(ms) // 4)
    quarters = [round(statistics.median(ms[k * q:(k + 1) * q]), 3) for k in range(4)
                if ms[k * q:(k + 1) * q]]
    return (f"{name}: n={len(ms)} median_ms={statistics.median(ms)!r} "
            f"p95_ms={stats.percentile(ms, 95)!r} beyond_p95={stats.beyond(ms, 95)} "
            f"quarter_medians_ms={quarters}")
