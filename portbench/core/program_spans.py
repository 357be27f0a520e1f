"""Reading the program's own spans from the profiled pass's trace.

frave_tpu_torch marks its host steps with record_function spans named
"frave.<side>.<step>", one a batch or call, on the profiler's clock; the
benchmark marks its units with "portbench.<kind>" spans (core/trace.py).
The readers here sum, within each unit, the union of the intervals of the
named program spans, so a span nested in another, or two that overlap,
count each microsecond once.

The profiled pass records the thread that runs the loop alone, so every
program span read here is the caller's: the stream's dispatches and its
waits for its worker threads, and each whole single-image request. A
program without these spans leaves them out of the trace, and every
reader then returns None.
"""

from __future__ import annotations

import statistics

from .trace import SPAN_PREFIX, merge


def program_intervals(trace, names):
    """The (start, end) of every program span whose name is in `names`
    (the trace keeps them among its host events)."""
    return [(a, b) for a, b, n in trace._host if n in names]


def covered_us(union, a: float, b: float) -> float:
    """Microseconds of [a, b] under `union`, sorted disjoint intervals."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in union)


def unit_ms(ctx, kind: str, names):
    """[ms] a "portbench.<kind>" unit under the union of the program spans
    `names`; None where the trace holds no such unit or no such span."""
    if ctx.trace is None:
        return None
    units = ctx.trace.spans.get(SPAN_PREFIX + kind, [])
    ivs = program_intervals(ctx.trace, set(names))
    if not units or not ivs:
        return None
    union = merge(ivs)
    return [covered_us(union, a, b) * 1e-3 for a, b in units]


def request_ms(ctx, kind: str, names):
    """Median over the "portbench.<kind>" requests of their time under the
    program spans `names` (ms)."""
    vals = unit_ms(ctx, kind, names)
    return statistics.median(vals) if vals else None


def batch_ms(ctx, names):
    """The time under the program spans `names` in the "portbench.call"
    stream calls over the batches they ran (ms a batch)."""
    vals = unit_ms(ctx, "call", names)
    if not vals:
        return None
    return sum(vals) / (len(vals) * ctx.traffic["batches_per_call"])
