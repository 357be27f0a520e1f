"""The arithmetic of the end-to-end metrics and of the spread between runs."""

from __future__ import annotations

import statistics


def rate(work: float, seconds: float) -> float:
    """All the work of a window over all of its time."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return work / seconds


def percentile(values, q: int) -> float:
    """The q-th percentile of every value (linear between the two nearest
    ranks, as numpy's default)."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    if len(vals) == 1:
        return float(vals[0])
    return float(statistics.quantiles(vals, n=100, method="inclusive")[q - 1])


def beyond(values, q: int) -> int:
    """How many values lie above the q-th percentile: the samples that the
    tail rests on."""
    p = percentile(values, q)
    return sum(1 for v in values if v > p)


def spread(values) -> float:
    """The distance between the first and the third quartile over the
    median (statistics.quantiles' default method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def bits_per_pixel(container_bytes: int, pixels: int) -> float:
    """Container bits over pixel positions (an RGB pixel counts once)."""
    return 8.0 * container_bytes / pixels
