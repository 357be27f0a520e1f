"""What decides `correct`: the program's outputs, after the window has
closed, compared as the configuration's guarantees ask.

A configuration names its comparison in "judge": {"kind": ...}; the
comparison is `judge(...)` in judges/<kind>.py, found by name, so a
configuration with other guarantees (a lossy preset held to its error)
brings its own file. This module holds what every comparison shares.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .loop import Sample
from .manifest import load_judge
from .pool import SEED_MASK


def px_wrong(out, ref: np.ndarray) -> int:
    """Pixels (samples) of `out` that differ from `ref`; all of them where
    `out` is missing or of another shape."""
    if out is None:
        return int(ref.size)
    out = np.asarray(out)
    if out.size != ref.size:
        return int(ref.size)
    return int(np.count_nonzero(out.reshape(ref.shape) != ref))


def reference_sample(samples: List[Sample], n: int, seed: int) -> List[Sample]:
    """The largest container and n - 1 more drawn from the seed."""
    if not samples:
        return []
    largest = max(range(len(samples)), key=lambda i: len(samples[i].blob))
    rest = [i for i in range(len(samples)) if i != largest]
    rng = np.random.default_rng([seed & SEED_MASK, 3])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if n > 1 else []
    return [samples[largest]] + [samples[rest[int(i)]] for i in sorted(pick)]


def judge(config: dict, pool, samples: List[Sample], missing: int, seed: int,
          control: bool = False) -> dict:
    """{name: {"value": v, "limit": l}} for every number compared, by the
    configuration's comparison. With `control`, the comparison's control
    stands in for the program's outputs."""
    return load_judge(config["judge"]["kind"]).judge(config, pool, samples, missing, seed,
                                                     control)


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
