"""The comparison of a lossless configuration: every number is an exact
count with the limit 0.

- missing_outputs: images of the window that came back without a
  container or without pixels (a call that raised counts all of its);
- decoded_px_wrong: over the kept sample of the window's decodes, the
  pixels that differ from the input the benchmark made;
- container_px_wrong: over a seeded sample of the kept containers, with
  the largest among them, the pixels that differ from the input when the
  plain reference (reference/decode.py) decodes the container (one it
  cannot parse counts all of its pixels).

The control puts the reference, computed with float16 contexts (the
precision below the format's float32), in the place of the program's
decodes of the reference's sample.
"""

import sys
import time

import numpy as np

from portbench.core.judge import px_wrong, reference_sample
from portbench.reference import decode as reference

LIMITS = {"missing_outputs": 0, "decoded_px_wrong": 0, "container_px_wrong": 0}


def reference_px_wrong(blob: bytes, ref: np.ndarray, ctx_dtype=np.float32) -> int:
    try:
        out = reference.decode(blob, ctx_dtype)
    except Exception as exc:  # noqa: BLE001 -- an unparsable container is a wrong one
        print(f"reference: container refused: {type(exc).__name__}: {exc}", file=sys.stderr)
        return int(ref.size)
    return px_wrong(out, ref)


def judge(config, pool, samples, missing: int, seed: int, control: bool = False) -> dict:
    if config["guarantees"].get("lossless") is not True:
        raise ValueError(f"{config['name']}: the lossless comparison needs a lossless guarantee")
    t0 = time.perf_counter()
    chosen = reference_sample(samples, config["judge"]["reference_decodes"], seed)
    if control:
        decoded_wrong = sum(reference_px_wrong(s.blob, pool[s.index], np.float16) for s in chosen)
    else:
        decoded_wrong = sum(px_wrong(s.decoded, pool[s.index]) for s in samples)
    container_wrong = sum(reference_px_wrong(s.blob, pool[s.index]) for s in chosen)
    print(f"reference: {len(chosen)} containers of {len(samples)} kept decoded in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    values = {"missing_outputs": missing, "decoded_px_wrong": decoded_wrong,
              "container_px_wrong": container_wrong}
    if not samples:
        values["missing_outputs"] = max(missing, 1)  # nothing to judge is no pass
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}
