"""The comparison of a lossy configuration: every number is an exact count
with the limit 0, against the decode the preset guarantees,
clip(inverse_lift(dequantize(quantize(forward_lift(input))))) through the
preset's per-layer table (reference/quantization.py). The entropy stages
are lossless on the quantized plane, so that decode is fixed by the input
and the table, and a program that quantized harder (fewer bits) fails.

- missing_outputs: images of the window that came back without a
  container or without pixels (a call that raised counts all of its);
- matrix_wrong: kept containers whose quantization matrix differs from
  the benchmark's own copy of the configuration's preset table (one that
  cannot be parsed counts);
- decoded_px_wrong: over every kept decode of the window, the pixels
  that differ from the guaranteed decode of its input (worked out once
  for each input kept);
- container_px_wrong: over a seeded sample of the kept containers, with
  the largest among them, the pixels where the plain reference
  (reference/decode_lossy.py) decodes the container otherwise (one it
  cannot parse counts all of its pixels).

The guaranteed decode is of a plane coded without a channel transform,
so the configuration is gray, or RGB with the transform "none".

The control puts the reference, computed with float16 contexts (the
precision below the format's float32), in the place of the program's
decodes of the reference's sample.
"""

import sys
import time

import numpy as np

from portbench.core.judge import px_wrong, reference_sample
from portbench.reference import container
from portbench.reference import decode_lossy as reference
from portbench.reference.quantization import expected_round_trip, quantization_matrix

LIMITS = {"missing_outputs": 0, "matrix_wrong": 0, "decoded_px_wrong": 0,
          "container_px_wrong": 0}


def reference_px_wrong(blob: bytes, ref: np.ndarray, ctx_dtype=np.float32) -> int:
    try:
        out = reference.decode(blob, ctx_dtype)
    except Exception as exc:  # noqa: BLE001 -- an unparsable container is a wrong one
        print(f"reference: container refused: {type(exc).__name__}: {exc}", file=sys.stderr)
        return int(ref.size)
    return px_wrong(out, ref)


def matrix_differs(blob: bytes, want: np.ndarray) -> bool:
    try:
        qm = container.deserialize(blob).quantization_matrix
    except Exception:  # noqa: BLE001 -- an unparsable container has no right matrix
        return True
    return qm is None or not np.array_equal(np.asarray(qm, dtype=np.int64), want)


def judge(config, pool, samples, missing: int, seed: int, control: bool = False) -> dict:
    if config["guarantees"].get("lossless") is not False:
        raise ValueError(f"{config['name']}: the lossy comparison needs a lossy guarantee")
    if config["channels"] != 1 and config["color_transform"] != "none":
        raise ValueError(f"{config['name']}: the guaranteed decode is of planes coded "
                         "without a channel transform")
    preset = config["quality"]
    want = quantization_matrix(preset).astype(np.int64)
    if config["guarantees"]["quantization_matrix"] != want.tolist():
        raise ValueError(f"{config['name']}: the guaranteed matrix is not {preset}'s table")
    t0 = time.perf_counter()
    expected = {}

    def expect(i: int) -> np.ndarray:
        if i not in expected:
            expected[i] = expected_round_trip(pool[i], preset)
        return expected[i]

    chosen = reference_sample(samples, config["judge"]["reference_decodes"], seed)
    if control:
        decoded_wrong = sum(reference_px_wrong(s.blob, expect(s.index), np.float16)
                            for s in chosen)
    else:
        decoded_wrong = sum(px_wrong(s.decoded, expect(s.index)) for s in samples)
    container_wrong = sum(reference_px_wrong(s.blob, expect(s.index)) for s in chosen)
    matrix_wrong = sum(matrix_differs(s.blob, want) for s in samples)
    print(f"reference: {len(expected)} round trips through {preset}'s table, {len(chosen)} "
          f"containers of {len(samples)} kept decoded in {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
    values = {"missing_outputs": missing, "matrix_wrong": matrix_wrong,
              "decoded_px_wrong": decoded_wrong, "container_px_wrong": container_wrong}
    if not samples:
        values["missing_outputs"] = max(missing, 1)  # nothing to judge is no pass
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}
