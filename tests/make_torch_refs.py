#!/usr/bin/env python3
"""Write tests/data/torch_port_refs.json: the reference containers that
chip_smoke.py holds the port's card encodes against, byte for byte.

    JAX_PLATFORMS=cpu python3 tests/make_torch_refs.py [LABEL ...]

For every image and preset of frave_tpu_torch.testing.REF_IMAGES (or
only those of the labels given, the file's other entries kept as they
are), in the image's mode,
frave_tpu's jax backend (the one the port matches byte for byte,
including the empty contexts' scale rows) encodes the seeded image, then
encodes it again with that fit and lane count pinned. The JSON keeps the
pinned parameters, the pinned container's length and SHA-256, and each
context's (max_freq_bits, scale index), so that a mismatch on the card
can be read context by context. Each 2048x2048 RGB entry takes a few
minutes on a CPU (two full-size jax encodes); the rest well under one.

tests/test_torch_hostmods.py re-encodes the 256x256 gray entry with
reference_entry and compares, so the committed hashes cannot drift from
the reference.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

OUT = os.path.join(HERE, "data", "torch_port_refs.json")


def reference_entry(label: str, quality: str) -> dict:
    """The JSON entry of one image (frave_tpu_torch.testing.REF_IMAGES)
    at one preset, from two jax-backend encodes."""
    import frave_tpu
    from frave_tpu.codec.container import deserialize

    from frave_tpu_torch.testing import REF_IMAGES, natural_image

    h, w, c, seed, _, mode = REF_IMAGES[label]
    px = natural_image(h, w, c, seed)
    q = frave_tpu.EncoderQuality[quality]
    ci = deserialize(frave_tpu.encode(
        px, frave_tpu.EncoderOptions(backend="jax", quality=q, mode=mode)))
    vp = np.stack([ci.channel_data[k].value_prediction_parameters for k in range(c)])
    wp = np.stack([ci.channel_data[k].width_prediction_parameters for k in range(c)])
    pinned = frave_tpu.EncoderOptions(
        backend="jax", quality=q, mode=mode, num_lanes=ci.num_lanes,
        value_prediction_params=vp, width_prediction_params=wp,
    )
    blob = frave_tpu.encode(px, pinned)
    cp = deserialize(blob)
    return {
        "label": label,
        "quality": quality,
        "mode": mode,
        "shape": [h, w, c],
        "seed": seed,
        "num_lanes": int(ci.num_lanes),
        "transform": int(cp.transform),
        "value_prediction_params": vp.astype(np.float32).tolist(),
        "width_prediction_params": wp.astype(np.float32).tolist(),
        "length": len(blob),
        "sha256": hashlib.sha256(blob).hexdigest(),
        "contexts": [
            [[int(t.max_freq_bits), int(t.scale_idx)] for t in cp.channel_data[k].ans_contexts]
            for k in range(c)
        ],
    }


def main(labels) -> int:
    from frave_tpu_torch.testing import REF_IMAGES

    unknown = sorted(set(labels) - set(REF_IMAGES))
    if unknown:
        raise SystemExit(f"unknown labels {unknown}; REF_IMAGES has {sorted(REF_IMAGES)}")
    old = {}
    if labels:
        old = {(e["label"], e["quality"]): e for e in json.load(open(OUT))["entries"]}
    entries = []
    for label, (_, _, _, _, presets, _) in REF_IMAGES.items():
        for quality in presets:
            if labels and label not in labels:
                entries.append(old[(label, quality)])
                continue
            entries.append(reference_entry(label, quality))
            print(f"{label} {quality}: {entries[-1]['length']} B {entries[-1]['sha256']}")
    with open(OUT, "w") as f:
        json.dump({"backend": "jax", "entries": entries}, f, indent=1)
        f.write("\n")
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
