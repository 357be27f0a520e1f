"""Seeded test content shared by chip_smoke.py and tests/make_torch_refs.py.

Imports numpy only, so the script that writes the reference hashes (which
runs frave_tpu) and the smoke on the card (which must not) make the very
same pixels.
"""

from __future__ import annotations

import numpy as np

# label -> (height, width, channels, seed, presets, mode) of every image
# whose pinned-parameter container hash tests/data/torch_port_refs.json
# keeps (the step-tensor modes' labels name their mode)
REF_IMAGES = {
    "256x256 gray": (256, 256, 1, 1, ("LOSSLESS",), "grid"),
    "768x512 RGB": (512, 768, 3, 2, ("LOSSLESS", "HIGH"), "grid"),
    "512x512 gray": (512, 512, 1, 3, ("HIGH", "MEDIUM", "LOW"), "grid"),
    "2048x2048 RGB": (2048, 2048, 3, 4, ("LOSSLESS",), "grid"),
    "2048x2048 RGB parallel": (2048, 2048, 3, 4, ("LOSSLESS",), "parallel"),
    "768x512 RGB parity": (512, 768, 3, 2, ("LOSSLESS",), "parity"),
    "256x256 gray parity": (256, 256, 1, 1, ("LOSSLESS",), "parity"),
    "64x64 gray parallel": (64, 64, 1, 5, ("LOSSLESS",), "parallel"),
}


def natural_image(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Seeded photo-like content: smooth illumination, edges, a
    random-walk texture and sensor noise, channels correlated as in RGB
    photographs. [h, w, c] uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    light = 110 + 60 * np.sin(xx / 97.0 + 0.7) * np.cos(yy / 73.0)
    edges = 40.0 * ((xx + 0.6 * yy) % 181 < 90) - 25.0 * ((yy - 0.3 * xx) % 127 < 40)
    texture = np.cumsum(rng.normal(0, 1.2, (h, w)), axis=1)
    texture -= texture.mean(axis=1, keepdims=True)
    base = light + edges + texture
    planes = []
    for k in range(c):
        gain = (1.0, 0.92, 0.81)[k]
        offset = (0.0, 8.0, -12.0)[k]
        planes.append(gain * base + offset + rng.normal(0, 2.0, (h, w)))
    return np.clip(np.stack(planes, axis=-1), 0, 255).astype(np.uint8)
