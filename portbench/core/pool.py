"""The input pool of a run, made on the host from --seed.

`natural_image` is a copy of the port's seeded test content
(frave_tpu_torch/testing.py), so that the yardstick does not move when
the program's test helpers do.
"""

from __future__ import annotations

import numpy as np

SEED_MASK = (1 << 64) - 1


def _light_and_edges(h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    light = 110 + 60 * np.sin(xx / 97.0 + 0.7) * np.cos(yy / 73.0)
    edges = 40.0 * ((xx + 0.6 * yy) % 181 < 90) - 25.0 * ((yy - 0.3 * xx) % 127 < 40)
    return light + edges


def natural_image(h: int, w: int, c: int, seed, light_edges=None) -> np.ndarray:
    """Seeded photo-like content: smooth illumination, edges, a
    random-walk texture and sensor noise, channels correlated as in RGB
    photographs. [h, w, c] uint8. `light_edges`, the seed-free part of a
    shape, may be passed in to be made once for many images."""
    rng = np.random.default_rng(seed)
    if light_edges is None:
        light_edges = _light_and_edges(h, w)
    texture = np.cumsum(rng.normal(0, 1.2, (h, w)), axis=1)
    texture -= texture.mean(axis=1, keepdims=True)
    base = light_edges + texture
    planes = []
    for k in range(c):
        gain = (1.0, 0.92, 0.81)[k]
        offset = (0.0, 8.0, -12.0)[k]
        planes.append(gain * base + offset + rng.normal(0, 2.0, (h, w)))
    return np.clip(np.stack(planes, axis=-1), 0, 255).astype(np.uint8)


def make_pool(config: dict, seed: int) -> list:
    """config["pool_images"] images of the configuration's shape; image i
    is natural_image seeded by (seed, i), so the same seed gives the same
    pool and every seed the same sizes."""
    h, w, c = config["height"], config["width"], config["channels"]
    le = _light_and_edges(h, w)
    return [natural_image(h, w, c, [seed & SEED_MASK, i], le)
            for i in range(config["pool_images"])]


def request_order(n: int, seed: int) -> np.ndarray:
    """A seeded permutation of the pool, visited cyclically by a request
    loop: every seed sends every image once a cycle, in its own order."""
    return np.random.default_rng([seed & SEED_MASK, n, 1]).permutation(n)
