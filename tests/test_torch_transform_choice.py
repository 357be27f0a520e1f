"""The counted transform choice (codec/channel_transform.py: integer
gradient counts dotted with a log2 table) against the exact
gradient-entropy proxy it stands for.

  * every counted plane equals the matching channel of _FORWARD[t] on the
    proxy's subsample;
  * every counted cost lies within _tie_bound of _proxy_cost's, and the
    chosen id is the exact proxy's, on seeded photo-like images (the
    saturated-chroma corner too) with no fallback to the exact proxy;
  * an exact tie (R = G = B: SUBGREEN and YCOCG code the same planes)
    falls back to the exact proxy once, inside one
    frave.encode.transform.exact span, and picks what it picks.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from frave_tpu_torch.codec import channel_transform as CT
from frave_tpu_torch.testing import natural_image

# (h, w): the last one samples at _proxy_stride 2
SHAPES = [(64, 64), (96, 80), (256, 256), (768, 1024)]
CANDIDATES = {
    True: (CT.T_NONE, CT.T_SUBGREEN, CT.T_YCOCG),
    False: (CT.T_NONE, CT.T_SUBGREEN_CLAMPED),
}


def _image(h, w, saturated):
    px = natural_image(h, w, 3, seed=h + 3 * w)
    if saturated:
        px[: h // 4, : w // 4, 0] = 255  # where the mod-256 wraps cost
    return px


def test_the_large_shape_is_subsampled():
    assert CT._proxy_stride(*SHAPES[-1]) == 2


@pytest.mark.parametrize("lossless", [True, False])
@pytest.mark.parametrize("h,w", SHAPES)
def test_counted_planes_match_forward(h, w, lossless):
    px = _image(h, w, saturated=True)
    s = CT._proxy_stride(h, w)
    planes, cands = CT._candidate_planes(px, lossless)
    assert tuple(cands) == CANDIDATES[lossless]
    for t, ix in cands.items():
        ref = CT._FORWARD[t](px)[::s, ::s]
        for k, i in enumerate(ix):
            np.testing.assert_array_equal(planes[i], ref[:, :, k], err_msg=f"{t} {k}")


@pytest.mark.parametrize("lossless", [True, False])
@pytest.mark.parametrize("saturated", [False, True])
@pytest.mark.parametrize("h,w", SHAPES)
def test_counted_choice_is_the_exact_proxy_choice(h, w, saturated, lossless):
    px = _image(h, w, saturated)
    before = CT.exact_fallbacks
    costs, n_terms = CT._counted_costs(px, lossless)
    bound = CT._tie_bound(n_terms)
    for t, q in costs.items():
        p = CT._proxy_cost(CT._FORWARD[t](px))
        assert abs(q - p) <= bound * p, (t, q, p)
    assert CT.select_transform(px, lossless) == CT._proxy_choice(px, CANDIDATES[lossless])
    assert CT.exact_fallbacks == before


def test_an_exact_tie_falls_back_to_the_exact_proxy():
    g = natural_image(96, 80, 1, seed=7)
    px = np.repeat(g, 3, axis=2)  # R = G = B: SUBGREEN's planes are YCOCG's
    costs, _ = CT._counted_costs(px, True)
    assert costs[CT.T_SUBGREEN] == costs[CT.T_YCOCG] < costs[CT.T_NONE]
    before = CT.exact_fallbacks
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = CT.select_transform(px, True)
    assert got == CT._proxy_choice(px, CANDIDATES[True]) == CT.T_SUBGREEN
    assert CT.exact_fallbacks == before + 1
    spans = Counter(e.name for e in prof.events() if e.name.startswith("frave."))
    assert spans == {"frave.encode.transform.exact": 1}
