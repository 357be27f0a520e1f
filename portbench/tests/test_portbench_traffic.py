"""The pool and both traffic generators are functions of the seed alone."""

import numpy as np
import pytest

from portbench.core import manifest as M
from portbench.core.pool import make_pool, natural_image, request_order

BIG = 2**31 + 987654321  # seeds run past 32 signed bits


class _StubProgram:
    def __init__(self, config, traffic):
        self.config, self.traffic = config, traffic

    def raster(self, arr):
        return arr


def _config(name, pool=6):
    cfg = dict(M.load_config(name))
    cfg["pool_images"] = pool
    cfg["height"], cfg["width"] = 24, 40
    return cfg


@pytest.mark.parametrize("config", ["tiles256_gray", "kodak_shape_rgb"])
def test_pool_is_the_seeds(config):
    cfg = _config(config)
    a, b, c = make_pool(cfg, BIG), make_pool(cfg, BIG), make_pool(cfg, BIG + 1)
    assert len(a) == cfg["pool_images"]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    assert all(x.shape == (24, 40, cfg["channels"]) and x.dtype == np.uint8 for x in a + c)


def test_pool_matches_the_plain_generator():
    cfg = _config("kodak_shape_rgb")
    pool = make_pool(cfg, 5)
    assert np.array_equal(pool[2], natural_image(24, 40, 3, [5, 2]))


@pytest.mark.parametrize("mix", ["bulk64", "bulk8", "single"])
def test_traffic_order_is_the_seeds(mix):
    traffic = M.load_traffic(mix)
    cfg = _config("tiles256_gray", pool=10)

    def indices(seed, units=12):
        loop = M.load_loop(traffic["loop"])(_StubProgram(cfg, traffic), make_pool(cfg, seed), seed)
        n = traffic["batch_size"] * traffic.get("batches_per_call", 1)
        return [loop.next_indices(n) for _ in range(units)]

    a, b = indices(BIG), indices(BIG)
    assert a == b
    flat = [i for unit in a for i in unit]
    if traffic["loop"] == "encode_decode":
        # every image once a cycle, in the seed's order
        assert sorted(flat[:10]) == list(range(10))
        assert flat[:10] == request_order(10, BIG).tolist()
        assert indices(BIG + 1) != a
    else:
        # the pool in order, cyclically, batches_per_call batches a call
        assert flat == [k % 10 for k in range(len(flat))]
        assert len(a[0]) == traffic["batch_size"] * traffic["batches_per_call"]


def test_request_order_differs_between_seeds():
    orders = {tuple(request_order(24, BIG + s)) for s in range(5)}
    assert len(orders) == 5
    assert all(sorted(o) == list(range(24)) for o in orders)
