"""The slice cross-checks of test_torch_pipeline.py (check_slice) with
FRAVE_GRID_ENC=force: the dense shift-plane encode statistics
(grid_decode.build_grid_encode) at 96x80, gray and RGB, with a fit cap
small enough that the largest waves are subsampled. A separate file so
the JAX compiles of these cases run on another test worker."""

import pytest

from test_torch_pipeline import check_slice, env  # noqa: F401  (env: fixture)


@pytest.mark.parametrize("c,seed", [(1, 15), (3, 16)])
def test_grid_encode_slice_matches_frave_tpu(env, c, seed):  # noqa: F811
    check_slice(env, 96, 80, c, "force", seed)
