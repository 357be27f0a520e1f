"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports no JAX (the machine with the card has none); skips where
torch.cuda.is_available() is false. Run it there with
`python -m pytest tests/test_torch_cuda.py -q`."""

import numpy as np
import pytest
import torch

from frave_tpu_torch import kernel_check
from frave_tpu_torch.ops import lifting as L

# the slice's shapes: lifting rows x mask rows (256x256 gray: 160 tiles;
# 768x512 RGB: 3 x 844 tiles), kernel B's images h x w x c (it runs on
# their programs), rANS grids R x C x NL
SHAPES = {
    "forward_lift_quantize": [(7, 7), (160, 160), (2532, 844)],
    "dequantize_inverse_lift_pixels": [(64, 64, 1), (96, 80, 3), (256, 256, 1), (512, 768, 3)],
    "encode_scan": [(5, 1, 32), (133, 1, 512), (200, 3, 2048)],
    # R x C x NL up to 2048x2048 RGB's 16,384 lanes and the pinned 32,768;
    # C * NL = 609 leaves every row but the first unaligned for 16-byte loads
    "decode_scan_wave": [(7, 1, 32), (40, 1, 512), (60, 3, 2048), (30, 3, 16384),
                         (4, 3, 32768), (9, 3, 203), (3, 3, 65535)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cuda_kernel_matches_plain(name):
    """decode_scan_wave at its launch rule's cluster size and at every
    size it can be forced to."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    decode = name == "decode_scan_wave"
    kinds = kernel_check.DECODE_KINDS if decode else (None,)
    clusters = (0,) + kernel_check.CLUSTERS if decode else (0,)
    for shape in SHAPES[name]:
        if name == "dequantize_inverse_lift_pixels":
            kinds = range(4) if shape[2] == 3 else (0,)
        for kind in kinds:
            res = kernel_check.check(name, shape, torch.device("cuda"), kind=kind,
                                     clusters=clusters)
            assert res["max_abs_err"] == 0, res


@pytest.mark.cuda
def test_cuda_lift_pixels_refuses_unaligned_rows():
    """Kernel B's coefficient rows must be 16-byte aligned (its vector
    loads): a row stride of T*512 + 1 raises instead of launching."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    prog = kernel_check.program(96, 80, 3, torch.device("cuda"))
    args, extra = kernel_check.lift_pixels_problem(np.random.default_rng(1), prog, 3)
    plane = args[0]
    padded = plane.new_zeros((plane.shape[0], plane.shape[1] + 1))
    padded[:, : plane.shape[1]] = plane
    before = L.dequantize_inverse_lift_pixels.launches
    with pytest.raises(ValueError):
        L.dequantize_inverse_lift_pixels(padded, *args[1:], *extra)
    assert L.dequantize_inverse_lift_pixels.launches == before


@pytest.mark.cuda
def test_cuda_encode_scan_design_points():
    """Kernel C at every (rows ahead, lanes a block) the sweep measures."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    for shape in ((7, 1, 32), (40, 3, 300)):
        kernel_check.encode_design_ms(shape, torch.device("cuda"))

