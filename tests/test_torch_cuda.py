"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports no JAX (the machine with the card has none); skips where
torch.cuda.is_available() is false. Run it there with
`python -m pytest tests/test_torch_cuda.py -q`."""

import pytest
import torch

from frave_tpu_torch import kernel_check

# the slice's shapes: lifting rows x mask rows (256x256 gray: 160 tiles;
# 768x512 RGB: 3 x 844 tiles), rANS grids R x C x NL
SHAPES = {
    "forward_lift_quantize": [(7, 7), (160, 160), (2532, 844)],
    "dequantize_inverse_lift": [(7, 7), (160, 160), (2532, 844)],
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
        for kind in kinds:
            res = kernel_check.check(name, shape, torch.device("cuda"), kind=kind,
                                     clusters=clusters)
            assert res["max_abs_err"] == 0, res
