"""The port's CUDA kernels against their plain PyTorch versions, on the
card (kernel D, decode_steps, on real programs and containers). Imports no JAX (the machine with the card has none); skips where
torch.cuda.is_available() is false. Run it there with
`python -m pytest tests/test_torch_cuda.py -q`."""

import numpy as np
import pytest
import torch

from frave_tpu_torch import kernel_check
from frave_tpu_torch.ops import lifting as L

# the slice's shapes: the lifting kernels' images h x w x c (they run on
# their programs), rANS grids R x C x NL
SHAPES = {
    "forward_lift_quantize_pixels": [(64, 64, 1), (96, 80, 3), (256, 256, 1), (512, 768, 3)],
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
        tids = range(4) if len(shape) == 3 and shape[2] == 3 else (0,)
        if name == "dequantize_inverse_lift_pixels":
            kinds = tids
        if name == "forward_lift_quantize_pixels":
            kinds = [(tid, q) for tid in tids for q in kernel_check.QDIV_KINDS]
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
def test_cuda_lift_head_writes_aligned_plane_and_zero_slot():
    """Kernel A's plane: rows 16-byte aligned, the zero slot 0; launched
    into a buffer first filled with garbage, it writes every column of
    the plane, the zero slot and the padding after it; a forced tiles a
    block outside 1 .. 16 // C raises without launching."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from frave_tpu_torch.ops import _build

    prog = kernel_check.program(96, 80, 3, torch.device("cuda"))
    args, extra = kernel_check.lift_head_problem(np.random.default_rng(2), prog, 3)
    ref = L.forward_lift_quantize_pixels_plain(*args, *extra)
    out = L.forward_lift_quantize_pixels(*args, *extra)
    assert out.data_ptr() % 16 == 0 and out.stride(0) % 4 == 0 and out.stride(1) == 1
    assert (out[:, -1] == 0).all()
    assert torch.equal(out, ref)
    pixels, leaf_pix, qdiv = args
    C, n = pixels.shape[1], leaf_pix.shape[0]
    stride = (n + 4) // 4 * 4
    buf = torch.full((C, stride), -123456, dtype=torch.int32, device=pixels.device)
    tids = torch.tensor([extra[0]], dtype=torch.int32, device=pixels.device)
    code = _build.load_library().frave_fwd_lift_pixels(
        pixels.data_ptr(), leaf_pix.data_ptr(), qdiv.data_ptr(), tids.data_ptr(), buf.data_ptr(),
        stride, pixels.shape[0], n // 512, C, 1, 2, _build.current_stream(pixels.device),
    )
    _build.check(code, "frave_fwd_lift_pixels")
    torch.cuda.synchronize()
    assert torch.equal(buf[:, : n + 1], ref)
    assert (buf[:, n:] == 0).all()
    before = L.forward_lift_quantize_pixels.launches
    with pytest.raises(ValueError):
        L.forward_lift_quantize_pixels(*args, *extra, tiles=16 // C + 1)
    assert L.forward_lift_quantize_pixels.launches == before


@pytest.mark.cuda
def test_cuda_lift_head_tiles_a_block():
    """Kernel A at every tiles a block the sweep measures."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    for shape in ((64, 64, 1), (96, 80, 3)):
        kernel_check.lift_head_tiles_ms(shape, torch.device("cuda"))


@pytest.mark.cuda
def test_cuda_encode_scan_design_points():
    """Kernel C at every (rows ahead, lanes a block) the sweep measures."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    for shape in ((7, 1, 32), (40, 3, 300)):
        kernel_check.encode_design_ms(shape, torch.device("cuda"))


# the batch shapes: (h, w, c) images and batch sizes of the main path's
# batches (bench.py's 256x256 gray at B = 64, 768x512 RGB)
BATCHES = [((256, 256, 1), (1, 3, 64)), ((512, 768, 3), (1, 2))]


def _batch_cases(name):
    """(shape, kind, images) of kernel `name` at every batch of BATCHES:
    the lifting kernels on the image's program, kernel C on its grid,
    kernel 3 on its largest wave, valid and garbage; kernel 3 also on
    (30, 3, 16384) waves of 12 images, more 16-block clusters than the
    card holds at once."""
    out = []
    for image, sizes in BATCHES:
        sh = kernel_check.grid_shapes(*image)
        for b in sizes:
            if name == "forward_lift_quantize_pixels":
                out += [(image, (tid, q), b) for tid in (0, 3)[: image[2]]
                        for q in kernel_check.QDIV_KINDS]
            elif name == "dequantize_inverse_lift_pixels":
                out.append((image, 1 if image[2] == 3 else 0, b))
            elif name == "encode_scan":
                out.append((sh["grid"], None, b))
            else:
                out += [(sh["wave"], k, b) for k in kernel_check.DECODE_KINDS]
    if name == "decode_scan_wave":
        out += [((30, 3, 16384), k, 12) for k in kernel_check.DECODE_KINDS]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cuda_kernel_batch_matches_plain(name):
    """Each kernel on a whole batch in one launch, bit-equal to its plain
    version: at B in {1, 3, 64} for 256x256 gray and {1, 2} for 768x512
    RGB (mixed transform ids and qdivs across the batch), and kernel 3 at
    B = 12 on 2048x2048 RGB-sized waves; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    wrapper = kernel_check.KERNELS[name][0]
    for shape, kind, images in _batch_cases(name):
        before = wrapper.launches
        res = kernel_check.check(name, shape, torch.device("cuda"), kind=kind, images=images)
        assert res["max_abs_err"] == 0, res
        assert wrapper.launches == before + 1, (name, shape, images)


@pytest.mark.cuda
def test_cuda_lift_head_batch_zero_slots():
    """Kernel A on a batch of 3 into buffers first filled with garbage: the
    zero slot and padding of every image's rows are written."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    prog = kernel_check.program(96, 80, 3, torch.device("cuda"))
    args, extra = kernel_check.lift_head_problem(np.random.default_rng(3), prog, 1, images=3)
    torch.cuda.empty_cache()
    junk = torch.full((1 << 22,), -7, dtype=torch.int32, device="cuda")
    del junk  # the kernel's output reuses these garbage-filled blocks
    out = L.forward_lift_quantize_pixels(*args, *extra)
    assert (out[..., -1] == 0).all()
    assert torch.equal(out, L.forward_lift_quantize_pixels_plain(*args, *extra))



# kernel D's programs (h, w, c, mode): parity and parallel, and the grid
# shapes with no dense lattice, up to 768x512 RGB
STEP_SHAPES = [(64, 64, 1, "parity"), (96, 80, 3, "parallel"), (16, 16, 3, "grid"),
               (1, 1, 1, "grid"), (256, 256, 1, "parity"), (512, 768, 3, "parallel")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", STEP_SHAPES)
def test_cuda_decode_steps_matches_plain(shape):
    """Kernel D against decode_steps_plain on a real program's step operands
    and the wire of the port's own container (and garbage states and
    streams on it), one image and a batch of 2: at its launch rule, its
    one-block variant forced where a step's pairs fit one block, and its
    cluster variant forced to every size up to 16 blocks (several blocks
    exchange plane values across the cluster every step); one launch a
    call; on the valid wire also every design of the sweep
    (kernel_check.STEP_DESIGNS: prefetch off and forced on, slot taps,
    padded records, each forced size with and without prefetch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from frave_tpu_torch.ops import step_decode as SD

    dev = torch.device("cuda")
    for kind in kernel_check.DECODE_KINDS:
        for images in (0, 2):
            args, extra = kernel_check.problem("decode_steps", np.random.default_rng(0), shape,
                                               kind, dev, images)
            x, steps = args[0], args[2]
            ca, fine = args[6]["bits"].shape[-1], args[3].shape[-2]
            designs = [0] + list(kernel_check.CLUSTERS)
            try:
                SD.decode_steps_plan(x.shape[-2], x.shape[-1], ca, fine, steps.max_len,
                                     flags=SD.FORCE_BLOCK)
                designs.append("block")
            except RuntimeError:
                assert x.shape[-2] * steps.max_len > 2048  # only wide steps refuse it
            before = SD.decode_steps.launches
            res = kernel_check.check_args("decode_steps", args, extra, dev, clusters=designs)
            assert res["max_abs_err"] == 0, res
            assert SD.decode_steps.launches == before + len(designs)
            if kind == "valid":  # every design switch, bit-equal (raises otherwise)
                kernel_check.step_design_ms(args, extra, dev)


@pytest.mark.cuda
def test_cuda_decode_steps_plan_runs_one_block_at_768x512_rgb_parity():
    """The launch rule runs one block an image, with no cluster exchange,
    at 768x512 RGB parity (its widest step, 638 lanes, is 1,914 pairs: two
    a thread, with prefetch) and at 256x256 gray parity (254 lanes: one a
    thread, without); a cluster of 16 at 2048x2048 RGB parallel's width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from frave_tpu_torch.codec import pipeline_torch as PT
    from frave_tpu_torch.fractal.schedule import default_num_lanes, get_schedule
    from frave_tpu_torch.ops import step_decode as SD

    for h, w, c in ((512, 768, 3), (256, 256, 1)):
        nl = default_num_lanes(get_schedule(h, w, mode="parity").num_symbols)
        prog = PT.get_program(h, w, nl, c, "cuda", "parity")
        plan = SD.decode_steps_plan(c, nl, 15, prog.num_fine, prog.steps.max_len)
        want = ("block", 1, 2, True) if c == 3 else ("block", 1, 1, False)
        assert tuple(plan) == want, plan
    plan = SD.decode_steps_plan(3, 16384, 15, 11, 16384)
    assert plan.variant == "cluster" and plan.cluster == 16, plan


@pytest.mark.cuda
def test_cuda_decode_steps_refuses_what_it_cannot_run():
    """More than 16 * 8192 lanes, a cluster size that is not a power of two
    up to 16, or the one-block variant forced where a step's pairs exceed
    8 a thread, raises without launching."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from frave_tpu_torch.ops import step_decode as SD

    with pytest.raises(RuntimeError):
        SD.decode_steps_plan(3, 65536, 15, 11, 65536)
    with pytest.raises(RuntimeError):
        SD.decode_steps_plan(3, 16384, 15, 11, 16384, flags=SD.FORCE_BLOCK)
    args, extra = kernel_check.problem("decode_steps", np.random.default_rng(4),
                                       (64, 64, 1, "parity"), "valid", torch.device("cuda"))
    args = tuple(kernel_check._to(a, torch.device("cuda")) for a in args)
    before = SD.decode_steps.launches
    with pytest.raises(RuntimeError):
        SD.decode_steps(*args, *extra, cluster=3)
    with pytest.raises(RuntimeError):
        SD.decode_steps(*args, *extra, cluster=2, flags=SD.FORCE_BLOCK)
    assert SD.decode_steps.launches == before
