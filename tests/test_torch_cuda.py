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


# kernels W and V: grid programs (h, w, c) with the images of a batch
# (RGB at B = 4 and gray at B = 64: the most image groups a block; at
# 768x512 RGB B = 4 more tiles than the persistent grid has blocks), and
# W's statistics on step-tensor programs (h, w, c, mode)
WAVE_SHAPES = [((64, 64, 1), 0), ((96, 80, 3), 2), ((256, 256, 1), 3), ((512, 768, 3), 0),
               ((512, 768, 3), 4), ((256, 256, 1), 64)]
STATS_SHAPES = [((64, 64, 1, "parity"), 2), ((96, 80, 3, "parallel"), 0), ((16, 16, 3, "grid"), 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", kernel_check.WAVE_KERNELS)
def test_cuda_wave_kernels_match_plain(name):
    """Kernel W in both modes (a program's largest decode wave, its
    statistics) and kernel V (the largest wave's values into the plane)
    against their plain versions on a program's records, on coefficients
    and on garbage, one image and batches: bit-equal, one launch a call;
    W also with the lanes of the tp decoder's windows, and its statistics
    on step-tensor programs; V over the tp decoder's parts and in schedule
    order (its rule walks slot order); both on every wave of a small
    program (waves smaller than a tile; V in both orders), each image with
    its own plane and parameters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from frave_tpu_torch.codec import grid_decode as GD
    from frave_tpu_torch.ops import wave_ctx as WC

    dev = torch.device("cuda")
    wrapper = kernel_check.KERNELS[name][0]
    cases = [(sh, im) for sh, im in WAVE_SHAPES]
    if name == "wave_contexts":
        kinds = [(m, k) for m in kernel_check.WAVE_MODES for k in kernel_check.DECODE_KINDS]
        cases += STATS_SHAPES
    else:
        kinds = kernel_check.DECODE_KINDS
    for shape, images in cases:
        for kind in kinds:
            if len(shape) == 4 and kind[0] == "decode":
                continue
            before = wrapper.launches
            res = kernel_check.check(name, shape, dev, kind=kind, images=images)
            assert res["max_abs_err"] == 0, (shape, kind, res["errs"])
            assert wrapper.launches == before + 1, (shape, kind)
    prog = kernel_check.program(512, 768, 3, dev)
    (k0, kw, nl), wd = kernel_check.largest_wave(prog)
    plan = WC.launch_plan(name, 4, wd.rows * nl if name == "wave_contexts" else kw, 3, dev)
    assert plan.tiles > plan.blocks, plan  # the B = 4 case above walks tiles
    if name == "wave_contexts":
        args, _ = kernel_check.problem(name, np.random.default_rng(3), (512, 768, 3),
                                       ("decode", "valid"), dev)
        nl = args[5][2]
        for lo, width in ((0, nl // 2), (nl // 2, nl // 2), (nl // 4, nl // 4)):
            got = WC.wave_contexts(*args, lanes=(lo, width))
            ref = WC.wave_contexts_plain(*args, lanes=(lo, width))
            assert all(bool((a == b).all()) for a, b in zip(got, ref)), (lo, width)
    else:
        # the tp decoder's gather: 2 ranks' lanes as parts, one image
        args, _ = kernel_check.problem(name, np.random.default_rng(3), (512, 768, 3), "garbage",
                                       dev)
        syms, preds, records, wave, plane, C = args
        _, _, rows, _, nl = syms.shape
        parts = syms[0].reshape(rows, C, 2, nl // 2).permute(2, 0, 1, 3)[:, None]
        got = WC.wave_finish(parts, preds, records, wave, plane.clone(), C)
        ref = WC.wave_finish_plain(syms, preds, records, wave, plane.clone(), C)
        assert bool((got == ref).all())
        got = WC.wave_finish(syms, preds, records, wave, plane.clone(), C, slot_order=False)
        assert bool((got == ref).all())  # schedule order
    # every wave of a small program, one image and three: waves with fewer
    # symbols than one tile among them
    rng = np.random.default_rng(5)
    for images in (0, 3):
        p = kernel_check.program(64, 64, 1, dev)
        rows_ = kernel_check._wave_plane(rng, p, "garbage", images)
        B = rows_.shape[0]
        vp, wp = (torch.from_numpy(rng.uniform(-4, 4, size=(B, p.num_fine, 6)).astype(
            np.float32)).to(dev) for _ in range(2))
        small = 0
        for wv, k0_ in zip(p.waves, GD.wave_starts(p.waves)):
            if wv.kw == 0:
                continue
            small += wv.kw < WC.BLOCK // WC.plan_rule(max(images, 1), wv.kw, 1, 1).groups
            wave = (k0_, wv.kw, p.nl)
            if name == "wave_contexts":
                got = WC.wave_contexts(rows_, p.records, vp, wp, 1, wave)
                ref = WC.wave_contexts_plain(rows_, p.records, vp, wp, 1, wave)
                assert all(bool((a == b).all()) for a, b in zip(got, ref)), wave
            else:
                sy = torch.from_numpy(rng.integers(0, 1024, size=(1, B, wv.rows, 1, p.nl)).astype(
                    np.int32)).to(dev)
                pr = torch.from_numpy(rng.integers(-255, 256, size=(B, wv.kw)).astype(
                    np.int32)).to(dev)
                ref = WC.wave_finish_plain(sy, pr, p.records, wave, rows_.clone(), 1)
                for slot_order in (None, True):  # the rule (schedule order here), slot order
                    got = WC.wave_finish(sy, pr, p.records, wave, rows_.clone(), 1,
                                         slot_order=slot_order)
                    assert bool((got == ref).all()), (wave, slot_order)
        assert small, "no wave smaller than a tile"


@pytest.mark.cuda
def test_cuda_2048_rgb_decode_clusters_and_pinned_uploads():
    """One 2048x2048 RGB image, the photo cell's shape: its decode launches
    kernel 3 once a non-empty wave, every launch at a 16-block cluster
    (decode_scan_wave.clusters); under a CUDA profiler each pinned staging
    copy opens a frave.pin span inside its upload span (the pixels, the
    divisors and the ids of an encode; the nine wire arrays of a decode),
    and the container is byte-equal with the profiler on and off and
    decodes to the image."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    import frave_tpu_torch
    from frave_tpu_torch.codec import pipeline_torch as PT
    from frave_tpu_torch.codec.container import deserialize
    from frave_tpu_torch.ops import rans_torch as RT
    from frave_tpu_torch.testing import natural_image

    px = natural_image(2048, 2048, 3, seed=4)
    blob = frave_tpu_torch.encode(px, device="cuda")
    prog = PT.get_program(2048, 2048, deserialize(blob).num_lanes, 3, "cuda", "grid")
    live = sum(1 for wd in prog.waves if wd.kw)
    RT.decode_scan_wave.clusters.clear()
    np.testing.assert_array_equal(frave_tpu_torch.decode(blob, device="cuda").data, px)
    assert RT.decode_scan_wave.clusters == {16: live}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        on = frave_tpu_torch.encode(px, device="cuda")
        out = frave_tpu_torch.decode(on, device="cuda")
    assert on == blob
    np.testing.assert_array_equal(out.data, px)
    # the host's spans (each also has a device-side copy in a CUDA trace)
    spans = [(e.name, e.time_range) for e in prof.events()
             if e.name.startswith("frave.") and e.device_type == torch.autograd.DeviceType.CPU]
    pins = [r for n, r in spans if n == "frave.pin"]
    for side, n in (("encode", 3), ("decode", 9)):
        (up,) = [r for name, r in spans if name == f"frave.{side}.upload"]
        assert sum(up.start <= p.start and p.end <= up.end for p in pins) == n, side
    assert len(pins) == 12
