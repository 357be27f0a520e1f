#!/usr/bin/env python3
"""The grid decode's wave chain and the encode statistics of one source
tree, timed on the card: one JSON line.

    python3 frave_tpu_torch/bench_waves.py TREE [programs] [stages] [kernels] [variant]

(the first three parts when none is named).
TREE is a checkout holding frave_tpu_torch (this one, or an unpacked
`git archive` of another commit), so that two commits compare on one card
in one call: run it as parent, change, change, parent. Cases, on the
smoke's seeded images (testing.natural_image), lossless at the default
lane count: 256x256 gray (K below 2^18: the step statistics' fits),
768x512 RGB and 2048x2048 RGB (above: the subsampled fits), one image a
call, and 64 256x256 gray images in one batch, in grid mode; e1
2048x2048 RGB parallel, e2 768x512 RGB parity and e3 4 256x256 gray
parity images in one batch (their statistics). Per case, the median over
RUNS warm calls of the StageTimes' ms (each mark synchronises the card,
so a stage is the host's and the device's time together): "encode/stats"
and, in grid mode, "decode/waves"; per grid decode, the device kernels it
runs (torch.profiler's CUDA events over one decode batch), the torch
operators it dispatches (a TorchDispatchMode count over another; views
included) and the launches of the port's own kernels (their wrappers'
counters).

The programs part: seconds of CodecProgram.from_host at 2048x2048 RGB,
the first call (the geometry and schedule built and cached) and a second
(the program alone), before any other part.

The kernels part: kernels W and V alone (kernel_check.check, timed: the
device ms of one launch, its byte bound and its empty-launch floor, on
the smoke's seeded problems) at KERNEL_CASES, and where the tree has them
V's two walks over waves of every size (kernel_check.finish_orders_ms)
and its store sectors (kernel_check.finish_sectors). A kernel that
disagrees with its plain version fails the run, unless `variant` is named:
a tree that takes work out of a kernel (its tap loads, its stores) to see
what binds it, whose disagreement is recorded.
"""

import json
import sys
import time

tree = sys.argv[1]
sys.path.insert(0, tree)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from frave_tpu_torch import EncoderOptions, RasterImage, kernel_check  # noqa: E402
from frave_tpu_torch.codec import pipeline_torch as PT  # noqa: E402
from frave_tpu_torch.testing import natural_image  # noqa: E402

RUNS = 5
# (label, h, w, c, seeds, mode)
CASES = (
    ("256x256 gray", 256, 256, 1, (1,), "grid"),
    ("768x512 RGB", 512, 768, 3, (2,), "grid"),
    ("2048x2048 RGB", 2048, 2048, 3, (4,), "grid"),
    ("64x 256x256 gray", 256, 256, 1, tuple(range(64)), "grid"),
    ("e1 2048x2048 RGB parallel", 2048, 2048, 3, (4,), "parallel"),
    ("e2 768x512 RGB parity", 512, 768, 3, (2,), "parity"),
    ("e3 4x 256x256 gray parity", 256, 256, 1, tuple(range(200, 204)), "parity"),
)


# (label, kernel, shape, problem kind, images): W's largest decode wave
# and its statistics, V's largest wave, at the grid images and the B = 64
# batch; W's statistics at e1-e3
KERNEL_CASES = [
    (label, name, shape, kind, images)
    for label, shape, images in (("2048x2048 RGB", (2048, 2048, 3), 0),
                                 ("768x512 RGB", (512, 768, 3), 0),
                                 ("256x256 gray", (256, 256, 1), 0),
                                 ("64x 256x256 gray", (256, 256, 1), 64))
    for name, kind in (("wave_contexts", ("decode", "valid")),
                       ("wave_contexts", ("encode", "valid")), ("wave_finish", "valid"))
] + [
    ("e1 2048x2048 RGB parallel", "wave_contexts", (2048, 2048, 3, "parallel"),
     ("encode", "valid"), 0),
    ("e2 768x512 RGB parity", "wave_contexts", (512, 768, 3, "parity"), ("encode", "valid"), 0),
    ("e3 4x 256x256 gray parity", "wave_contexts", (256, 256, 1, "parity"), ("encode", "valid"),
     4),
]


def kernel_rows(dev, variant: bool) -> dict:
    """Per KERNEL_CASES entry: ms, bound_ms, floor_ms (and plain_ms,
    max_abs_err); V's two walks and its store sectors per program where
    the tree has them."""
    out = {}
    orders = getattr(kernel_check, "finish_orders_ms", None)
    sectors = getattr(kernel_check, "finish_sectors", None)
    for label, name, shape, kind, images in KERNEL_CASES:
        args, extra = kernel_check.problem(name, np.random.default_rng(7), shape, kind, dev,
                                           images)
        r = kernel_check.check_args(name, args, extra, dev, timed=True)
        if r["max_abs_err"] != 0 and not variant:
            raise AssertionError(f"{label} {name} {kind}: disagrees with its plain version")
        row = {k: r[k] for k in ("ms", "bound_ms", "floor_ms", "plain_ms", "max_abs_err")}
        mode = kind[0] if name == "wave_contexts" else "finish"
        out[f"{label} {name} {mode}"] = row
        if name == "wave_finish" and not variant:
            if orders is not None:
                out[f"{label} wave_finish walks"] = orders(shape, dev, images)
            if sectors is not None:
                out[f"{label} wave_finish sectors"] = sectors(kernel_check.program(*shape, dev))
    return out


def program_seconds(dev) -> list:
    """Seconds of two CodecProgram.from_host calls at 2048x2048 RGB: the
    first builds and caches the geometry and the schedule, the second is
    the program alone."""
    from frave_tpu_torch.fractal.schedule import default_num_lanes, get_schedule

    nl = default_num_lanes(get_schedule(2048, 2048, mode="grid").num_symbols)
    out = []
    for _ in range(2):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        PT.CodecProgram.from_host(2048, 2048, nl, 3, dev, "grid")
        torch.cuda.synchronize(dev)
        out.append(time.perf_counter() - t)
    return out


class _Ops(TorchDispatchMode):
    """Counts the torch operators dispatched under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _median_stages(fn, dev) -> dict:
    """Median ms of each stage over RUNS calls of fn(stages) after a warm
    one."""
    fn(PT.StageTimes(dev))
    runs = []
    for _ in range(RUNS):
        st = PT.StageTimes(dev)
        fn(st)
        runs.append(st.ms)
    return {k: float(np.median([r[k] for r in runs])) for k in runs[0]}


def _kernels(fn, dev) -> int:
    """The CUDA events (kernels, copies, fills) torch.profiler records over
    one fn()."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def main() -> int:
    dev = torch.device("cuda", 0)
    parts = set(sys.argv[2:]) or {"programs", "stages", "kernels"}
    wrappers = {n: k[0] for n, k in kernel_check.KERNELS.items()}
    out = {"tree": tree}
    if "programs" in parts:
        out["from_host_s"] = program_seconds(dev)
    if "kernels" in parts:
        out["kernels"] = kernel_rows(dev, "variant" in parts)
    for label, h, w, c, seeds, mode in CASES if "stages" in parts else ():
        imgs = [RasterImage.from_array(natural_image(h, w, c, s)) for s in seeds]
        opts = EncoderOptions(mode=mode)
        enc = _median_stages(lambda st: PT.encode_pipeline_torch_batch(imgs, opts, dev, st), dev)
        row = {"encode/stats": enc["encode/stats"], "encode": sum(enc.values())}
        if mode == "grid":
            cis = PT.encode_pipeline_torch_batch(imgs, opts, dev)
            dec = _median_stages(lambda st: PT.decode_pipeline_torch_batch(cis, dev, st), dev)
            row["decode/waves"] = dec["decode/waves"]
            row["decode"] = sum(dec.values())
            row["device_events"] = _kernels(lambda: PT.decode_pipeline_torch_batch(cis, dev), dev)
            for fn in wrappers.values():
                fn.launches = 0
            with _Ops() as ops:
                PT.decode_pipeline_torch_batch(cis, dev)
            row["torch_ops"] = ops.n
            row["port_launches"] = {n: fn.launches for n, fn in wrappers.items() if fn.launches}
        out[label] = row
    print("AB", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
