"""One run of one cell: set-up, the measured window (or, with trace, the
spans pass and the profiled pass), the judgement, the result line.

The program under test is frave_tpu_torch, reached through its public
entries, its batch calls with their StageTimes spans (traced runs only),
and its program build. What the cell drives is its traffic mix's loop
(loops/<loop>.py, core/loop.py); what decides `correct` is its
configuration's comparison (judges/<kind>.py, core/judge.py); each
per-layer metric is its reader (metrics/<name>.py). This module knows
none of them by name.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
import tempfile
import time

from . import judge as J
from .loop import MIN_UNITS
from .manifest import BENCH, end_to_end, load_loop, load_reader, per_layer
from .pool import make_pool
from .readers import Context
from .trace import SPAN_PREFIX, Trace

WARMUP_UNITS = 2  # loop units before the window
SPANS_SHARE = 0.5  # of --seconds, the traced run's spans pass
PROFILE_SECONDS = 2.0  # the profiled stretch of a traced run (at least MIN_UNITS units)


class Program:
    """The system under test as one cell drives it, on `device`."""

    def __init__(self, config: dict, traffic: dict, device: str):
        import torch

        import frave_tpu_torch as F
        from frave_tpu_torch.codec import pipeline_torch as P
        from frave_tpu_torch.codec.container import deserialize, serialize
        from frave_tpu_torch.fractal.schedule import default_num_lanes, get_schedule

        self.torch, self.F, self.P = torch, F, P
        self.serialize, self.deserialize = serialize, deserialize
        self.device = device
        self.config, self.traffic = config, traffic
        self.opts = F.EncoderOptions(
            quality=F.EncoderQuality[config["quality"]],
            color_transform=config["color_transform"],
            mode=config["mode"],
        )
        h, w, c = config["height"], config["width"], config["channels"]
        t0 = time.perf_counter()
        sched = get_schedule(h, w, mode=config["mode"])
        self.num_lanes = default_num_lanes(sched.num_symbols)
        P.get_program(h, w, self.num_lanes, c, device, config["mode"])
        self.sync()
        self.build_s = time.perf_counter() - t0

    def sync(self):
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    def raster(self, arr):
        return self.F.RasterImage.from_array(arr)

    # the program's batch calls with its stage spans (traced runs)
    def encode_staged(self, images):
        st = self.P.StageTimes(self.device)
        cis = self.P.encode_pipeline_torch_batch(images, self.opts, self.device, stages=st)
        return [self.serialize(ci) for ci in cis], st.ms

    def decode_staged(self, blobs):
        st = self.P.StageTimes(self.device)
        cis = [self.deserialize(b) for b in blobs]
        outs = self.P.decode_pipeline_torch_batch(cis, self.device, stages=st)
        return [o.data for o in outs], st.ms


def _record_span(name):
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


def device_info(device: str, chips: int) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(d)
                                         for d in range(chips)))}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def host_line() -> str:
    """The host's processor, its cores and load, and the milliseconds of a
    fixed pure-Python loop (the best of three): the host sets these cells'
    pace, and this reads its speed beside each run."""
    model = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")),
                         model)
        with open("/proc/loadavg") as f:
            load = " ".join(f.read().split()[:3])
    except OSError:
        load = "unknown"
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        acc = 0
        for i in range(1_000_000):
            acc += i & 7
        best = min(best, time.perf_counter() - t0)
    return f"{model}, {os.cpu_count()} cores, load {load}, py_loop_ms={best * 1e3:.2f}"


def profile(loop, device: str):
    """The profiled pass: the timed path for PROFILE_SECONDS (at least
    MIN_UNITS units) under torch.profiler, its Chrome trace read from
    TMPDIR and deleted. Returns the Trace and the pass's decode batches."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    loop.captured = []
    with torch.profiler.profile(activities=acts) as prof:
        with _record_span("window"):
            loop.run_for(PROFILE_SECONDS, span=_record_span, min_units=MIN_UNITS)
        loop.prog.sync()
    captured, loop.captured = loop.captured, None
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        tr = Trace.from_file(path)
    finally:
        os.remove(path)
    return tr, captured


def run_cell(manifest: dict, cell: dict, config: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device: str, t_start: float) -> dict:
    """Set up, measure (or trace), judge; returns the result line's object.
    `t_start` is when the process began its set-up (perf_counter)."""
    unit_names = {m["name"]: m["unit"] for m in manifest["end_to_end"] + manifest["per_layer"]}
    t0 = time.perf_counter()
    prog = Program(config, traffic, device)
    print(f"program build: {prog.build_s!r} s", file=sys.stderr)
    t1 = time.perf_counter()
    pool = make_pool(config, seed)
    loop = load_loop(traffic["loop"])(prog, pool, seed)
    t2 = time.perf_counter()
    for _ in range(WARMUP_UNITS):
        loop.unit(keep=False)
    prog.sync()
    t3 = time.perf_counter()
    print(f"setup: start_to_program_s={t0 - t_start!r} program_s={t1 - t0!r} "
          f"pool_s={t2 - t1!r} warmup_s={t3 - t2!r}", file=sys.stderr)
    warm_failed = loop.failed
    loop.reset()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    out = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if not trace:
        window_s = loop.run_for(seconds)
        print(f"window: {window_s!r} s, {loop.attempted} images attempted", file=sys.stderr)
        for line in loop.latency_lines():
            print(line, file=sys.stderr)
        vals = {"setup_s": setup_s, **loop.values(window_s)}
        for m in end_to_end(manifest, cell["name"]):
            if m["name"] in vals:  # a window in which every unit failed has no tail
                out["metrics"][m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
        out["device"] = device_info(device, cell["chips"])
    else:
        units = loop.staged_units(seconds * SPANS_SHARE)
        tr, batches = profile(loop, device)
        out["device"] = device_info(device, cell["chips"])
        kind = out["device"]["kind"]
        with open(BENCH / "peaks.json") as f:
            peaks = json.load(f).get(kind, {})
        ctx = Context(traffic, config, kind, peaks, prog.build_s, units, tr, batches, pool)
        for m in per_layer(manifest, cell["name"]):
            v = load_reader(m["name"])(ctx)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": unit_names[m["name"]]}
        a, b = tr.window()
        out["device"]["busy_s"] = tr.busy_us(a, b) * 1e-6
        out["device"]["window_s"] = (b - a) * 1e-6
        out["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps(a, b)}
    if device != "cpu":
        print(f"card: {card_line()}", file=sys.stderr)
    print(f"host: {host_line()}", file=sys.stderr)
    out["attempted"], out["failed"] = loop.attempted, loop.failed
    samples, loop.samples = loop.samples, []
    if device != "cpu":
        prog.torch.cuda.empty_cache()
    checks = J.judge(config, pool, samples, loop.failed + warm_failed, seed)
    out["correct"] = J.is_correct(checks) and loop.attempted > 0
    out["checks"] = checks
    return out
