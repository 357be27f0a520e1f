"""Tracing and profiling hooks: the port's counterpart of
frave_tpu/profiling.py, on torch.profiler.

    with trace("/path/to/trace-dir"):    # host + CUDA timeline, Chrome trace
        encode(...)

    with stage_timer("encode/device"):    # wall time per stage -> metrics
        ...
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch

from .metrics import get_metrics


@contextmanager
def trace(log_dir: str, device="cuda"):
    """torch.profiler over a region: CPU activities, and CUDA activities
    when `device` is a GPU; writes a Chrome trace (trace_<pid>_<ns>.json)
    into `log_dir` when the region ends, and yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextmanager
def stage_timer(name: str):
    """Wall-clock stage timing recorded into the global metrics sink. It
    does not synchronise the device: it times what the host waits for."""
    with get_metrics().timer(name):
        yield


@contextmanager
def annotate(name: str):
    """A named region in profiler timelines (record_function)."""
    with torch.profiler.record_function(name):
        yield
