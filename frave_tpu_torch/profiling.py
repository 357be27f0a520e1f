"""Tracing hooks: the port's counterpart of frave_tpu/profiling.py, on
torch.profiler.

    with trace("/path/to/trace-dir"):    # host + CUDA timeline, Chrome trace
        encode(...)

    with annotate("frave.encode.upload"):  # a named span in any trace
        ...

The drivers (codec/pipeline_torch.py, codec/encoder.py,
codec/decoder.py) mark their host steps with annotate: one span a batch
or call, named frave.<side>.<step>, on the profiler's clock, so a trace
puts each gap in the device's timeline down to the step the host was in.
A span is on exactly when a torch.profiler session is recording; with
none it costs one flag check and never calls record_function.
"""

from __future__ import annotations

import contextlib
import os
import time
from contextlib import contextmanager

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A named span (record_function) while a profiler records; otherwise
    a shared no-op context. Reads torch's own "profiler on" flag, so the
    span is free when no trace is taken."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def _all_threads_config():
    """The profiler option that records every thread, or None where the
    installed torch has no such option."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextmanager
def trace(log_dir: str, device="cuda"):
    """torch.profiler over a region: CPU activities, and CUDA activities
    when `device` is a GPU; writes a Chrome trace (trace_<pid>_<ns>.json)
    into `log_dir` when the region ends, and yields the profiler.

    It records every thread where the installed torch can: the stream
    drivers' worker threads (fetch, unpack, serialize, parse, wrap) then
    appear beside the caller's. A default torch.profiler session records
    only the thread that started it, and shows none of their spans."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    cfg = _all_threads_config()
    prof = (torch.profiler.profile(activities=activities) if cfg is None
            else torch.profiler.profile(activities=activities, experimental_config=cfg))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
