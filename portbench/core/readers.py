"""What the per-layer readers (metrics/<name>.py) read: a traced run's
units with their program spans, its profiler trace and the decode
batches it traced, whose work each kernel family's arithmetic counts
itself. A reader that finds nothing to read returns None, and the metric
is left out of the run's line."""

from __future__ import annotations

import dataclasses
import statistics
from typing import List, Optional

from .loop import Batch, Unit
from .manifest import load_kernel_family
from .trace import Trace


@dataclasses.dataclass
class Context:
    traffic: dict
    config: dict
    device_kind: str
    peaks: dict  # peaks.json's entry for the card, {} when it has none
    program_build_s: float
    units: List[Unit]  # the spans pass
    trace: Optional[Trace]  # the profiled pass
    batches: List[Batch]  # the profiled pass's decode batches
    pool: list  # the run's inputs, by the batches' indices


def driver_ms(ctx: Context, kind: str):
    """Median over the units of `kind` of their wall less their stages: the
    driver's work outside the program's stages."""
    vals = [u.wall_ms - sum(u.stages.values()) for u in ctx.units if u.kind == kind]
    return statistics.median(vals) if vals else None


def stage_ms(ctx: Context, stage: str):
    """Median of one program stage over the units that ran it."""
    vals = [u.stages[stage] for u in ctx.units if stage in u.stages]
    return statistics.median(vals) if vals else None


def idle_pct(ctx: Context, span: str):
    """The share of the "portbench.<span>" spans' time in which no
    operation ran on the device."""
    if ctx.trace is None or not ctx.trace.spans.get("portbench." + span):
        return None
    return ctx.trace.idle_pct(ctx.trace.spans["portbench." + span])


def roofline_pct(ctx: Context, family: str):
    """The bound time of the family's work over the device time of its
    kernels in the traced window."""
    bw = ctx.peaks.get("hbm_bytes_per_s")
    if ctx.trace is None or not ctx.batches or not bw:
        return None
    spec = load_kernel_family(family)
    a, b = ctx.trace.window()
    device_s = ctx.trace.device_us(spec["kernels"], a, b) * 1e-6
    if device_s <= 0:
        return None
    nbytes = spec["work"].bytes_needed(ctx.batches)
    return 100.0 * (nbytes / bw) / device_s
