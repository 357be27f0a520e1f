"""The program's encode/stats stage of one request, median (ms)."""

from portbench.core import readers


def read(ctx):
    return readers.stage_ms(ctx, "encode/stats")
