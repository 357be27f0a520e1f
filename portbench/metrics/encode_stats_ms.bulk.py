"""The program's encode/stats stage of a batch, median (ms a batch)."""

from portbench.core import readers


def read(ctx):
    return readers.stage_ms(ctx, "encode/stats")
