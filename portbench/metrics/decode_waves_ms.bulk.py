"""The program's decode/waves stage of a batch, median (ms a batch)."""

from portbench.core import readers


def read(ctx):
    return readers.stage_ms(ctx, "decode/waves")
