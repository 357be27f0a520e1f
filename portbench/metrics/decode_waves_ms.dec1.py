"""The program's decode/waves stage of one request, median (ms)."""

from portbench.core import readers


def read(ctx):
    return readers.stage_ms(ctx, "decode/waves")
