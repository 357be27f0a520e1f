"""One encode request: host wall less the program's stages, median (ms)."""

from portbench.core import readers


def read(ctx):
    return readers.driver_ms(ctx, "encode")
