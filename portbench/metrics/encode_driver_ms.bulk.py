"""A bulk cell's encode batch: host wall less the program's stages, median (ms a batch)."""

from portbench.core import readers


def read(ctx):
    return readers.driver_ms(ctx, "encode")
