"""The share of the traced encode requests in which nothing ran on the device (%)."""

from portbench.core import readers


def read(ctx):
    return readers.idle_pct(ctx, "encode")
