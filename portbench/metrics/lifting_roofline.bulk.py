"""The lifting kernels' bound time (kernels/lifting.py over the card's bandwidth) over their device time in the traced stream calls (%)."""

from portbench.core import readers


def read(ctx):
    return readers.roofline_pct(ctx, "lifting")
