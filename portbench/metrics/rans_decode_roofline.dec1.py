"""The rANS wave decode's bound time (kernels/rans_decode.py over the card's bandwidth) over its kernels' device time in the traced single-image decodes (%)."""

from portbench.core import readers


def read(ctx):
    return readers.roofline_pct(ctx, "rans_decode")
