"""A stream batch: the caller's host time in the encode and decode dispatches (frave.encode.dispatch, frave.decode.dispatch), over the traced calls' batches (ms a batch)."""

from portbench.core import program_spans


def read(ctx):
    return program_spans.batch_ms(ctx, ["frave.encode.dispatch", "frave.decode.dispatch"])
