"""A stream batch: the caller's time waiting on the stream's worker threads (frave.stream.wait), over the traced calls' batches (ms a batch)."""

from portbench.core import program_spans


def read(ctx):
    return program_spans.batch_ms(ctx, ["frave.stream.wait"])
