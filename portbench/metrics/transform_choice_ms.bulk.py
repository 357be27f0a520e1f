"""A stream batch: host time in the program's transform choice (frave.encode.transform), over the traced calls' batches (ms a batch)."""

from portbench.core import program_spans


def read(ctx):
    return program_spans.batch_ms(ctx, ["frave.encode.transform"])
