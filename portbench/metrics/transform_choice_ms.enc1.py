"""One encode request: host time in the program's transform choice (frave.encode.transform), median (ms)."""

from portbench.core import program_spans


def read(ctx):
    return program_spans.request_ms(ctx, "encode", ["frave.encode.transform"])
