"""One encode request: host time in the program's per-pixel copies (the pixels stacked into one array, the pinned staging copies of the upload), median (ms)."""

from portbench.core import program_spans

ENCODE_COPIES = [
    "frave.encode.stack",
    "frave.pin",
]


def read(ctx):
    return program_spans.request_ms(ctx, "encode", ENCODE_COPIES)
