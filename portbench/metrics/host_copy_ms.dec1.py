"""One decode request: host time in the program's per-pixel copies (the wire arrays widened for the upload, the pinned staging copies, the pixels wrapped as images), median (ms)."""

from portbench.core import program_spans

DECODE_COPIES = [
    "frave.decode.widen",
    "frave.pin",
    "frave.decode.wrap",
]


def read(ctx):
    # a program without the widen span has only the wrap of the three: it reads nothing
    if ctx.trace is None or not program_spans.program_intervals(ctx.trace, {DECODE_COPIES[0]}):
        return None
    return program_spans.request_ms(ctx, "decode", DECODE_COPIES)
