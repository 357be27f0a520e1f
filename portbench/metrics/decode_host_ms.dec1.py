"""One decode request: host time in the program's decode steps (parse, assemble, upload, launch, wrap), median (ms)."""

from portbench.core import program_spans

DECODE_STEPS = [
    "frave.container.parse",
    "frave.decode.assemble",
    "frave.decode.upload",
    "frave.decode.launch",
    "frave.decode.wrap",
]


def read(ctx):
    return program_spans.request_ms(ctx, "decode", DECODE_STEPS)
