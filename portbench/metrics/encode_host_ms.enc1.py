"""One encode request: host time in the program's encode steps (transform choice, upload, launch, unpack, serialize), median (ms)."""

from portbench.core import program_spans

ENCODE_STEPS = [
    "frave.encode.transform",
    "frave.encode.upload",
    "frave.encode.launch",
    "frave.encode.unpack",
    "frave.container.serialize",
]


def read(ctx):
    return program_spans.request_ms(ctx, "encode", ENCODE_STEPS)
