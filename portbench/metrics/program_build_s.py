"""Host wall of the explicit schedule and program build for the cell's shape at set-up (s)."""


def read(ctx):
    return ctx.program_build_s
