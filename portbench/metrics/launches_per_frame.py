"""launches_per_frame: the CUDA runtime's kernel-launch calls in the
traced frames, a frame."""


def read(ctx):
    n = ctx.trace.launches
    return n / ctx.units if n else None
