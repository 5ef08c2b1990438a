"""kernel_b_roofline_pct: kernel B's share of its roofline in a traced
frame. Numerator: the least time of the frame's path-tracing work
(roofline.frame_work: the reference's path statistics scaled to the
frame, the larger of operations over the fp32 peak and bytes over the
memory bandwidth); denominator: the device time of kernel B's symbol.
Nothing to read where kernel B did not run."""

from portbench import roofline

SYMBOL = "mega_kernel"


def read(ctx):
    busy = ctx.trace.kernel_seconds(SYMBOL)
    if busy <= 0.0 or ctx.work is None:
        return None
    return 100.0 * roofline.bound(*ctx.work) * ctx.units / busy
