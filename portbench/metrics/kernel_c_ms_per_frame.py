"""kernel_c_ms_per_frame: the device milliseconds of kernel C's symbol
(csrc/packet.cu, the packet traversal's closest hit) in the traced
frames, a frame. Nothing to read where kernel C did not run."""

SYMBOL = "packet_hit_kernel"


def read(ctx):
    busy = ctx.trace.kernel_seconds(SYMBOL)
    return busy * 1e3 / ctx.units if busy > 0.0 else None
