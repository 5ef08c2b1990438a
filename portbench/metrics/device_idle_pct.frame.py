"""device_idle_pct.frame: 100 minus the share of the traced frames'
window that the union of the device's kernel, copy and set intervals
covers."""


def read(ctx):
    t = ctx.trace
    return t.idle_pct() if t.window_s > 0.0 and t.busy_s > 0.0 else None
