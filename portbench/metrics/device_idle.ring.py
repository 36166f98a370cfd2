"""device_idle.ring: the share of the traced slice in which nothing ran
on the card, in %: one minus the union of its kernel, copy and memset
intervals over the slice."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
