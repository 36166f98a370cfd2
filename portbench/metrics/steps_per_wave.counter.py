"""steps_per_wave.counter: region steps in the window over waves in the
window (the region system's step counter and the ask batcher's
`batches`, read before and after the window)."""


def read(ctx):
    c = ctx.counters
    if not c.get("waves"):
        return None
    return c["steps"] / c["waves"]
