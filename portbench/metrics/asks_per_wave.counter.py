"""asks_per_wave.counter: asks a wave carried over the window, from the
ask batcher's counts (`AskBatcher.stats()` `asks` and `batches`, read
before and after the window)."""


def read(ctx):
    c = ctx.counters
    if not c.get("waves"):
        return None
    return c["asks"] / c["waves"]
