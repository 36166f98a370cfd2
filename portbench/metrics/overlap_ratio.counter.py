"""overlap_ratio.counter: the share of the window's wave-busy time in
which two or more waves were open, in %, from the wave scheduler's time
counts (`AskBatcher.stats()` `waves_overlap_s` over `waves_busy_s`, read
before and after the window)."""


def read(ctx):
    c = ctx.counters
    if not c.get("busy_s"):
        return None
    return 100.0 * c["overlap_s"] / c["busy_s"]
