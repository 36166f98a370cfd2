"""step_ms.ring: device milliseconds a ring step, from the CUDA events
that bracket the window's `run` calls before the traced slice, over the
steps those calls ran."""


def read(ctx):
    c = ctx.counters
    if not c.get("timed_steps"):
        return None
    return c["timed_device_ms"] / c["timed_steps"]
