"""k1_roofline.counter: K1's share of its roofline in the traced slice, in %:
the least time its calls could take (their bytes at the card's memory
rate, yardstick/roofline.py) over their device time by kernel name."""

from portbench.yardstick.roofline import k1_share


def read(ctx):
    return k1_share(ctx.trace, ctx.counters, ctx.card)
