"""Percent of the window in which no kernel, copy or set ran on the card
(the union of the device intervals of `torch.profiler`'s trace)."""


def read(ctx):
    if ctx.window_s <= 0 or not ctx.device_events:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
