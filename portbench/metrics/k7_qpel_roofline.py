"""K7's share of its roofline: the least time the card could take for the
quarter-pel and bi refinements of the window's P and B plans (frozen counts
in pb_work, from each plan's shapes and live references), over the device
time of `frac_refine_kernel` in the window."""

import pb_work


def read(ctx):
    dev = sum(b - a for name, a, b in ctx.device_events
              if "frac_refine_kernel" in name)
    if dev <= 0 or not ctx.plans:
        return None
    least = sum(pb_work.least_s(ops, nb)[0]
                for refs, bi in ctx.plans
                for ops, nb in pb_work.k7_launches(ctx.height, ctx.width,
                                                   refs, bi))
    return 100.0 * least / dev
