"""K5's share of its roofline: the least time the card could take for the
integer ME of the window's P and B plans (frozen counts in pb_work_me, from
each plan's live references), over the device time of K5's plan-path
kernels in the window: the downsampling, the coarse grid and its pyramid,
and the argmin and refinement with the plan's MVD-bin model (`MvdBins`;
the per-CU search's `MvLog` variants are not the plan's)."""

import pb_work_me

_SHARED = ("me_down_kernel", "me_coarse8_kernel", "me_quad_kernel")
_TEMPLATED = ("me_argmin_kernel", "me_refine_kernel")


def _k5(name):
    return any(k in name for k in _SHARED) or \
        (any(k in name for k in _TEMPLATED) and "MvdBins" in name)


def read(ctx):
    dev = sum(b - a for name, a, b in ctx.device_events if _k5(name))
    if dev <= 0 or not ctx.plans:
        return None
    least = sum(pb_work_me.least_s(refs, ctx.height, ctx.width)
                for refs, _ in ctx.plans)
    return 100.0 * least / dev
