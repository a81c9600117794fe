"""K2's share of its roofline: for every RD launch of `size_rd_kernel` in
the window, the least time the card could take for that block size over the
whole picture (frozen counts in pb_work), summed, over the launches' device
time.  The block size is read from the kernel's template argument."""

import re

import pb_work

_RD = re.compile(r"size_rd_kernel<(\d+), ?true>|size_rd_kernelILi(\d+)ELb1E")


def read(ctx):
    least = dev = 0.0
    for name, a, b in ctx.device_events:
        m = _RD.search(name)
        if m is None:
            continue
        s = int(m.group(1) or m.group(2))
        least += pb_work.least_s(*pb_work.k2_size_rd(ctx.height, ctx.width,
                                                     s))[0]
        dev += b - a
    if dev <= 0:
        return None
    return 100.0 * least / dev
