"""Kernel launches per picture: the change of `kernels.LAUNCHES` over the
window, over the pictures whose access units came back in it."""


def read(ctx):
    if not ctx.pictures:
        return None
    return ctx.launches / ctx.pictures
