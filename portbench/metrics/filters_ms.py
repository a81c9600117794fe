"""Host milliseconds per picture in the loop filters: deblocking and SAO
(`Encoder.stage_ms["filters"]`, summed over the window's pictures)."""


def read(ctx):
    return ctx.stage_per_picture("filters")
