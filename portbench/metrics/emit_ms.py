"""Host milliseconds per picture in entropy coding: the CABAC pass that writes the slice
(`Encoder.stage_ms["emit"]`, summed over the window's pictures)."""


def read(ctx):
    return ctx.stage_per_picture("emit")
