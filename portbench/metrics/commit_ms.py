"""Host milliseconds per picture in the host commit: the CU walk and reconstruction
(`Encoder.stage_ms["commit"]`, summed over the window's pictures)."""


def read(ctx):
    return ctx.stage_per_picture("commit")
