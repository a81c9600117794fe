"""Host milliseconds per picture in the plan stage: the dispatch of the
frame plan and the wait for it (`Encoder.stage_ms["plan"]`, summed over
the window's pictures).  Time the plan overlaps with a commit is not in it."""


def read(ctx):
    return ctx.stage_per_picture("plan")
