"""Helpers of the benchmark's CPU tests (the paths are set in conftest.py)."""

import os

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)


class FakeTrace:
    """Stands in for the device trace on the CPU: one K2 RD launch at
    s = 8, one K7 launch, one copy, inside the window."""

    def start(self):
        pass

    def stop(self):
        pass

    def events(self, start, end):
        return [("void size_rd_kernel<8, true>(IntraArgs)", 0.010, 0.020),
                ("frac_refine_kernel(short const*, int)", 0.030, 0.050),
                ("Memcpy HtoD (Pageable -> Device)", 0.045, 0.060)]


def small_cell(name, w, h):
    """A cell's configuration, traffic and metric entries with the picture
    cut to w x h (CPU tests only), and frames made for 20 pictures/s, the
    small pictures' rate on a fast CPU being well above 1080p's on the card."""
    import run
    _, cfg, traffic, metrics = run.load_cell(name)
    return dict(cfg, width=w, height=h, today_fps=20), traffic, metrics
