"""What the check expects of each picture follows from the configuration
file alone: the published RA GOP table's lists at the start, in the steady
state, around the CRA, and the all-intra pictures."""

import json
import os

from pb_testlib import PB

import pb_check
from hevcref.headers import params as P


def _rules(name, qp=32):
    with open(os.path.join(PB, "configs", name + ".json")) as f:
        cfg = json.load(f)
    return pb_check.Rules(dict(cfg["encoder"], qp=qp, width=cfg["width"],
                               height=cfg["height"]))


def test_ra_lists_qps_and_refreshes():
    r = _rules("ctc-ra-main-1080p")
    exp = r.expect(49)
    assert r.coding_order(10) == [0, 8, 4, 2, 1, 3, 6, 5, 7, 16]
    want = {  # poc: (kind, qp, list 0, list 1)
        0: ("IDR", 32, [], []),
        8: ("", 33, [0], [0]),
        4: ("", 34, [0, 8], [8, 0]),
        2: ("", 35, [0, 4], [4, 8]),
        16: ("", 33, [8, 6], [8, 6]),
        12: ("", 34, [8, 6], [16, 8]),
        15: ("", 36, [14, 12], [16, 14]),
        32: ("CRA", 33, [], []),
        28: ("", 34, [24, 22], [32, 24]),
        25: ("", 36, [24, 26], [26, 28]),
        40: ("", 33, [32], [32]),
        36: ("", 34, [32, 40], [40, 32]),
        34: ("", 35, [32, 36], [36, 40]),
        39: ("", 36, [38, 36], [40, 38]),
    }
    for p, (kind, qp, l0, l1) in want.items():
        e = exp[p]
        assert (e.kind, e.qp, e.l0, e.l1) == (kind, qp, l0, l1), p
        assert e.slice_type == (P.I_SLICE if kind else P.B_SLICE)


def test_ai_every_picture_an_idr():
    r = _rules("ctc-ai-main-1080p", qp=22)
    exp = r.expect(5)
    assert r.coding_order(5) == [0, 1, 2, 3, 4]
    assert all((e.kind, e.slice_type, e.qp, e.l0, e.l1)
               == ("IDR", P.I_SLICE, 22, [], []) for e in exp.values())
