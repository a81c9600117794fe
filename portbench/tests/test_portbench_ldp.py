"""The low-delay P cell on the CPU, cut to 128x64: HM-16.2's published GOP
table (four P pictures, QP offsets +3/+2/+3/+1, four active references, all
in the past) gives four references to every picture of the window, which
opens after POC 16; the check passes a sound run, the control fails it, and
one active reference where the table asks for four fails it."""

import json
import os

import torch
from pb_testlib import FakeTrace, PB, small_cell

import pb_check
import pb_drive
import pb_spec
import pb_trace
import run
from hevcref.headers import params as P
from hm16_2_tpu_torch.encode.top import Encoder

CPU = torch.device("cpu")
CELL = "ldp-main-1080p.qp32"


def test_published_table_lists_and_qps():
    with open(os.path.join(PB, "configs", "ctc-ldp-main-1080p.json")) as f:
        cfg = json.load(f)
    r = pb_check.Rules(dict(cfg["encoder"], qp=32, width=cfg["width"],
                            height=cfg["height"]))
    exp = r.expect(21)
    assert r.coding_order(6) == [0, 1, 2, 3, 4, 5]
    assert (exp[0].kind, exp[0].slice_type) == ("IDR", P.I_SLICE)
    want = {1: [0], 2: [1, 0], 5: [4, 0], 13: [12, 8, 4, 0],
            14: [13, 12, 8, 4], 15: [14, 12, 8, 4], 16: [15, 12, 8, 4],
            17: [16, 12, 8, 4], 20: [19, 16, 12, 8]}
    for p, l0 in want.items():
        assert exp[p].l0 == l0, p
    for p in range(1, 21):
        e = exp[p]
        assert (e.kind, e.slice_type, e.l1) == ("", P.P_SLICE, []), p
        assert e.qp == {1: 35, 2: 34, 3: 35, 0: 33}[p % 4], p


def _spy(monkeypatch):
    """Keeps the run's recorder, client and metric context, changing
    nothing of what they do."""
    seen = {}
    rec_init, client_init, reader = pb_drive.Recorder.__init__, \
        pb_drive.Client.__init__, pb_spec.reader

    def recorder(self, enc):
        rec_init(self, enc)
        seen["rec"] = self

    def client(self, enc, rec, frames, mode):
        client_init(self, enc, rec, frames, mode)
        seen["frames"] = frames

    def read_with(name, root=pb_spec.ROOT):
        read = reader(name, root)

        def keep(ctx):
            seen["ctx"] = ctx
            return read(ctx)
        return keep
    monkeypatch.setattr(pb_drive.Recorder, "__init__", recorder)
    monkeypatch.setattr(pb_drive.Client, "__init__", client)
    monkeypatch.setattr(pb_spec, "reader", read_with)
    monkeypatch.setattr(pb_trace, "DeviceTrace", FakeTrace)
    return seen


def test_four_references_in_the_window(monkeypatch):
    seen = _spy(monkeypatch)
    cfg, traffic, metrics = small_cell(CELL, 128, 64)
    res = run.run_cell(cfg, traffic, metrics, 3000000021, 3, 1, CPU,
                       log=lambda s: None, control=True)
    assert res["correct"] is True and res["failed"] == 0
    for k, v in res["checks"].items():
        assert v == {"value": 0, "limit": 0}, k
    assert res["control_checks"]["plan_mismatch"] > 0
    ctx, rec = seen["ctx"], seen["rec"]
    window = rec.order[-res["attempted"]:]
    assert min(window) > 16 and len(window) % 4 == 0
    assert ctx.plans == [(4, False)] * len(window)
    assert [rec.refs[p] for p in range(13, 17)] == [4] * 4
    # the check on a window whose only anchor is POC 16: the plans of
    # POC 17-19, each over four references, equal the reference's
    ccfg = dict(cfg, qp=int(traffic["qp"]))
    nums, failed, lines = pb_check.check(ccfg, seen["frames"], rec.pics,
                                         rec.order, list(range(13, 20)),
                                         5, CPU)
    assert nums == dict.fromkeys(pb_check.LIMITS, 0) and not failed
    assert lines[-1].endswith("plans [0, 17, 18, 19]"), lines[-1]


def test_one_active_reference_of_four(monkeypatch):
    orig = Encoder._ra_slice_header

    def one(self, *a, **kw):
        sh = orig(self, *a, **kw)
        sh.num_ref_idx = [min(n, 1) for n in sh.num_ref_idx]
        return sh
    monkeypatch.setattr(Encoder, "_ra_slice_header", one)
    cfg, traffic, metrics = small_cell(CELL, 128, 64)
    res = run.run_cell(cfg, traffic, metrics, 918273646, 3, 0, CPU,
                       log=lambda s: None)
    assert res["correct"] is False
    assert res["checks"]["params_mismatch"]["value"] > 0
