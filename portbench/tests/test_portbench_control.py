"""The control fails the check the encoder passes: the reference's plans
with their float32 costs rounded to bfloat16 (the nearest precision below
the configuration's) differ from its float32 plans on the pictures a run
checks, while the encoder's plans equal them.  On the card,
`portbench/control.py` reads the same at the cells' own size."""

import pytest
import torch
from pb_testlib import small_cell

import run

CPU = torch.device("cpu")


@pytest.mark.parametrize("name,w,h,seconds,seed", [
    ("ai-main-1080p.qp32", 192, 128, 3, 5),
    ("ai-main-1080p.qp22", 192, 128, 3, 6),
    ("ra-main-1080p.qp32", 128, 64, 30, 7)])
def test_control_fails_where_the_encoder_passes(name, w, h, seconds, seed):
    cfg, traffic, metrics = small_cell(name, w, h)
    res = run.run_cell(cfg, traffic, metrics, seed, seconds, 0, CPU,
                       log=lambda s: None, control=True)
    assert res["correct"] is True
    assert res["checks"]["plan_mismatch"]["value"] == 0
    assert res["control_checks"]["plan_mismatch"] > 0
