"""The check turns `correct` false when the timed path is broken underneath
(on the CPU, at a small size, with the card's look skipped).  Faults: an
access unit altered where it is produced; a step that returns its state
unchanged (the plan, and the reference pictures); half of the picture left
out of the plan; and work the configuration asks for left undone: coding
at a higher QP, SAO switched off, one active reference where the GOP table
asks for two.  The cells run on one chip, so no exchange between chips can
be left out."""

import numpy as np
import pytest
import torch
from pb_testlib import small_cell

import run
from hm16_2_tpu_torch.encode import intra_rd
from hm16_2_tpu_torch.encode.top import Encoder

CPU = torch.device("cpu")


def _run(name, w, h, seconds, seed=918273645):
    cfg, traffic, metrics = small_cell(name, w, h)
    return run.run_cell(cfg, traffic, metrics, seed, seconds, 0, CPU,
                        log=lambda s: None)


def _wrap_plan_device(monkeypatch, change):
    orig = intra_rd._plan_device

    def broken(*a, **kw):
        return change(orig(*a, **kw))
    monkeypatch.setattr(intra_rd, "_plan_device", broken)


def test_sound_run_is_correct():
    assert _run("ai-main-1080p.qp32", 192, 128, 3)["correct"] is True


def test_altered_access_unit(monkeypatch):
    orig = Encoder._encode_one

    def altered(self, planes, poc, sh, **kw):
        au = orig(self, planes, poc, sh, **kw)
        if poc < 2:                     # warm-up pictures stay sound
            return au
        b = bytearray(au)
        b[len(b) * 2 // 3] ^= 0x10
        return bytes(b)
    monkeypatch.setattr(Encoder, "_encode_one", altered)
    res = _run("ai-main-1080p.qp32", 192, 128, 3)
    assert res["correct"] is False
    assert res["checks"]["recon_mismatch"]["value"] + \
        res["checks"]["hash_mismatch"]["value"] + \
        res["checks"]["undecodable"]["value"] > 0


def test_plan_state_unchanged(monkeypatch):
    first = []

    def stale(packed):
        if not first:
            first.append(packed.clone())
        return first[0].clone()
    _wrap_plan_device(monkeypatch, stale)
    res = _run("ai-main-1080p.qp32", 192, 128, 3)
    assert res["correct"] is False
    assert res["checks"]["plan_mismatch"]["value"] > 0


def test_half_of_the_picture_left_out(monkeypatch):
    def half(packed):
        out = packed.clone()
        out[:, out.shape[1] // 2:] = 0
        return out
    _wrap_plan_device(monkeypatch, half)
    res = _run("ai-main-1080p.qp32", 192, 128, 3)
    assert res["correct"] is False
    assert res["checks"]["plan_mismatch"]["value"] > 0


def test_reference_pictures_unchanged(monkeypatch):
    """Random access: after the warm-up, every picture the encoder keeps
    for reference keeps the samples of the one before it."""
    from hm16_2_tpu_torch.decode import refpics
    orig = refpics.DPB.add
    last = []

    def add(self, pic):
        if pic.poc > 8 and last:
            pic.rec = [p.copy() for p in last[-1]]
        last.append(pic.rec)
        return orig(self, pic)
    monkeypatch.setattr(refpics.DPB, "add", add)
    res = _run("ra-main-1080p.qp32", 128, 64, 30)
    assert res["correct"] is False
    assert res["checks"]["recon_mismatch"]["value"] + \
        res["checks"]["hash_mismatch"]["value"] > 0


def _config_changed(monkeypatch, change):
    orig = Encoder.__init__

    def init(self, cfg, device):
        change(cfg)
        orig(self, cfg, device)
    monkeypatch.setattr(Encoder, "__init__", init)


@pytest.mark.parametrize("fault", ["qp_plus_one", "sao_off"])
def test_configuration_not_honoured(monkeypatch, fault):
    def change(cfg):
        if fault == "qp_plus_one":
            cfg.qp += 1
        else:
            cfg.sao = False
    _config_changed(monkeypatch, change)
    res = _run("ai-main-1080p.qp32", 192, 128, 3)
    assert res["correct"] is False
    assert res["checks"]["params_mismatch"]["value"] > 0


def test_one_active_reference(monkeypatch):
    orig = Encoder._ra_slice_header

    def one(self, *a, **kw):
        sh = orig(self, *a, **kw)
        sh.num_ref_idx = [min(n, 1) for n in sh.num_ref_idx]
        return sh
    monkeypatch.setattr(Encoder, "_ra_slice_header", one)
    res = _run("ra-main-1080p.qp32", 128, 64, 30)
    assert res["correct"] is False
    assert res["checks"]["params_mismatch"]["value"] > 0
