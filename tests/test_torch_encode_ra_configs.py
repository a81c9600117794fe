"""Random-access configurations the port's encoder admits, against the
JAX package's at 136x72: GOP 8 with CRA and with CRA plus recovery-point
refresh, two intra periods (the CRA refresh, its RASL pictures and the
flush tail), the plans run serially (HM16_NO_PLAN_PIPELINE, set for both
packages), and rate control of a GOP, whose model lambda reaches the
B-picture plans.  The same Annex-B bytes, every picture decoding with its
MD5 hash intact.
"""

import pytest
import torch

from hm16_2_tpu.encode import top as RT
from hm16_2_tpu_torch.encode import top as PT
from make_fixtures import make_yuv
from test_torch_encode import _decode_ok, _push_all

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("n,kw,env", [
    (10, dict(intra_period=8, decoding_refresh_type=2), None),
    (10, dict(intra_period=8, decoding_refresh_type=3), None),
    (19, dict(intra_period=16), None),
    (9, dict(intra_period=32), "HM16_NO_PLAN_PIPELINE"),
    (9, dict(intra_period=32, target_bps=200000, total_frames=9), None)],
    ids=["cra", "cra_recovery", "ip16", "no_pipeline", "rc"])
def test_ra_config_same_bytes(monkeypatch, n, kw, env):
    """RA GOP 8 through push_frame / flush; `env`, where given, is set to 1
    for both encoders."""
    if env:
        monkeypatch.setenv(env, "1")
    frames = make_yuv(136, 72, n, seed=42)
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, gop="ra8", **kw)
    ref = _push_all(RT.Encoder(cfg()), frames)
    got = _push_all(PT.Encoder(cfg(), CPU), frames)
    assert len(got) == n and got == ref
    _decode_ok(b"".join(got), n)
