"""DeltaQpRD through the port's encoder (hm16_2_tpu_torch.encode.top)
against the JAX package's: each picture is trial-encoded at the 2n+1 QPs
around its slice QP and then coded at the best, so the frame plan runs
2n+2 times per picture, on the same planes.  The same Annex-B bytes, every
picture decoding with its MD5 hash intact, and the encoder CLI's
`--DeltaQpRD`.
"""

import os

import pytest
import torch

from hm16_2_tpu.encode import top as RT
from hm16_2_tpu_torch.encode import inter_plan as PP
from hm16_2_tpu_torch.encode import intra_rd as PR
from hm16_2_tpu_torch.encode import top as PT
from make_fixtures import make_yuv, write_yuv
from test_torch_encode import _decode_ok, _push_all

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spy(monkeypatch, mod, log):
    """Record (module, slice QP) of every plan `mod.plan_frame` makes."""
    plan_frame = mod.plan_frame

    def spy(*a, **kw):
        log.append((mod.__name__.rsplit(".", 1)[-1], a[2].qp
                    if mod is PP else a[2]))
        return plan_frame(*a, **kw)

    monkeypatch.setattr(mod, "plan_frame", spy)


@pytest.mark.parametrize("n,kw,kinds", [
    (2, dict(intra_period=1), ["intra_rd"] * 2),
    (3, dict(intra_period=0, gop="ld"), ["intra_rd"] + ["inter_plan"] * 2)],
    ids=["ai", "ldp"])
def test_dqp_stream_same_bytes(monkeypatch, n, kw, kinds):
    """delta_qp_rd=1 on all-intra and on low-delay P: the bytes of the JAX
    package, and four plans per picture (trials at QP - 1, QP and QP + 1,
    then the winner), each at its trial's QP."""
    frames = make_yuv(136, 72, n, seed=42)
    cfg = lambda: RT.EncoderConfig(136, 72, qp=32, delta_qp_rd=1, **kw)
    ref = _push_all(RT.Encoder(cfg()), frames)
    plans = []
    _spy(monkeypatch, PR, plans)
    _spy(monkeypatch, PP, plans)
    got = _push_all(PT.Encoder(cfg(), CPU), frames)
    assert len(got) == n and got == ref
    _decode_ok(b"".join(got), n)
    assert [k for k, _ in plans] == [k for k in kinds for _ in range(4)]
    for i in range(n):
        qps = [q for _, q in plans[4 * i:4 * i + 4]]
        assert qps[1:3] == [qps[0] + 1, qps[0] + 2]
        assert qps[0] <= qps[3] <= qps[2]


def test_cli_delta_qp_rd_same_bytes(tmp_path):
    """The encoder CLI with `--DeltaQpRD=1` on HM's All Intra Main cfg: the
    port's and the reference's write the same stream."""
    from hm16_2_tpu.tools import encode as RE
    from hm16_2_tpu_torch.tools import encode as PE
    yuv = tmp_path / "in.yuv"
    write_yuv(str(yuv), make_yuv(136, 72, 2, seed=42))
    args = ["-c", os.path.join(ROOT, "cfg", "encoder_intra_main.cfg"),
            "-i", str(yuv), "-wdt", "136", "-hgt", "72", "-f", "2",
            "--DeltaQpRD=1"]
    assert RE.main(args + ["-b", str(tmp_path / "ref.bin")]) == 0
    assert PE.main(args + ["-b", str(tmp_path / "got.bin"),
                           "--Device", "cpu"]) == 0
    got = (tmp_path / "got.bin").read_bytes()
    assert got == (tmp_path / "ref.bin").read_bytes()
    _decode_ok(got, 2)
