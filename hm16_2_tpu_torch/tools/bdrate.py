"""Bjontegaard-Delta rate (BD-rate) harness vs HM anchors.

SURVEY.md section 4 item (d): encode sequences at QP {22,27,32,37} with both
this encoder and the reference HM binary, then report the BD-rate (average
bitrate delta at equal quality, piecewise-cubic log-rate integration per
VCEG-M33).  Negative numbers mean we need fewer bits than HM.

Usage:
  python -m hm16_2_tpu_torch.tools.bdrate --input /tmp/hevc_data/bq416.yuv \
      --wdt 416 --hgt 240 -f 4 --mode ai [--qps 22,27,32,37]

Prints one JSON line: {"bdrate_pct": ..., "points": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HM_ENC = "/tmp/hmref/bin/TAppEncoderStatic"
HM_CFG = "/tmp/hmref/cfg"

MODE_CFG = {
    "ai": "encoder_intra_main.cfg",
    "ldp": "encoder_lowdelay_P_main.cfg",
    "ra": "encoder_randomaccess_main.cfg",
}


def psnr(mse, peak=255.0):
    if mse <= 0:
        return 99.999
    return 10.0 * np.log10(peak * peak / mse)


def seq_psnr_bits(bitstream: bytes, orig_frames, w, h) -> tuple[float, float]:
    """Decode with our own decoder; returns (mean Y-PSNR, total bits)."""
    from hm16_2_tpu_torch.decode.top import Decoder
    pics = sorted(Decoder().decode_stream(bitstream), key=lambda p: p.poc)
    assert len(pics) == len(orig_frames), (len(pics), len(orig_frames))
    mses = []
    for p, org in zip(pics, orig_frames):
        dif = p.planes[0].astype(np.float64) - org[0].astype(np.float64)
        mses.append(float((dif * dif).mean()))
    return float(np.mean([psnr(m) for m in mses])), len(bitstream) * 8


def read_yuv_frames(path, w, h, n):
    frames = []
    fs = w * h * 3 // 2
    raw = np.fromfile(path, dtype=np.uint8, count=fs * n)
    for i in range(n):
        f = raw[i * fs:(i + 1) * fs]
        y = f[: w * h].reshape(h, w).astype(np.int32)
        u = f[w * h: w * h * 5 // 4].reshape(h // 2, w // 2).astype(np.int32)
        v = f[w * h * 5 // 4:].reshape(h // 2, w // 2).astype(np.int32)
        frames.append([y, u, v])
    return frames


def encode_ours(frames, w, h, qp, mode, device=None, **cfg_kw):
    """Our encoder's stream of `frames` and its seconds; the frame plans
    run on `device`, a torch.device (default: the card)."""
    import torch
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    device = torch.device("cuda") if device is None else device
    t0 = time.time()
    if mode == "ai":
        cfg = EncoderConfig(w, h, qp=qp, intra_period=1, **cfg_kw)
        enc = Encoder(cfg, device)
        aus = [enc.encode_frame([p.copy() for p in f], i)
               for i, f in enumerate(frames)]
    elif mode == "ldp":
        cfg = EncoderConfig(w, h, qp=qp, intra_period=0, gop="ld", **cfg_kw)
        enc = Encoder(cfg, device)
        aus = []
        for i, f in enumerate(frames):
            aus += enc.push_frame([p.copy() for p in f], i)
        aus += enc.flush()
    else:
        cfg = EncoderConfig(w, h, qp=qp, intra_period=0, gop="ra8", **cfg_kw)
        enc = Encoder(cfg, device)
        aus = []
        for i, f in enumerate(frames):
            aus += enc.push_frame([p.copy() for p in f], i)
        aus += enc.flush()
    dt = time.time() - t0
    return b"".join(aus), dt


def encode_hm(src, w, h, n, qp, mode) -> bytes:
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "o.bin")
        r = subprocess.run(
            [HM_ENC, "-c", os.path.join(HM_CFG, MODE_CFG[mode]),
             "-i", src, "-wdt", str(w), "-hgt", str(h), "-fr", "30",
             "-f", str(n), "-b", out, "--SEIDecodedPictureHash=1",
             "-q", str(qp)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(r.stdout + r.stderr)
        return open(out, "rb").read()


def bd_rate(rate_a, psnr_a, rate_b, psnr_b) -> float:
    """BD-rate of B vs A in percent (piecewise cubic in log-rate)."""
    la, lb = np.log(rate_a), np.log(rate_b)
    deg = min(3, len(psnr_a) - 1, len(psnr_b) - 1)
    pa = np.polyfit(psnr_a, la, deg)
    pb = np.polyfit(psnr_b, lb, deg)
    lo = max(min(psnr_a), min(psnr_b))
    hi = min(max(psnr_a), max(psnr_b))
    ia = np.polyval(np.polyint(pa), [lo, hi])
    ib = np.polyval(np.polyint(pb), [lo, hi])
    avg = (ib[1] - ib[0] - (ia[1] - ia[0])) / (hi - lo)
    return float((np.exp(avg) - 1.0) * 100.0)


def run(input_path, w, h, n, mode, qps, cfg_kw=None, verbose=True,
        device=None):
    frames = read_yuv_frames(input_path, w, h, n)
    ours_r, ours_p, hm_r, hm_p = [], [], [], []
    points = {}
    for qp in qps:
        bs, dt = encode_ours(frames, w, h, qp, mode, device,
                             **(cfg_kw or {}))
        op, ob = seq_psnr_bits(bs, frames, w, h)
        hbs = encode_hm(input_path, w, h, n, qp, mode)
        hp, hb = seq_psnr_bits(hbs, frames, w, h)
        ours_r.append(ob); ours_p.append(op)
        hm_r.append(hb); hm_p.append(hp)
        points[qp] = {"ours_bits": ob, "ours_psnr": round(op, 4),
                      "hm_bits": hb, "hm_psnr": round(hp, 4),
                      "ours_sec": round(dt, 2)}
        if verbose:
            print(f"  qp{qp}: ours {ob/1000:.1f}kb {op:.3f}dB | "
                  f"hm {hb/1000:.1f}kb {hp:.3f}dB", file=sys.stderr)
    bd = bd_rate(hm_r, hm_p, ours_r, ours_p)
    return bd, points


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--wdt", type=int, required=True)
    ap.add_argument("--hgt", type=int, required=True)
    ap.add_argument("-f", "--frames", type=int, required=True)
    ap.add_argument("--mode", choices=list(MODE_CFG), default="ai")
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--Device", default="cuda",
                    help="torch device of the frame plans: cuda or cpu")
    a = ap.parse_args(argv)
    qps = [int(q) for q in a.qps.split(",")]
    import torch
    bd, points = run(a.input, a.wdt, a.hgt, a.frames, a.mode, qps,
                     device=torch.device(a.Device))
    print(json.dumps({"bdrate_pct": round(bd, 2), "mode": a.mode,
                      "points": points}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
