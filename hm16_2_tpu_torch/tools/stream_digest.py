"""SHA-256 of the 1920x1080 streams that chip_smoke.py encodes on the card
(`make_yuv(1920, 1080, 9, seed=42)`, QP 32): all-intra over 3 frames
(`encode_stream`), low-delay P over IDR + 4 P pictures and random access
over IDR + 8 B pictures (`push_frame` / `flush`), and the per-CU search
(HM16_NO_INTER_PLAN, RRSP) over IDR + 1 P picture (`encode_frame`).

    python3 hm16_2_tpu_torch/tools/stream_digest.py [--root DIR]

--root names the checkout whose `hm16_2_tpu_torch` encodes (default: the
one holding this file), so that two trees unpacked side by side are held
to the same bytes in one call.  Prints the card's name and power limit, a
line per stream (pictures, bytes, digest; for LDP and RA also the
`stage_ms` per picture after the IDR, as chip_smoke.py prints it), and one
JSON object.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
W, H, QP = 1920, 1080, 32


def streams(frames, dev):
    """(name, AUs, stage_ms per picture after the IDR or None) of each
    stream, encoded on `dev`."""
    from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
    planes = [[p.astype("int32") for p in f] for f in frames]

    def pushed(cfg, n):
        enc = Encoder(cfg, dev)
        aus = enc.push_frame(planes[0], 0)
        before = dict(enc.stage_ms)
        for poc in range(1, n):
            aus += enc.push_frame(planes[poc], poc)
        aus += enc.flush()
        return aus, {k: (v - before.get(k, 0.0)) / (n - 1)
                     for k, v in enc.stage_ms.items()}

    yield "AI", list(Encoder(EncoderConfig(W, H, qp=QP, intra_period=1),
                             dev).encode_stream(frames[:3])), None
    yield "LDP", *pushed(EncoderConfig(W, H, qp=QP, intra_period=0,
                                       gop="ld"), 5)
    yield "RA", *pushed(EncoderConfig(W, H, qp=QP, intra_period=32,
                                      gop="ra8"), 9)
    old = os.environ.get("HM16_NO_INTER_PLAN")
    os.environ["HM16_NO_INTER_PLAN"] = "1"
    try:
        enc = Encoder(EncoderConfig(W, H, qp=QP, intra_period=8, rrsp=True),
                      dev)
        yield "per-CU search", [enc.encode_frame(planes[i], i)
                                for i in range(2)], None
    finally:
        if old is None:
            del os.environ["HM16_NO_INTER_PLAN"]
        else:
            os.environ["HM16_NO_INTER_PLAN"] = old


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose hm16_2_tpu_torch encodes")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("stream_digest: no CUDA device")
    sys.path.insert(1, os.path.join(REPO, "tests"))
    from intra_bench import card_line
    from make_fixtures import make_yuv
    card = card_line()
    label = args.label or root
    res = {}
    for name, aus, stage in streams(make_yuv(W, H, 9, seed=42),
                                    torch.device("cuda")):
        data = b"".join(aus)
        res[name] = {"pictures": len(aus), "bytes": len(data),
                     "sha256": hashlib.sha256(data).hexdigest(),
                     "stage_ms": stage}
        print(f"{label}: {name} {W}x{H}: {len(aus)} AUs, {len(data)} bytes, "
              f"sha256 {res[name]['sha256']}"
              + (f"; stage_ms per picture after the IDR "
                 f"{json.dumps(stage)}" if stage else "") + f"  [{card}]",
              flush=True)
    print(json.dumps({"root": label, "card": card, "streams": res}),
          flush=True)


if __name__ == "__main__":
    main()
