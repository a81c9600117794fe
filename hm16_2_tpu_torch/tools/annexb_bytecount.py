"""Annex-B byte accounting util (utils/annexBbytecount.cpp dual):
counts bytes per NAL-unit category in an Annex-B stream.

Usage: python -m hm16_2_tpu_torch.tools.annexb_bytecount stream.bin
"""

from __future__ import annotations

import sys

from hm16_2_tpu_torch.bitstream.bitio import split_annexb

NAL_NAMES = {
    32: "VPS", 33: "SPS", 34: "PPS", 39: "SEI(prefix)", 40: "SEI(suffix)",
    19: "IDR_W_RADL", 20: "IDR_N_LP", 21: "CRA",
    0: "TRAIL_N", 1: "TRAIL_R", 2: "TSA_N", 3: "TSA_R",
    6: "RADL_N", 7: "RADL_R", 8: "RASL_N", 9: "RASL_R",
}


def count(data: bytes):
    per_type: dict[int, list] = {}
    total_nal = 0
    for nal in split_annexb(data):
        t = (nal[0] >> 1) & 63
        e = per_type.setdefault(t, [0, 0])
        e[0] += 1
        e[1] += len(nal)
        total_nal += len(nal)
    return per_type, total_nal, len(data) - total_nal


def main(argv=None):
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("usage: annexb_bytecount <stream.bin>", file=sys.stderr)
        return 2
    data = open(args[0], "rb").read()
    per_type, total_nal, sc_bytes = count(data)
    vcl = nonvcl = 0
    print(f"{'NAL type':<14} {'count':>6} {'bytes':>10}")
    for t in sorted(per_type):
        cnt, byt = per_type[t]
        name = NAL_NAMES.get(t, f"type{t}")
        print(f"{name:<14} {cnt:6d} {byt:10d}")
        if t <= 31:
            vcl += byt
        else:
            nonvcl += byt
    print(f"{'VCL total':<14} {'':6} {vcl:10d}")
    print(f"{'non-VCL total':<14} {'':6} {nonvcl:10d}")
    print(f"{'start codes':<14} {'':6} {sc_bytes:10d}")
    print(f"{'file total':<14} {'':6} {len(data):10d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
