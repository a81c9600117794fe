"""Decoder CLI (TAppDecoder dual): decode an Annex-B HEVC stream to YUV.

Usage: python -m hm16_2_tpu_torch.tools.decode stream.bin [-o out.yuv] [--stats]
           [--seidump] [-d BITDEPTH]
Prints per-POC lines with hash verdicts like the reference decoder;
--stats prints a per-syntax-element bin/bit table afterwards (the
TAppDecoderAnalyser / TComCodingStatistics.h:49-100 analogue);
--seidump lists every SEI message (SEIread.cpp trace dual); -d scales
the output file to a different bit depth (TAppDecCfg OutputBitDepth).
"""

import argparse
import sys

from hm16_2_tpu_torch.decode.top import Decoder
from hm16_2_tpu_torch.io.yuv import write_yuv_frame


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("bitstream")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--stats", action="store_true",
                    help="per-syntax bit statistics (analyser decoder)")
    ap.add_argument("--seidump", action="store_true",
                    help="print every SEI message in the stream")
    ap.add_argument("-d", "--output-bit-depth", type=int, default=0,
                    help="output file bit depth (0 = internal)")
    ap.add_argument("--field-weave", action="store_true",
                    help="weave field pairs into frames on output "
                         "(field-coded streams)")
    args = ap.parse_args(argv)

    from hm16_2_tpu_torch.bitstream import cabac
    if args.stats:
        cabac.STATS = cabac.BitStats()
    dec = Decoder()
    data = open(args.bitstream, "rb").read()
    if args.seidump:
        from hm16_2_tpu_torch.headers.sei import dump_stream_sei
        for line in dump_stream_sei(data):
            print(line)
    pics = dec.decode_stream(data)
    sps = next(iter(dec.sps_map.values()))
    bds = [sps.bit_depth_luma] + [sps.bit_depth_chroma] * 2
    fbds = [args.output_bit_depth] * 3 if args.output_bit_depth else None
    out = open(args.output, "wb") if args.output else None
    ordered = sorted(pics, key=lambda x: x.poc)
    if args.field_weave:
        from hm16_2_tpu_torch.io.yuv import interleave_fields
        for p in ordered:
            verdict = {True: "(OK)", False: "(MISMATCH)", None: ""}[p.hash_ok]
            print(f"POC {p.poc:4d} decoded {verdict}")
        if out:
            for a, b in zip(ordered[::2], ordered[1::2]):
                write_yuv_frame(out, interleave_fields(a.planes, b.planes),
                                bds, file_bit_depths=fbds)
    else:
        for p in ordered:
            verdict = {True: "(OK)", False: "(MISMATCH)", None: ""}[p.hash_ok]
            print(f"POC {p.poc:4d} decoded {verdict}")
            if out:
                write_yuv_frame(out, p.planes, bds, file_bit_depths=fbds)
    if out:
        out.close()
    if args.stats and cabac.STATS is not None:
        print()
        print("Decoder statistics (estimated CABAC bits per syntax class)")
        print(cabac.STATS.table())
        cabac.STATS = None
    return 1 if dec.hash_failures else 0


if __name__ == "__main__":
    sys.exit(main())
