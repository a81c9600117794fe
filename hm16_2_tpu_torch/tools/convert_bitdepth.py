"""YUV bit-depth conversion util (utils/convert_NtoMbit_YCbCr.cpp dual).

Usage: python -m hm16_2_tpu_torch.tools.convert_bitdepth in.yuv out.yuv \
           -wdt W -hgt H --InputBitDepth N --OutputBitDepth M [--c420|--c444]

Up-shift multiplies by 2^(M-N); down-shift rounds ((x + (1<<(s-1))) >> s)
like TVideoIOYuv's scalePlane.
"""

from __future__ import annotations

import sys

import numpy as np

from hm16_2_tpu_torch.config.options import Options
from hm16_2_tpu_torch.io.yuv import read_yuv_frame, write_yuv_frame


def convert_plane(p: np.ndarray, bd_in: int, bd_out: int) -> np.ndarray:
    if bd_out >= bd_in:
        return p << (bd_out - bd_in)
    s = bd_in - bd_out
    return np.clip((p + (1 << (s - 1))) >> s, 0, (1 << bd_out) - 1)


def main(argv=None):
    o = Options()
    o.add("SourceWidth", 0, short="wdt")
    o.add("SourceHeight", 0, short="hgt")
    o.add("InputBitDepth", 8)
    o.add("OutputBitDepth", 10)
    o.add("NumFrames", 10 ** 9, short="f")
    o.add("ChromaFormat", 420)
    rest = o.parse_cli(sys.argv[1:] if argv is None else argv)
    if len(rest) != 2 or not o["SourceWidth"]:
        print("usage: convert_bitdepth in.yuv out.yuv -wdt W -hgt H "
              "--InputBitDepth N --OutputBitDepth M", file=sys.stderr)
        return 2
    cf = {400: 0, 420: 1, 422: 2, 444: 3}[o["ChromaFormat"]]
    bd_in, bd_out = o["InputBitDepth"], o["OutputBitDepth"]
    fin = open(rest[0], "rb")
    fout = open(rest[1], "wb")
    n = 0
    while n < o["NumFrames"]:
        planes = read_yuv_frame(fin, o["SourceWidth"], o["SourceHeight"],
                                chroma_format_idc=cf, file_bit_depth=bd_in)
        if planes is None:
            break
        out = [convert_plane(p, bd_in, bd_out) for p in planes]
        write_yuv_frame(fout, out, [bd_out] * len(out))
        n += 1
    print(f"converted {n} frames {bd_in}->{bd_out} bit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
