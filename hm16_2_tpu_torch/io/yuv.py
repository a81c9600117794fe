"""Planar YUV file I/O (HM TVideoIOYuv.cpp semantics: little-endian
samples, 1 byte <= 8-bit, 2 bytes otherwise, planes Y then Cb then Cr).

Beyond the raw frame read/write, this covers the TVideoIOYuv surface the
apps use (TVideoIOYuv.h:66-76): bit-depth scaling between file and
internal depths (m_bitdepthShift semantics incl. MSB-extended input),
chroma-format conversion on read/write (420<->444 sample doubling /
decimation, TVideoIOYuv.cpp readPlane/writePlane), frame skipping, and
field split/interleave helpers for field coding.
"""

from __future__ import annotations

import numpy as np


def _scale_plane(p, shift, min_val, max_val):
    """bit-depth scale (TVideoIOYuv::scalePlane): left shift or rounded
    right shift, then clip to the internal range."""
    if shift > 0:
        p = p << shift
    elif shift < 0:
        p = (p + (1 << (-shift - 1))) >> (-shift)
    return np.clip(p, min_val, max_val)


def _chroma_dims(width, height, chroma_format_idc):
    sx = 1 if chroma_format_idc in (1, 2) else 0
    sy = 1 if chroma_format_idc == 1 else 0
    return width >> sx, height >> sy


def convert_chroma_format(planes, src_fmt, dst_fmt):
    """Chroma-format conversion by sample doubling / decimation (the
    file<->internal conversion TVideoIOYuv::read performs when the source
    format differs; HM doubles/halves samples without filtering)."""
    if src_fmt == dst_fmt or len(planes) == 1:
        return planes
    out = [planes[0]]
    h, w = planes[0].shape
    for c in (1, 2):
        p = planes[c]
        # upsample to 4:4:4 first
        if src_fmt == 1:
            p = p.repeat(2, axis=0).repeat(2, axis=1)
        elif src_fmt == 2:
            p = p.repeat(2, axis=1)
        # then decimate to the destination format
        if dst_fmt == 1:
            p = p[::2, ::2]
        elif dst_fmt == 2:
            p = p[:, ::2]
        elif dst_fmt == 0:
            continue
        out.append(np.ascontiguousarray(p[:h, :w]))
    return out


def write_yuv_frame(f, planes, bit_depths, file_bit_depths=None):
    """Write one frame; when file_bit_depths differ from the internal
    ones the planes are scaled (TVideoIOYuv::write bitdepth shift)."""
    for i, (plane, bd) in enumerate(zip(planes, bit_depths)):
        fbd = bd if file_bit_depths is None else file_bit_depths[i]
        p = np.asarray(plane)
        if fbd != bd:
            p = _scale_plane(p.astype(np.int64), fbd - bd, 0,
                             (1 << fbd) - 1)
        dt = np.uint8 if fbd <= 8 else np.uint16
        f.write(np.ascontiguousarray(p, dtype=dt).tobytes())


def frame_bytes(width, height, chroma_format_idc=1, file_bit_depth=8):
    bypp = 1 if file_bit_depth <= 8 else 2
    n = width * height
    if chroma_format_idc != 0:
        cw, ch = _chroma_dims(width, height, chroma_format_idc)
        n += 2 * cw * ch
    return n * bypp


def skip_frames(f, n, width, height, chroma_format_idc=1, file_bit_depth=8):
    """TVideoIOYuv::skipFrames: seek past n frames."""
    f.seek(n * frame_bytes(width, height, chroma_format_idc,
                           file_bit_depth), 1)


def read_yuv_frame(f, width, height, chroma_format_idc=1, file_bit_depth=8,
                   internal_bit_depth=None, msb_extended=False,
                   file_chroma_format_idc=None):
    """Read one frame, or None at EOF.

    internal_bit_depth: scale samples to this depth when it differs from
    the file depth.  msb_extended: >8-bit content stored in 16-bit files
    carries the value in the MSBs (TVideoIOYuv m_fileBitdepth vs
    m_MSBExtendedBitDepth); samples are right-shifted with rounding.
    file_chroma_format_idc: convert from the file's chroma format to
    chroma_format_idc by sample doubling/decimation."""
    src_fmt = chroma_format_idc if file_chroma_format_idc is None \
        else file_chroma_format_idc
    dt = np.uint8 if file_bit_depth <= 8 else np.uint16
    bypp = 1 if file_bit_depth <= 8 else 2
    planes = []
    dims = [(height, width)]
    if src_fmt != 0:
        cw, ch = _chroma_dims(width, height, src_fmt)
        dims += [(ch, cw)] * 2
    for (h, w) in dims:
        buf = f.read(h * w * bypp)
        if len(buf) < h * w * bypp:
            return None
        planes.append(np.frombuffer(buf, dtype=dt).reshape(h, w)
                      .astype(np.int32))
    if src_fmt != chroma_format_idc:
        planes = convert_chroma_format(planes, src_fmt, chroma_format_idc)
        if chroma_format_idc == 0:
            planes = planes[:1]
    ibd = internal_bit_depth or file_bit_depth
    eff_file_bd = file_bit_depth
    if msb_extended and file_bit_depth > 8:
        # MSB-aligned: the file sample occupies the top ibd bits
        eff_file_bd = 16
    if ibd != eff_file_bd:
        shift = ibd - eff_file_bd
        planes = [_scale_plane(p.astype(np.int64), shift, 0,
                               (1 << ibd) - 1).astype(np.int32)
                  for p in planes]
    return planes


def split_fields(planes):
    """Top/bottom field split of a frame (field coding input,
    TVideoIOYuv::read isField path)."""
    top = [p[0::2].copy() for p in planes]
    bot = [p[1::2].copy() for p in planes]
    return top, bot


def interleave_fields(top, bot):
    """Weave two fields back into a frame (TVideoIOYuv::write field
    interleave)."""
    out = []
    for t, b in zip(top, bot):
        h, w = t.shape
        fr = np.empty((h * 2, w), dtype=t.dtype)
        fr[0::2] = t
        fr[1::2] = b
        out.append(fr)
    return out
