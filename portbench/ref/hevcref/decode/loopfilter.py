"""In-loop filters: deblocking + SAO application (decode side).

Deblocking dual: HM TComLoopFilter.cpp:130-923; SAO apply dual:
TComSampleAdaptiveOffset.cpp:309-630.  The batched TPU implementations live
in hevcref.ops.deblock / hevcref.ops.sao; this module orchestrates
them over a decoded PictureState.
"""

from __future__ import annotations

import numpy as np

from hevcref.decode.picture import PictureState


def snapshot_lossless_samples(pic: PictureState):
    """Samples of PCM (with pcm_loop_filter_disabled) and lossless CUs,
    saved before the loop filters (TComSampleAdaptiveOffset.cpp:631
    xPCMRestoration); restore with restore_lossless_samples.  Returns
    None when no such CU exists.  Shared by the decoder and the encoder's
    in-loop reconstruction."""
    keep = np.zeros(pic.ipcm.shape, dtype=bool)
    if pic.sps.pcm_enabled and pic.sps.pcm_loop_filter_disabled:
        keep |= pic.ipcm.astype(bool)
    if pic.pps.transquant_bypass_enabled:
        keep |= pic.tqb.astype(bool)
    if not keep.any():
        return None
    saved = []
    for c in range(pic.num_comps):
        sx, sy = pic.comp_shift[c]
        m = np.repeat(np.repeat(keep, 4 >> sy, 0), 4 >> sx, 1)
        ph, pw = pic.rec[c].shape
        m = m[:ph, :pw]
        if m.shape != (ph, pw):
            full = np.zeros((ph, pw), dtype=bool)
            full[:m.shape[0], :m.shape[1]] = m
            m = full
        saved.append((m, pic.rec[c][m].copy()))
    return saved


def restore_lossless_samples(pic: PictureState, saved):
    if saved is None:
        return
    for c in range(pic.num_comps):
        m, vals = saved[c]
        pic.rec[c][m] = vals


def apply_loop_filters(pic: PictureState):
    # PCM / lossless sample restoration: those CUs must come out of the
    # loop filters untouched, so snapshot them first and restore after.
    # (Deblocking additionally skips them sample-wise; SAO relies on
    # this restore.)
    saved = snapshot_lossless_samples(pic)

    any_deblock = any(not sh.deblocking_filter_disabled for sh in pic.slices)
    if any_deblock:
        from hevcref.ops.deblock_ref import deblock_picture
        deblock_picture(pic)
    any_sao = any(sh.sao_luma or sh.sao_chroma for sh in pic.slices)
    if pic.sps.sao_enabled and any_sao:
        from hevcref.ops.sao_ref import sao_picture
        sao_picture(pic)

    restore_lossless_samples(pic, saved)
