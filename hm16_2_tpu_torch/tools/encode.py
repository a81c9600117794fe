"""Encoder CLI (TAppEncoder dual): encode planar YUV to an Annex-B stream.

Accepts the reference encoder's option names and `.cfg` files (TAppEncCfg
option registry, TAppEncCfg.cpp:360-900; config-file syntax from
program_options_lite) for the supported tool set, so HM command lines like

  python -m hm16_2_tpu_torch.tools.encode -c encoder_randomaccess_main.cfg \
      -i in.yuv -wdt 416 -hgt 240 -f 16 -q 32 -b out.bin -o rec.yuv

work unchanged.  Prints per-POC lines and a summary table in the
reference's spirit (TEncGOP::xCalculateAddPSNR / TEncAnalyze::printOut).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from hm16_2_tpu_torch.config.options import Options
from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
from hm16_2_tpu_torch.io.yuv import read_yuv_frame, write_yuv_frame


def build_options() -> Options:
    o = Options()
    o.add("Device", "cuda", "torch device of the frame plans: cuda or cpu")
    o.add("InputFile", "", "Original YUV input file name", short="i")
    o.add("BitstreamFile", "", "Bitstream output file name", short="b")
    o.add("ReconFile", "", "Reconstructed YUV output file name", short="o")
    o.add("SourceWidth", 0, "Source picture width", short="wdt")
    o.add("SourceHeight", 0, "Source picture height", short="hgt")
    o.add("InputBitDepth", 8, "Bit-depth of input file")
    o.add("InternalBitDepth", 0, "Internal coding bit-depth (0: input)")
    o.add("FrameRate", 30, "Frame rate", short="fr")
    o.add("FrameSkip", 0, "Number of frames to skip at start", short="fs")
    o.add("FramesToBeEncoded", 1, "Number of frames to be coded", short="f")
    o.add("QP", 32.0, "Qp value", short="q")
    o.add("IntraPeriod", -1, "Intra period in frames (-1: first only)",
          short="ip")
    o.add("DecodingRefreshType", 0, "Intra refresh type", short="dr")
    o.add("GOPSize", 1, "GOP size of temporal structure", short="g")
    o.add("SAO", True, "Enable Sample Adaptive Offset")
    o.add("LoopFilterDisable", False, "Disable deblocking filter")
    o.add("WaveFrontSynchro", 0, "WPP: 1 enables entropy_coding_sync")
    o.add("NumTileColumnsMinus1", 0, "Number of tile columns minus 1")
    o.add("NumTileRowsMinus1", 0, "Number of tile rows minus 1")
    o.add("TileUniformSpacing", True, "Uniform tile grid")
    o.add("SEIDecodedPictureHash", 1, "Hash SEI: 1 MD5 / 2 CRC / 3 checksum")
    o.add("SEIBufferingPeriod", 0, "Buffering period SEI + HRD in VUI")
    o.add("SEIRecoveryPoint", 0, "Recovery point SEI on IRAP pictures")
    o.add("SEIPictureTiming", 0, "Picture timing SEI (+ VUI timing info)")
    o.add("SEIActiveParameterSets", 0, "Active parameter sets SEI")
    o.add("SEIFramePacking", 0, "Frame packing arrangement SEI")
    o.add("SEIFramePackingType", 3, "FPA type: 3 SbS / 4 TaB / 5 temporal")
    o.add("SEIDisplayOrientation", 0,
          "Display orientation SEI (anticlockwise rotation, 0 = off)")
    o.add("SEITemporalLevel0Index", 0, "Temporal level zero index SEI")
    o.add("SEIGradualDecodingRefreshInfo", 0, "Region refresh info SEI")
    o.add("SEITimeCodeEnabled", 0, "Time code SEI on every picture")
    o.add("SEIMasteringDisplayColourVolume", 0,
          "Mastering display colour volume SEI")
    o.add("SEIToneMapping", 0, "Tone mapping info SEI (linear model)")
    o.add("FieldCoding", False, "Code each field as a half-height picture")
    o.add("TopFieldFirst", True, "Field order for FieldCoding")
    o.add("ScalingList", 0,
          "0: no scaling lists, 1: default lists, 2: from ScalingListFile")
    o.add("ScalingListFile", "", "Scaling list file (HM matrix format)")
    o.add("SliceMode", 0, "0: single slice, 1: max SliceArgument CTUs per"
          " slice, 2: max SliceArgument bytes per slice")
    o.add("SliceArgument", 0, "CTUs per slice for SliceMode 1")
    o.add("SliceSegmentMode", 0,
          "0: off, 1: dependent segments of SliceSegmentArgument CTUs")
    o.add("SliceSegmentArgument", 0, "CTUs per dependent slice segment")
    o.add("TransquantBypassEnableFlag", 0,
          "PPS transquant_bypass_enabled (lossless capability)")
    o.add("CUTransquantBypassFlagForce", 0,
          "Force cu_transquant_bypass on every CU (lossless coding)")
    o.add("PCMEnabledFlag", 0, "IPCM mode search")
    o.add("PCMLog2MinSize", 3, "Log2 of minimum PCM block size")
    o.add("PCMLog2MaxSize", 5, "Log2 of maximum PCM block size")
    o.add("PCMFilterDisableFlag", 1, "Disable loop filters on PCM samples")
    o.add("RateControl", False, "Rate control: enable R-lambda model")
    o.add("TargetBitrate", 0, "Rate control: target bit-rate")
    o.add("LCULevelRateControl", True,
          "Rate control: CTU-level bit allocation + model feedback")
    o.add("SBD", False, "Similarity-based fast CU depth decision (fork)")
    o.add("RRSP", False, "Reduced-region similarity partitioning (fork)")
    o.add("DER", 16, "SBD border-strip width R (8/16/32/64)")
    o.add("InputChromaFormat", 420, "Input chroma format")
    o.add("ConformanceWindowMode", 0, "Conformance window")
    o.add("Level", 0.0, "Level limit (signalled general_level_idc)")
    o.add("Tier", "main", "main or high tier")
    o.add("Profile", "main", "Profile")
    # registered-but-informational (accepted from HM cfgs without effect)
    for name, dflt in (("MaxCUWidth", 64), ("MaxCUHeight", 64),
                       ("MaxPartitionDepth", 4), ("QuadtreeTULog2MaxSize", 5),
                       ("QuadtreeTULog2MinSize", 2),
                       ("QuadtreeTUMaxDepthInter", 3),
                       ("QuadtreeTUMaxDepthIntra", 3)):
        o.add(name, dflt, "(structure; fixed in this build)")
    # remaining TAppEncCfg keys found in the CTC cfg fixtures — accepted so
    # reference config files parse cleanly; tools behind them land in later
    # build stages (TAppEncCfg.cpp:360-900)
    # RExt tool keys (encoder_intra_high_throughput_rext.cfg) — live
    o.add("TransformSkip", 0, "4x4 transform skip evaluation")
    for name in ("ImplicitResidualDPCM", "ExplicitResidualDPCM",
                 "ResidualRotation", "SingleSignificanceMapContext",
                 "GolombRiceParameterAdaptation", "AlignCABACBeforeBypass"):
        o.add(name, 0, "HT-RExt tool (enables the rext tool set)")
    o.add("CrossComponentPrediction", 0, "RExt CCP (4:4:4)")
    o.add("DeltaQpRD", 0, "Slice-based multi-QP optimization (2n+1 QPs)")
    o.add("LoopFilterBetaOffset_div2", 0, "Deblocking beta offset / 2")
    o.add("LoopFilterTcOffset_div2", 0, "Deblocking tc offset / 2")
    o.add("IntraReferenceSmoothing", 1,
          "0: disable intra reference smoothing (RExt)")
    for name in ("AMP BipredSearchRange "
                 "DeblockingFilterControlPresent DeblockingFilterMetric "
                 "ExtendedPrecision FDM FEN "
                 "FastSearch HadamardME "
                 "HighPrecisionPredictionWeighting "
                 "InitialQP IntraConstraintFlag "
                 "KeepHierarchicalBit "
                 "LFCrossSliceBoundaryFlag LFCrossTileBoundaryFlag "
                 "LoopFilterOffsetInPPS "
                 "MaxCuDQPDepth MaxDeltaQP "
                 "PCMInputBitDepthFlag RCForceIntraQP "
                 "RCLCUSeparateModel RDOQ RDOQTS "
                 "SAOLcuBoundary SearchRange "
                 "TransformSkipFast TransformSkipLog2MaxSize "
                 "UniformSpacingIdc "
                 "ColumnWidthArray RowHeightArray TileColumnWidthArray "
                 "TileRowHeightArray").split():
        o.add(name, "", "(accepted; see build-stage notes)")
    for n in range(1, 17):    # GOP structure rows, validated by GOPSize
        o.add(f"Frame{n}", "", "GOP entry")
    return o


def psnr(orig, rec, bd):
    mse = float(np.mean((orig.astype(np.float64) - rec) ** 2))
    if mse == 0:
        return 99.99
    peak = (1 << bd) - 1
    return 10.0 * np.log10(peak * peak / mse)


def main(argv=None):
    o = build_options()
    rest = o.parse_cli(sys.argv[1:] if argv is None else argv)
    for w in o.warnings:
        print(f"Warning: {w}", file=sys.stderr)
    inp = o["InputFile"] or (rest[0] if rest else "")
    if not inp or not o["BitstreamFile"] or not o["SourceWidth"]:
        print("Required: -i/--InputFile, -b/--BitstreamFile, "
              "-wdt/-hgt", file=sys.stderr)
        return 2
    w, h = o["SourceWidth"], o["SourceHeight"]
    n = o["FramesToBeEncoded"]
    qp = int(o["QP"])
    ip = o["IntraPeriod"]
    gop = "ra8" if o["GOPSize"] >= 8 else "ld"

    # GOPEntry table from the cfg's FrameN lines (TEncCfg.h:49-88):
    # Type POC QPoffset QPfactor tcOff betaOff tid #active #refs refs...
    gop_table = []
    for i in range(1, int(o["GOPSize"]) + 1):
        line = str(o[f"Frame{i}"] or "").split()
        if len(line) < 9:
            gop_table = []
            break
        n_refs = int(line[8])
        refs = tuple(int(x) for x in line[9:9 + n_refs])
        gop_table.append(dict(type=line[0], poc=int(line[1]),
                              qpoff=int(line[2]), qpfac=float(line[3]),
                              tid=int(line[6]), n_active=int(line[7]),
                              refs=refs))
    bd_in = o["InputBitDepth"]
    bd = o["InternalBitDepth"] or bd_in

    intra_period = 1 if ip == 1 else (ip if ip > 0 else 10 ** 9)
    cfg = EncoderConfig(
        w, h, qp=qp, bit_depth=bd, intra_period=intra_period,
        deblock=not o["LoopFilterDisable"], sao=o["SAO"], gop=gop,
        sbd=o["SBD"], rrsp=o["RRSP"],
        wpp=bool(o["WaveFrontSynchro"]),
        tile_cols=o["NumTileColumnsMinus1"] + 1,
        tile_rows=o["NumTileRowsMinus1"] + 1,
        target_bps=o["TargetBitrate"] if o["RateControl"] else None,
        rc_ctu=bool(o["RateControl"] and o["LCULevelRateControl"]),
        frame_rate=o["FrameRate"], total_frames=n,
        hash_type=max(0, int(o["SEIDecodedPictureHash"]) - 1),
        sei_timing=bool(o["SEIPictureTiming"] or o["SEIActiveParameterSets"]),
        sei_buffering_period=bool(o["SEIBufferingPeriod"]),
        sei_recovery_point=bool(o["SEIRecoveryPoint"]),
        sei_frame_packing=(o["SEIFramePackingType"]
                           if o["SEIFramePacking"] else -1),
        sei_display_orientation=(o["SEIDisplayOrientation"]
                                 if o["SEIDisplayOrientation"] else -1),
        sei_temporal_level0=bool(o["SEITemporalLevel0Index"]),
        sei_region_refresh=bool(o["SEIGradualDecodingRefreshInfo"]),
        sei_time_code=bool(o["SEITimeCodeEnabled"]),
        sei_mastering_display=bool(o["SEIMasteringDisplayColourVolume"]),
        sei_tone_mapping=bool(o["SEIToneMapping"]),
        field_coding=bool(o["FieldCoding"]),
        decoding_refresh_type=(int(o["DecodingRefreshType"]) or 1),
        top_field_first=bool(o["TopFieldFirst"]),
        scaling_list=int(o["ScalingList"]),
        scaling_list_file=o["ScalingListFile"] or None,
        transquant_bypass=bool(o["TransquantBypassEnableFlag"]
                               and o["CUTransquantBypassFlagForce"]),
        transform_skip=bool(o["TransformSkip"]),
        cross_component_prediction=bool(o["CrossComponentPrediction"]),
        delta_qp_rd=int(o["DeltaQpRD"]),
        level=float(o["Level"]),
        tier_high=str(o["Tier"]).lower() == "high",
        deblock_beta_offset=int(o["LoopFilterBetaOffset_div2"]),
        deblock_tc_offset=int(o["LoopFilterTcOffset_div2"]),
        intra_smoothing_disabled=not int(o["IntraReferenceSmoothing"]),
        rext_tools=bool(o["ImplicitResidualDPCM"] or o["ResidualRotation"]
                        or o["SingleSignificanceMapContext"]
                        or o["GolombRiceParameterAdaptation"]
                        or o["AlignCABACBeforeBypass"]),
        pcm=bool(o["PCMEnabledFlag"]),
        pcm_log2_min=o["PCMLog2MinSize"], pcm_log2_max=o["PCMLog2MaxSize"],
        pcm_loop_filter_disabled=bool(o["PCMFilterDisableFlag"]),
        gop_table=gop_table or None)
    n_ctus = ((w + 63) // 64) * ((h + 63) // 64)
    if o["SliceMode"] == 1 and o["SliceArgument"] > 0:
        cfg.slices = (n_ctus + o["SliceArgument"] - 1) // o["SliceArgument"]
    elif o["SliceMode"] == 2 and o["SliceArgument"] > 0:
        cfg.slice_bytes = o["SliceArgument"]
    elif o["SliceSegmentMode"] == 1 and o["SliceSegmentArgument"] > 0:
        cfg.slices = (n_ctus + o["SliceSegmentArgument"] - 1) \
            // o["SliceSegmentArgument"]
        cfg.dependent_slices = True
    cfg.der = o["DER"]
    enc = Encoder(cfg, torch.device(o["Device"]))

    fin = open(inp, "rb")
    for _ in range(o["FrameSkip"]):
        read_yuv_frame(fin, w, h, file_bit_depth=bd_in)
    fout = open(o["BitstreamFile"], "wb")
    frec = open(o["ReconFile"], "wb") if o["ReconFile"] else None
    bds = [bd] * 3

    shift = bd - bd_in
    stats = []          # (poc, slice, bits, psnr per plane)
    t0 = time.time()
    pending = {}        # poc -> orig planes (for PSNR after coding)
    coded = []
    for poc in range(n):
        planes = read_yuv_frame(fin, w, h, file_bit_depth=bd_in)
        if planes is None:
            break
        if shift:
            planes = [p.astype(np.int32) << shift for p in planes]
        pending[poc] = planes
        if enc.gop_table is not None and ip != 1:
            for au in enc.push_frame(planes, poc):
                coded.append(au)
                fout.write(au)
        else:
            au = enc.encode_frame(planes, poc)
            coded.append(au)
            fout.write(au)
            orig = pending.pop(poc)
            py = psnr(orig[0], enc.last_recon[0], bd)
            pu = psnr(orig[1], enc.last_recon[1], bd)
            pv = psnr(orig[2], enc.last_recon[2], bd)
            st = "I" if (cfg.intra_period == 1 or
                         poc % cfg.intra_period == 0 or poc == 0) else "P"
            bits = len(au) * 8
            stats.append((poc, st, bits, py, pu, pv))
            print(f"POC {poc:4d} ( {st}-SLICE, QP "
                  f"{getattr(enc, 'last_qp', qp):2d} ) "
                  f"{bits:10d} bits [Y {py:6.4f} dB  U {pu:6.4f} dB  "
                  f"V {pv:6.4f} dB]")
            if frec:
                write_yuv_frame(frec, enc.last_recon, bds)
    if enc.gop_table is not None and ip != 1:
        for au in enc.flush():
            coded.append(au)
            fout.write(au)
        for poc, orig in sorted(pending.items()):
            stats.append((poc, "B", 0, 0, 0, 0))
    dt = time.time() - t0

    if frec:
        frec.close()
    fout.close()

    total_bytes = sum(len(a) for a in coded)
    fps = o["FrameRate"]
    kbps = total_bytes * 8 * fps / max(len(coded), 1) / 1000.0
    print()
    print("SUMMARY --------------------------------------------------------")
    if stats and stats[0][3]:
        ys = [s[3] for s in stats if s[3]]
        us = [s[4] for s in stats if s[3]]
        vs = [s[5] for s in stats if s[3]]
        print(f"        Total Frames |   Bitrate     Y-PSNR    U-PSNR    "
              f"V-PSNR")
        print(f"              {len(coded):6d}    {kbps:9.4f}  {np.mean(ys):8.4f}  "
              f"{np.mean(us):8.4f}  {np.mean(vs):8.4f}")
        # per-slice-type tables (TEncAnalyze::printOut I/P/B summaries)
        for st_name in ("I", "P", "B"):
            sel = [s for s in stats if s[1] == st_name and s[3]]
            if not sel:
                continue
            skbps = sum(s[2] for s in sel) * fps / len(sel) / 1000.0
            print(f"\n{st_name} Slices ------------------------------------"
                  f"--------------------")
            print(f"        Total Frames |   Bitrate     Y-PSNR    U-PSNR"
                  f"    V-PSNR")
            print(f"              {len(sel):6d}    {skbps:9.4f}  "
                  f"{np.mean([s[3] for s in sel]):8.4f}  "
                  f"{np.mean([s[4] for s in sel]):8.4f}  "
                  f"{np.mean([s[5] for s in sel]):8.4f}")
    print(f"Bytes written to file: {total_bytes}")
    print(f"Total Time: {dt:12.3f} sec. ({len(coded) / max(dt, 1e-9):.3f} fps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
