"""Regenerate the residual-bits regression used by the frame plans.

The plan-stage cost models (`intra_rd._bits_estimate`, inherited by the
inter plan) price candidate residuals with a linear model over cheap
tensor features.  This script regenerates the model coefficients from
scratch so they are reproducible:

  1. build real-content TUs: intra-predict realclip frames at several
     sizes, forward-transform + quantize the residuals at QP 22..42;
  2. count the EXACT fractional CABAC bits of each TU's residual_coding
     syntax with the counting coder (TEncBinCABACCounter twin) on fresh
     slice-init contexts — the same oracle the commit engines use;
  3. ordinary-least-squares fit of the feature set and print the
     coefficient block ready to paste into intra_rd._bits_estimate.

Run: python -m hm16_2_tpu_torch.tools.fit_bits_model [--frames N] [--seed S]
"""

from __future__ import annotations

import argparse

import numpy as np


def tu_features(lvl: np.ndarray) -> list[float]:
    """The feature vector of intra_rd._bits_estimate, numpy twin."""
    a = np.abs(lvl)
    s = lvl.shape[-1]
    nz = a > 0
    nnz = int(nz.sum())
    ys = np.arange(s)
    row_any = nz.any(axis=-1)
    col_any = nz.any(axis=-2)
    last_y = int(np.max(np.where(row_any, ys, -1)))
    last_x = int(np.max(np.where(col_any, ys, -1)))
    bbox = (last_x + 1) * (last_y + 1)
    n_zero_coded = max(bbox - nnz, 0)
    esc = np.maximum(a - 1, 0)
    esc_bits = float(np.where(
        a > 1, 2.0 * np.ceil(np.log2(esc + 1.0)) + 1.0, 0.0).sum())
    gt1 = int((a > 1).sum())
    lastpos_bits = (2.0 * (np.log2(max(last_x, 0) + 1.5)
                           + np.log2(max(last_y, 0) + 1.5)) + 2.0) \
        if nnz else 0.0
    n_cgs = max((last_x // 4 + 1) * (last_y // 4 + 1) - 1, 0)
    return [n_zero_coded, nnz, gt1, esc_bits, lastpos_bits, n_cgs, 1.0]


def exact_bits(levels: np.ndarray, scan_type: int, qp: int) -> float:
    """Exact fractional residual_coding bits via the counting coder with
    fresh I-slice contexts (what the native commit engines price with,
    CtuSearch._fill_bits_kit)."""
    from hm16_2_tpu_torch.bitstream.cabac import CabacCounter, ContextSet
    from hm16_2_tpu_torch.decode.ctu_dec import SliceDecoder
    from hm16_2_tpu_torch.encode.ctu_enc import CtuEncoder
    from hm16_2_tpu_torch.headers.params import I_SLICE

    ctx = ContextSet()
    ctx.reset(I_SLICE, min(max(qp, 0), 51))
    enc = CabacCounter(ctx)

    class _Shim:
        pass

    # drive the emitter's residual coder directly on a fake picture
    w = levels.shape[0]
    sh = _Shim()
    pic = _Shim()
    pic.comp_shift = {0: (0, 0)}
    pic.coeff = {0: levels.astype(np.int64)}
    pic.tskip = {0: np.zeros((max(w // 4, 1), max(w // 4, 1)), np.int8)}
    cu = _Shim()
    cu.tqb = False
    cu.pred_mode = 0

    ce = CtuEncoder.__new__(CtuEncoder)
    ce.pic = pic
    ce.enc = enc
    ce.ctx = ctx
    ce.sps = _Shim()
    ce.sps.transform_skip_context = 0
    ce.sps.persistent_rice_adaptation = 0
    ce.sps.cabac_bypass_alignment = 0
    ce.sps.extended_precision = 0
    ce.sps.implicit_rdpcm = 0
    ce.sps.max_tr_dynamic_range = lambda c: 15
    ce.pps = _Shim()
    ce.pps.sign_data_hiding = 0
    ce.pps.transform_skip_enabled = 0
    ce.trace = None
    ce.golomb_rice_stats = np.zeros(8, np.int32)
    ce._scan_type = lambda *a: scan_type
    # the python fallback path only (no native state caching here)
    ce._try_native_enc_residual = lambda *a, **k: False
    CtuEncoder._enc_residual(ce, cu, 0, 0,
                             w.bit_length() - 1, 0)
    return enc.frac_bits / 32768.0


def collect(frames: int, seed: int):
    from hm16_2_tpu_torch.ops import intra_ref, transforms_ref
    from hm16_2_tpu_torch.tools.realclip import make_clip

    rng = np.random.default_rng(seed)
    planes = make_clip(416, 240, frames)
    rows_x, rows_y = [], []
    for t, pl in enumerate(planes):
        y = pl[0].astype(np.int64)
        for size in (4, 8, 16, 32):
            for _ in range(40):
                qp = int(rng.integers(22, 43))
                y0 = int(rng.integers(1, (240 - size) // size)) * size
                x0 = int(rng.integers(1, (416 - size) // size)) * size
                blk = y[y0:y0 + size, x0:x0 + size]
                top = np.concatenate(
                    [[y[y0 - 1, x0 - 1]],
                     y[y0 - 1, x0:x0 + 2 * size]
                     if x0 + 2 * size <= 416 else
                     np.pad(y[y0 - 1, x0:], (0, x0 + 2 * size - 416),
                            mode="edge")])
                left = np.concatenate(
                    [[y[y0 - 1, x0 - 1]],
                     y[y0:y0 + 2 * size, x0 - 1]
                     if y0 + 2 * size <= 240 else
                     np.pad(y[y0:, x0 - 1], (0, y0 + 2 * size - 240),
                            mode="edge")])
                mode = int(rng.choice([0, 1, 10, 26, 18, 34]))
                pred = intra_ref.predict_intra(mode, top, left, size, 8,
                                               True)
                resi = blk - pred
                fwd = transforms_ref.forward_transform(
                    resi, 8, size == 4)
                lvl = transforms_ref.quant(fwd, qp, 8,
                                           size.bit_length() - 1,
                                           is_intra=True)
                if not np.any(lvl):
                    continue
                bits = exact_bits(lvl, 0, qp)
                rows_x.append(tu_features(lvl))
                rows_y.append(bits)
    return np.asarray(rows_x, np.float64), np.asarray(rows_y, np.float64)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args(argv)
    X, Y = collect(args.frames, args.seed)
    coef, res, *_ = np.linalg.lstsq(X, Y, rcond=None)
    pred = X @ coef
    ss_res = float(((Y - pred) ** 2).sum())
    ss_tot = float(((Y - Y.mean()) ** 2).sum())
    r2 = 1.0 - ss_res / ss_tot
    names = ["n_zero_coded", "nnz", "gt1", "esc_bits", "lastpos_bits",
             "n_cgs", "const"]
    print(f"samples: {len(Y)}   R^2 = {r2:.4f}")
    print("paste into intra_rd._bits_estimate:")
    print(f"    bits = ({coef[0]:+.3f} * n_zero_coded")
    for c, n in zip(coef[1:-1], names[1:-1]):
        print(f"            {c:+.3f} * {n}")
    print(f"            {coef[-1]:+.3f} + 1.0)   # fit constant + cbf")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
