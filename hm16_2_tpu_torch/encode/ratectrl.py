"""R-lambda rate control (JCTVC-K0103), picture level.

Reference behavior: TEncRateCtrl.{h,cpp} — TEncRCSeq/TEncRCGOP/TEncRCPic
hierarchy (TEncRateCtrl.h:97,184,217), bit-ratio and frame-level tables
(TEncRateCtrl.cpp:1200-1380), GOP target estimation over a smoothing
window (xEstGOPTargetBits :450), adaptive hierarchical allocation via the
bisection solve of sum_i a_i x^{b_i} = bpp (xCalEquaCoeff/xSolveEqua),
picture lambda/QP estimation with neighbor clips (estimatePicLambda :~560,
estimatePicQP), intra SATD model (calculateLambdaIntra,
getRefineBitsForIntra :1071) and the post-picture alpha/beta update
(updateAfterPicture).  Wiring mirrors TEncGOP.cpp:1068-1119.

The model math is closed-form scalar state — it runs on host between
frames; the per-frame SATD cost feeding the intra model is computed by
the batched Hadamard kernel.
"""

from __future__ import annotations

import math

import numpy as np

ALPHA_MIN, ALPHA_MAX = 0.05, 500.0           # g_RCAlphaMin/MaxValue
BETA_MIN, BETA_MAX = -3.0, -0.1              # g_RCBetaMin/MaxValue
SMOOTH_WINDOW = 40                           # g_RCSmoothWindowSize
W_PIC_GOP = 0.9                              # g_RCWeightPicTargetBitInGOP
W_PIC_BUF = 1.0 - W_PIC_GOP
ITER_NUM = 20                                # g_RCIterationNum
W_HIST_LAMBDA, W_CURR_LAMBDA = 0.5, 0.5
INTRA_ALPHA = 6.7542                         # ALPHA (intra model)
INTRA_BETA1, INTRA_BETA2 = 1.2517, 1.7860    # BETA1/BETA2


def _clip(lo, hi, v):
    return max(lo, min(hi, v))


class RateCtrl:
    """Sequence + GOP + picture R-lambda state machine.

    gop_kind: "ld1" (IPPP, GOP of 1), "ld4" (HM low-delay GOP 4 tables) or
    "ra8" (random-access GOP 8 tables with adaptive hierarchical bits).
    """

    def __init__(self, target_bps, frame_rate, total_frames, width, height,
                 gop_kind="ld1", keep_hier_bits=2, lcu_rc=False, ctb=64):
        self.num_pixels = width * height
        self.frame_rate = frame_rate
        self.total_frames = total_frames
        self.target_rate = target_bps
        self.target_bits = int(target_bps * total_frames / frame_rate)
        self.bits_left = self.target_bits
        self.frames_left = total_frames
        bpp = target_bps / (frame_rate * self.num_pixels)
        self.gop_kind = gop_kind
        self.adaptive_bits = 0
        if gop_kind == "ld4":
            self.gop_size = 4
            self.bits_ratio = [2, 3, 2, 14 if bpp <= 0.05 else
                               12 if bpp <= 0.1 else 10 if bpp <= 0.2 else 6]
            self.gopid2level = [3, 2, 3, 1]
            self.adaptive_bits = 1 if keep_hier_bits == 2 else 0
            n_level = 3 + 2
        elif gop_kind == "ra8":
            self.gop_size = 8
            first = 30 if bpp <= 0.05 else 25 if bpp <= 0.1 else \
                20 if bpp <= 0.2 else 15
            second = {30: 8, 25: 7, 20: 6, 15: 5}[first]
            self.bits_ratio = [first, second, 4, 1, 1, 4, 1, 1]
            self.gopid2level = [1, 2, 3, 4, 4, 3, 4, 4]
            self.adaptive_bits = 2 if keep_hier_bits == 2 else 0
            n_level = 4 + 2
        else:
            self.gop_size = 1
            self.bits_ratio = [10]
            self.gopid2level = [1]
            n_level = 3
        # per-level (alpha, beta); level 0 = intra (initPicPara)
        self.pic_para = [[INTRA_ALPHA, INTRA_BETA2] if i == 0 else
                         [3.2003, -1.367] for i in range(n_level)]
        self.last_lambda = 0.0
        self.alpha_update, self.beta_update = 0.1, 0.05
        # GOP state
        self.gop_bits_left = 0
        self.gop_pics_left = 0
        self.gop_targets = []
        # history of (frame_level, actual_lambda, actual_qp), most recent
        # last; HM keeps g_RCMaxPicListSize=32
        self.history = []
        # current picture state
        self.pic = None
        # ---- CTU (LCU) level (LCULevelRC + UseLCUSeparateModel) --------
        self.lcu_rc = lcu_rc
        if lcu_rc:
            w_ctbs = (width + ctb - 1) // ctb
            h_ctbs = (height + ctb - 1) // ctb
            self.num_lcu = w_ctbs * h_ctbs
            # border-aware per-LCU pixel counts, raster (rs) order
            pix = np.full((h_ctbs, w_ctbs), ctb * ctb, dtype=np.int64)
            pix[:, -1] = ctb * (width - ctb * (w_ctbs - 1))
            pix[-1, :] = ctb * (height - ctb * (h_ctbs - 1))
            pix[-1, -1] = (width - ctb * (w_ctbs - 1)) * \
                (height - ctb * (h_ctbs - 1))
            self.lcu_pixels = pix.reshape(-1)
            # per-(level, LCU) alpha/beta, seeded from the level's picture
            # model on first use (TEncRCSeq::initLCUPara)
            self.lcu_para = {}
            # per-level last actual header bits (xEstPicHeaderBits proxy)
            self.hdr_bits = {}

    # ---- GOP level ----------------------------------------------------

    def begin_gop(self, num_pic=None):
        """TEncRCGOP::create — allocate the GOP budget."""
        num_pic = num_pic or self.gop_size
        window = min(SMOOTH_WINDOW, self.frames_left)
        avg = self.target_bits // max(self.total_frames, 1)
        cur = int((self.bits_left - avg * (self.frames_left - window))
                  / max(window, 1))
        target = max(cur * num_pic, 200)

        if self.adaptive_bits > 0 and self.last_lambda > 0.1:
            target_bpp = target / (self.num_pixels * num_pic) * num_pic
            lam_ratio = self._lambda_ratios()
            a, b = [], []
            for i in range(self.gop_size):
                lvl = self.gopid2level[i]
                al, be = self.pic_para[lvl]
                a.append((1.0 / al) ** (1.0 / be) *
                         lam_ratio[i] ** (1.0 / be))
                b.append(1.0 / be)
            basic = self._solve(target / self.num_pixels, a, b)
            self.bits_ratio = [max(int(a[i] * basic ** b[i]
                                       * self.num_pixels + 0.5), 1)
                               for i in range(self.gop_size)]

        total_ratio = sum(self.bits_ratio[:num_pic])
        self.gop_targets = [int(target * r / total_ratio)
                            for r in self.bits_ratio[:num_pic]]
        self.gop_bits_left = target
        self.gop_pics_left = num_pic
        self.gop_num_pic = num_pic

    def _lambda_ratios(self):
        ll = self.last_lambda
        if self.adaptive_bits == 1:                    # LD GOP4
            if ll < 120.0:
                r1 = 0.725 * math.log(ll) + 0.5793
                return [1.3 * r1, r1, 1.3 * r1, 1.0]
            return [5.0, 4.0, 5.0, 1.0]
        if ll < 90.0:                                  # RA GOP8
            r1 = 0.725 * math.log(ll) + 0.7963
            return [1.0, r1, 1.3 * r1, 3.25 * r1, 3.25 * r1,
                    1.3 * r1, 3.25 * r1, 3.25 * r1]
        return [1.0, 4.0, 5.0, 12.3, 12.3, 5.0, 12.3, 12.3]

    @staticmethod
    def _solve(target_bpp, a, b):
        """xSolveEqua bisection for sum a_i x^{b_i} = bpp."""
        sol, lo, hi = 100.0, 0.1, 10000.0
        for _ in range(ITER_NUM):
            fx = sum(ai * sol ** bi for ai, bi in zip(a, b))
            if abs(fx - target_bpp) < 1e-6:
                break
            if fx > target_bpp:
                lo, sol = sol, (sol + hi) / 2.0
            else:
                hi, sol = sol, (sol + lo) / 2.0
        return _clip(0.1, 10000.0, sol)

    # ---- picture level ------------------------------------------------

    def begin_picture(self, gop_id, is_intra, intra_cost=None):
        """Returns (qp, lambda) for this picture.  intra_cost: summed 8x8
        Hadamard cost of the original frame (calCostSliceI), required for
        I pictures."""
        if self.gop_pics_left == 0:
            self.begin_gop()
        level = 0 if is_intra else self.gopid2level[gop_id % self.gop_size]
        pos = self.gop_num_pic - self.gop_pics_left
        total_ratio = sum(self.bits_ratio[pos:self.gop_num_pic]) or 1
        target = int(self.gop_bits_left * self.bits_ratio[
            pos % self.gop_size] / total_ratio)
        target = max(target, 100)
        if self.frames_left > 16:
            target = int(W_PIC_BUF * target + W_PIC_GOP * self.gop_targets[pos])

        if is_intra and self.total_frames > 1 and intra_cost is not None:
            # getRefineBitsForIntra on the sequence's left average bits
            org = int(self.bits_left / max(self.frames_left, 1))
            al = 0.25 if org * 40 < self.num_pixels else 0.30
            target = max(int(al * (intra_cost * 4.0 / org) ** 0.5582 * org
                             + 0.5), 200)

        alpha, beta = self.pic_para[level]
        bpp = target / self.num_pixels
        if is_intra:
            mad = (intra_cost / self.num_pixels) ** INTRA_BETA1 \
                if intra_cost else 1.0
            lam = (alpha / 256.0) * (mad / bpp) ** beta
        else:
            lam = alpha * bpp ** beta

        last_level = last_pic = last_valid = -1.0
        for lvl, l, q in self.history:
            if lvl == level:
                last_level = l
            last_pic = l
            if last_pic > 0:
                last_valid = last_pic
        if last_level > 0:
            c = _clip(0.1, 10000.0, last_level)
            lam = _clip(c * 2.0 ** (-1.0), c * 2.0, lam)
        if last_pic > 0:
            c = _clip(0.1, 2000.0, last_pic)
            lam = _clip(c * 2.0 ** (-10.0 / 3), c * 2.0 ** (10.0 / 3), lam)
        elif last_valid > 0:
            c = _clip(0.1, 2000.0, last_valid)
            lam = _clip(c * 2.0 ** (-10.0 / 3), c * 2.0 ** (10.0 / 3), lam)
        else:
            lam = _clip(0.1, 10000.0, lam)
        lam = max(lam, 0.1)

        qp = int(4.2005 * math.log(lam) + 13.7122 + 0.5)
        last_level_qp = last_pic_qp = last_valid_qp = None
        for lvl, l, q in self.history:
            if lvl == level:
                last_level_qp = q
            last_pic_qp = q
            if q is not None:
                last_valid_qp = q
        if last_level_qp is not None:
            qp = _clip(last_level_qp - 3, last_level_qp + 3, qp)
        if last_pic_qp is not None:
            qp = _clip(last_pic_qp - 10, last_pic_qp + 10, qp)
        elif last_valid_qp is not None:
            qp = _clip(last_valid_qp - 10, last_valid_qp + 10, qp)
        qp = _clip(0, 51, qp)

        self.pic = dict(level=level, target=target, lam=lam, qp=qp,
                        intra_cost=intra_cost, is_intra=is_intra)
        if self.lcu_rc and not is_intra:
            self._init_ctu_level(level, target, lam)
        return qp, lam

    # ---- CTU (LCU) level ----------------------------------------------

    def _init_ctu_level(self, level, target, est_lambda):
        """Per-LCU bit-weight allocation from the lambda model
        (estimatePicLambda tail, TEncRateCtrl.cpp:690-718): weight_i =
        pixels_i * (lambda/alpha_i)^(1/beta_i), normalized to the picture
        target so each weight becomes that LCU's target bits."""
        if level not in self.lcu_para:
            a, b = self.pic_para[level]
            self.lcu_para[level] = [[a, b] for _ in range(self.num_lcu)]
        para = self.lcu_para[level]
        w = np.array([max(self.lcu_pixels[i] *
                          (est_lambda / para[i][0]) ** (1.0 / para[i][1]),
                          0.01) for i in range(self.num_lcu)])
        bits_left = target - self.hdr_bits.get(level, 0)
        p = self.pic
        p["lcu_weights"] = w * (target / w.sum())
        p["lcu_bits_left"] = max(bits_left, 100)
        p["lcu_left"] = self.num_lcu
        p["lcu_weight_left"] = float(p["lcu_weights"].sum())
        p["lcu_coded"] = []          # (lambda, qp-or-None) in coding order

    def ctu_begin(self, lcu_idx):
        """getLCUTargetBpp (inter branch) + getLCUEstLambda + getLCUEstQP
        (TEncRateCtrl.cpp:761-884).  Returns (qp, lambda) for this CTU."""
        p = self.pic
        para = self.lcu_para[p["level"]][lcu_idx]
        window = min(4, p["lcu_left"])                 # g_RCLCUSmoothWindow
        avg_bits = max(int(p["lcu_weights"][lcu_idx] -
                           (p["lcu_weight_left"] - p["lcu_bits_left"])
                           / window + 0.5), 1)
        bpp = avg_bits / self.lcu_pixels[lcu_idx]
        lam = para[0] * bpp ** para[1]
        prev_lam = next((l for l, _ in reversed(p["lcu_coded"]) if l > 0),
                        None)
        if prev_lam is not None:
            lam = _clip(prev_lam * 2.0 ** (-1 / 3.0),
                        prev_lam * 2.0 ** (1 / 3.0), lam)
        lam = _clip(p["lam"] * 2.0 ** (-2 / 3.0),
                    p["lam"] * 2.0 ** (2 / 3.0), lam)
        lam = max(lam, 0.1)
        qp = int(4.2005 * math.log(lam) + 13.7122 + 0.5)
        prev_qp = next((q for _, q in reversed(p["lcu_coded"])
                        if q is not None), None)
        if prev_qp is not None:
            qp = _clip(prev_qp - 1, prev_qp + 1, qp)
        qp = _clip(p["qp"] - 2, p["qp"] + 2, qp)
        return _clip(0, 51, qp), lam

    def ctu_update(self, lcu_idx, bits, qp, lam):
        """updateAfterCTU (TEncRateCtrl.cpp:885-944): bookkeeping + the
        per-LCU alpha/beta model update.  qp=None marks an all-skip CTU
        (no effective pixels — excluded from the neighbor-QP clip chain
        and the picture average, TEncSlice.cpp:855-880)."""
        p = self.pic
        p["lcu_coded"].append((lam, qp))
        p["lcu_left"] -= 1
        p["lcu_bits_left"] -= bits
        p["lcu_weight_left"] -= float(p["lcu_weights"][lcu_idx])
        para = self.lcu_para[p["level"]][lcu_idx]
        alpha, beta = para
        bpp = bits / self.lcu_pixels[lcu_idx]
        cal = alpha * bpp ** beta if bpp > 0 else 0.0
        if lam < 0.01 or cal < 0.01 or bpp < 0.0001:
            alpha *= 1.0 - self.alpha_update / 2.0
            beta *= 1.0 - self.beta_update / 2.0
        else:
            cal = _clip(lam / 10.0, lam * 10.0, cal)
            alpha += self.alpha_update * (math.log(lam)
                                          - math.log(cal)) * alpha
            lnbpp = _clip(-5.0, -0.1, math.log(bpp))
            beta += self.beta_update * (math.log(lam)
                                        - math.log(cal)) * lnbpp
        para[0] = _clip(ALPHA_MIN, ALPHA_MAX, alpha)
        para[1] = _clip(BETA_MIN, BETA_MAX, beta)

    def update_after_picture(self, actual_bits, header_bits=0):
        """updateAfterPicture + updateAfterPic sequence bookkeeping.  With
        CTU-level RC active, the model update uses the picture's average
        coded lambda/QP (calAverageLambda/calAverageQP — geometric mean
        over effective LCUs) instead of the estimates, mirroring the
        TEncGOP call site."""
        p = self.pic
        level, lam, qp = p["level"], p["lam"], p["qp"]
        if p.get("lcu_coded"):
            lams = [math.log(l) for l, _ in p["lcu_coded"] if l > 0.01]
            if lams:
                lam = math.exp(sum(lams) / len(lams))
            qps = [q for _, q in p["lcu_coded"] if q is not None]
            if qps:
                qp = int(sum(qps) / len(qps) + 0.5)
            self.hdr_bits[level] = header_bits
        alpha, beta = self.pic_para[level]
        if p["is_intra"]:
            lnbpp = math.log((p["intra_cost"] / self.num_pixels)
                             ** INTRA_BETA1) if p["intra_cost"] else 1.0
            diff = beta * (math.log(actual_bits) - math.log(p["target"]))
            diff = _clip(-0.125, 0.125, 0.25 * diff)
            alpha *= math.exp(diff)
            if lnbpp:
                beta += diff / lnbpp
        else:
            bpp = actual_bits / self.num_pixels
            cal = alpha * bpp ** beta
            if lam < 0.01 or cal < 0.01 or bpp < 0.0001:
                alpha *= 1.0 - self.alpha_update / 2.0
                beta *= 1.0 - self.beta_update / 2.0
            else:
                cal = _clip(lam / 10.0, lam * 10.0, cal)
                alpha += self.alpha_update * (math.log(lam)
                                              - math.log(cal)) * alpha
                lnbpp = _clip(-5.0, -0.1, math.log(bpp))
                beta += self.beta_update * (math.log(lam)
                                            - math.log(cal)) * lnbpp
        self.pic_para[level] = [_clip(ALPHA_MIN, ALPHA_MAX, alpha),
                                _clip(BETA_MIN, BETA_MAX, beta)]
        if level == 1:
            self.last_lambda = W_HIST_LAMBDA * self.last_lambda + \
                W_CURR_LAMBDA * _clip(0.1, 10000.0, lam)

        self.history.append((level, lam, qp))
        if len(self.history) > 32:
            self.history.pop(0)
        self.bits_left -= actual_bits
        self.frames_left -= 1
        self.gop_bits_left -= actual_bits
        self.gop_pics_left -= 1
        self.pic = None


def frame_intra_cost(luma: np.ndarray) -> float:
    """calCostSliceI analogue: summed per-8x8 Hadamard-transform magnitude
    of the original luma (TEncCu::updateCtuDataISlice, xCalcHADs8x8_ISlice
    TEncCu.cpp:1286-1412) — DC-free SATD as the picture-complexity proxy."""
    h, w = luma.shape
    h8, w8 = h // 8 * 8, w // 8 * 8
    if h8 == 0 or w8 == 0:
        return float(np.abs(luma.astype(np.int64)).sum())
    blocks = luma[:h8, :w8].astype(np.int64).reshape(h8 // 8, 8, w8 // 8, 8)
    blocks = blocks.transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    hmat = np.array([[1, 1], [1, -1]], dtype=np.int64)
    hh = np.kron(np.kron(hmat, hmat), hmat)      # 8x8 Hadamard
    tr = hh @ blocks @ hh
    sad = np.abs(tr).sum(axis=(1, 2)) - np.abs(tr[:, 0, 0])   # drop DC
    return float(((sad + 2) // 4).sum())
