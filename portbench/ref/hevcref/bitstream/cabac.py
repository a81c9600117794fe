"""CABAC binary arithmetic coding engines + context-model state.

Bit-exact re-implementation of the HEVC arithmetic coder (spec 9.3.4.3):
 - decoder engine semantics: HM TDecBinCoderCABAC.cpp:68-360
 - encoder engine semantics: HM TEncBinCoderCABAC.cpp:55-440
 - RD fractional-bit counter: HM TEncBinCoderCABACCounter.cpp:73-135

This Python implementation is the reference/verification path; the production
hot loop lives in the C++ native module (hm16_2_tpu/native) driven by
pre-binarized syntax tensors produced on TPU.
"""

from __future__ import annotations

import numpy as np

from hevcref.common.cabac_data import (
    LPS_TABLE, RENORM_TABLE, NEXT_STATE_MPS, NEXT_STATE_LPS, ENTROPY_BITS,
    init_state,
)
from hevcref.common import cabac_init_data as CI

# slice-type row indices in the init tables
B_SLICE, P_SLICE, I_SLICE = 0, 1, 2


# ---------------------------------------------------------------------------
# Context sets
# ---------------------------------------------------------------------------

# (name, init-table) in a fixed order; each context set is a named slice of
# one flat uint8 state array so snapshot/restore is a single array copy.
_CTX_LAYOUT = [
    ("cu_transquant_bypass", CI.INIT_CU_TRANSQUANT_BYPASS_FLAG),
    ("split_flag", CI.INIT_SPLIT_FLAG),
    ("skip_flag", CI.INIT_SKIP_FLAG),
    ("merge_flag", CI.INIT_MERGE_FLAG_EXT),
    ("merge_idx", CI.INIT_MERGE_IDX_EXT),
    ("part_size", CI.INIT_PART_SIZE),
    ("pred_mode", CI.INIT_PRED_MODE),
    ("intra_pred_mode", CI.INIT_INTRA_PRED_MODE),
    ("chroma_pred_mode", CI.INIT_CHROMA_PRED_MODE),
    ("inter_dir", CI.INIT_INTER_DIR),
    ("mvd", CI.INIT_MVD),
    ("ref_pic", CI.INIT_REF_PIC),
    ("dqp", CI.INIT_DQP),
    ("chroma_qp_adj_flag", CI.INIT_CHROMA_QP_ADJ_FLAG),
    ("chroma_qp_adj_idc", CI.INIT_CHROMA_QP_ADJ_IDC),
    ("qt_cbf", CI.INIT_QT_CBF),
    ("qt_root_cbf", CI.INIT_QT_ROOT_CBF),
    ("last", CI.INIT_LAST),        # last-significant-X contexts
    ("last_y", CI.INIT_LAST),      # last-significant-Y contexts (separate set)
    ("sig_cg", CI.INIT_SIG_CG_FLAG),
    ("sig", CI.INIT_SIG_FLAG),
    ("one", CI.INIT_ONE_FLAG),
    ("abs", CI.INIT_ABS_FLAG),
    ("mvp_idx", CI.INIT_MVP_IDX),
    ("sao_merge", CI.INIT_SAO_MERGE_FLAG),
    ("sao_type", CI.INIT_SAO_TYPE_IDX),
    ("trans_subdiv", CI.INIT_TRANS_SUBDIV_FLAG),
    ("transform_skip", CI.INIT_TRANSFORMSKIP_FLAG),
    ("rdpcm_flag", CI.INIT_EXPLICIT_RDPCM_FLAG),
    ("rdpcm_dir", CI.INIT_EXPLICIT_RDPCM_DIR),
    ("cross_comp", CI.INIT_CROSS_COMPONENT_PREDICTION),
]

CTX_OFFSET: dict[str, int] = {}

# ---------------------------------------------------------------------------
# Optional per-syntax bit accounting (the TAppDecoderAnalyser /
# TComCodingStatistics analogue): when STATS is a BitStats instance the
# arithmetic decoder attributes every regular bin's fractional bits to
# the context's syntax-element name, and bypass/terminate bins to their
# own buckets.  Enable via Decoder(stats=True) or tools/decode --stats.
# ---------------------------------------------------------------------------

STATS = None


class BitStats:
    def __init__(self):
        self.bits = {}
        self.bins = {}
        self._names = None     # (sorted offsets, names) for index lookup
        # per-TU-size attribution scope (TComCodingStatistics' per-size
        # STATS__CABAC_BITS__ taxonomy, TComCodingStatistics.h:49-100):
        # the residual parser sets scope to "WxH" so every bin inside
        # residual_coding lands in a size-split row
        self.scope = None

    def _name_of(self, ctx_idx):
        if self._names is None:
            items = sorted(CTX_OFFSET.items(), key=lambda kv: kv[1])
            self._offs = [v for _, v in items]
            self._nm = [k for k, _ in items]
        import bisect
        i = bisect.bisect_right(self._offs, ctx_idx) - 1
        return self._nm[i]

    def add_regular(self, ctx_idx, state, binv):
        name = self._name_of(ctx_idx)
        if self.scope is not None:
            name = f"{name}[{self.scope}]"
        self.bits[name] = self.bits.get(name, 0.0) + \
            float(ENTROPY_BITS[state ^ binv]) / 32768.0
        self.bins[name] = self.bins.get(name, 0) + 1

    def add_ep(self, n=1):
        name = "(bypass)" if self.scope is None else \
            f"(bypass)[{self.scope}]"
        self.bits[name] = self.bits.get(name, 0.0) + n
        self.bins[name] = self.bins.get(name, 0) + n

    def add_trm(self):
        self.bins["(terminate)"] = self.bins.get("(terminate)", 0) + 1

    def table(self):
        rows = sorted(self.bits.items(), key=lambda kv: -kv[1])
        out = [f"{'syntax element':28s} {'bins':>9s} {'est. bits':>11s}"]
        for name, b in rows:
            out.append(f"{name:28s} {self.bins.get(name, 0):9d} {b:11.1f}")
        return "\n".join(out)
_off = 0
for _name, _tab in _CTX_LAYOUT:
    CTX_OFFSET[_name] = _off
    _off += len(_tab[0])
NUM_CTX = _off


class ContextSet:
    """Flat array of packed 7-bit context states with named offsets."""

    __slots__ = ("state", "_state_ptr")   # _state_ptr: cached ctypes addr

    def __init__(self, slice_type: int | None = None, qp: int | None = None):
        self.state = np.zeros(NUM_CTX, dtype=np.uint8)
        if slice_type is not None:
            self.reset(slice_type, qp)

    def reset(self, slice_type: int, qp: int):
        qp = int(np.clip(qp, 0, 51))
        pos = 0
        for name, tab in _CTX_LAYOUT:
            row = tab[slice_type]
            for v in row:
                self.state[pos] = init_state(v, qp)
                pos += 1

    def copy(self) -> "ContextSet":
        c = ContextSet()
        c.state = self.state.copy()
        return c

    def load(self, other: "ContextSet"):
        self.state[:] = other.state

    def idx(self, name: str, i: int = 0) -> int:
        return CTX_OFFSET[name] + i


# ---------------------------------------------------------------------------
# Decoder engine
# ---------------------------------------------------------------------------

class ByteFifo:
    """Sequential byte source for the arithmetic decoder."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, start: int = 0):
        self.data = data
        self.pos = start

    def read_byte(self) -> int:
        if self.pos >= len(self.data):
            return 0
        b = self.data[self.pos]
        self.pos += 1
        return b


class CabacDecoder:
    __slots__ = ("fifo", "range", "value", "bits_needed", "ctx")

    def __init__(self, fifo: ByteFifo, ctx: ContextSet):
        self.fifo = fifo
        self.ctx = ctx
        self.range = 510
        self.bits_needed = -8
        self.value = (fifo.read_byte() << 8) | fifo.read_byte()

    def decode_bin(self, ctx_idx: int) -> int:
        if STATS is not None:
            st = int(self.ctx.state[ctx_idx])
            b = self._decode_bin_inner(ctx_idx)
            STATS.add_regular(ctx_idx, st, b)
            return b
        return self._decode_bin_inner(ctx_idx)

    def _decode_bin_inner(self, ctx_idx: int) -> int:
        st = int(self.ctx.state[ctx_idx])
        lps = int(LPS_TABLE[st >> 1, (self.range >> 6) - 4])
        self.range -= lps
        scaled = self.range << 7
        if self.value < scaled:
            binv = st & 1
            self.ctx.state[ctx_idx] = NEXT_STATE_MPS[st]
            if scaled < (256 << 7):
                self.range = scaled >> 6
                self.value += self.value
                self.bits_needed += 1
                if self.bits_needed == 0:
                    self.bits_needed = -8
                    self.value += self.fifo.read_byte()
        else:
            binv = 1 - (st & 1)
            nbits = int(RENORM_TABLE[lps >> 3])
            self.value = (self.value - scaled) << nbits
            self.range = lps << nbits
            self.ctx.state[ctx_idx] = NEXT_STATE_LPS[st]
            self.bits_needed += nbits
            if self.bits_needed >= 0:
                self.value += self.fifo.read_byte() << self.bits_needed
                self.bits_needed -= 8
        return int(binv)

    def decode_bin_ep(self) -> int:
        if STATS is not None:
            STATS.add_ep(1)
        return self._decode_bin_ep_inner()

    def _decode_bin_ep_inner(self) -> int:
        if self.range == 256:
            return self.decode_aligned_bins_ep(1)
        self.value += self.value
        self.bits_needed += 1
        if self.bits_needed >= 0:
            self.bits_needed = -8
            self.value += self.fifo.read_byte()
        scaled = self.range << 7
        if self.value >= scaled:
            self.value -= scaled
            return 1
        return 0

    def decode_bins_ep(self, num: int) -> int:
        if STATS is not None:
            STATS.add_ep(num)
        return self._decode_bins_ep_inner(num)

    def _decode_bins_ep_inner(self, num: int) -> int:
        if num == 0:
            return 0
        if self.range == 256:
            return self.decode_aligned_bins_ep(num)
        bins = 0
        while num > 8:
            self.value = (self.value << 8) + (self.fifo.read_byte() << (8 + self.bits_needed))
            scaled = self.range << 15
            for _ in range(8):
                bins += bins
                scaled >>= 1
                if self.value >= scaled:
                    bins += 1
                    self.value -= scaled
            num -= 8
        self.bits_needed += num
        self.value <<= num
        if self.bits_needed >= 0:
            self.value += self.fifo.read_byte() << self.bits_needed
            self.bits_needed -= 8
        scaled = self.range << (num + 7)
        for _ in range(num):
            bins += bins
            scaled >>= 1
            if self.value >= scaled:
                bins += 1
                self.value -= scaled
        return bins

    def align(self):
        self.range = 256

    def decode_aligned_bins_ep(self, num: int) -> int:
        bins = 0
        remaining = num
        assert self.range == 256
        while remaining > 0:
            to_read = min(remaining, 8)
            mask = (1 << to_read) - 1
            new_bins = (self.value >> (15 - to_read)) & mask
            bins = (bins << to_read) | new_bins
            self.value = (self.value << to_read) & 0x7FFF
            remaining -= to_read
            self.bits_needed += to_read
            if self.bits_needed >= 0:
                self.value |= self.fifo.read_byte() << self.bits_needed
                self.bits_needed -= 8
        return bins

    def decode_bin_trm(self) -> int:
        if STATS is not None:
            STATS.add_trm()
        return self._decode_bin_trm_inner()

    def _decode_bin_trm_inner(self) -> int:
        self.range -= 2
        scaled = self.range << 7
        if self.value >= scaled:
            return 1
        if scaled < (256 << 7):
            self.range = scaled >> 6
            self.value += self.value
            self.bits_needed += 1
            if self.bits_needed == 0:
                self.bits_needed = -8
                self.value += self.fifo.read_byte()
        return 0


# ---------------------------------------------------------------------------
# Encoder engine
# ---------------------------------------------------------------------------

class CabacEncoder:
    """Real binary arithmetic encoder writing into a BitWriter."""

    __slots__ = ("bw", "low", "range", "bits_left", "num_buffered",
                 "buffered_byte", "ctx", "bins")

    def __init__(self, bit_writer, ctx: ContextSet):
        self.bw = bit_writer
        self.ctx = ctx
        self.bins = 0          # bins coded (cabac_zero_words accounting)
        self.start()

    def start(self):
        self.low = 0
        self.range = 510
        self.bits_left = 23
        self.num_buffered = 0
        self.buffered_byte = 0xFF

    def encode_bin(self, binv: int, ctx_idx: int):
        self.bins += 1
        st = int(self.ctx.state[ctx_idx])
        lps = int(LPS_TABLE[st >> 1, (self.range >> 6) & 3])
        self.range -= lps
        if binv != (st & 1):
            nbits = int(RENORM_TABLE[lps >> 3])
            self.low = (self.low + self.range) << nbits
            self.range = lps << nbits
            self.ctx.state[ctx_idx] = NEXT_STATE_LPS[st]
            self.bits_left -= nbits
            self._test_write()
        else:
            self.ctx.state[ctx_idx] = NEXT_STATE_MPS[st]
            if self.range < 256:
                self.low <<= 1
                self.range <<= 1
                self.bits_left -= 1
                self._test_write()

    def encode_bin_ep(self, binv: int):
        self.bins += 1
        if self.range == 256:
            self.encode_aligned_bins_ep(binv, 1)
            return
        self.low <<= 1
        if binv:
            self.low += self.range
        self.bits_left -= 1
        self._test_write()

    def encode_bins_ep(self, value: int, num: int):
        if num == 0:
            return
        self.bins += num
        if self.range == 256:
            self.encode_aligned_bins_ep(value, num)
            return
        while num > 8:
            num -= 8
            pattern = value >> num
            self.low = (self.low << 8) + self.range * pattern
            value -= pattern << num
            self.bits_left -= 8
            self._test_write()
        self.low = (self.low << num) + self.range * value
        self.bits_left -= num
        self._test_write()

    def align(self):
        self.range = 256

    def encode_aligned_bins_ep(self, value: int, num: int):
        assert self.range == 256
        remaining = num
        while remaining > 0:
            to_code = min(remaining, 8)
            mask = (1 << to_code) - 1
            new_bins = (value >> (remaining - to_code)) & mask
            self.low = (self.low << to_code) + (new_bins << 8)
            remaining -= to_code
            self.bits_left -= to_code
            self._test_write()

    def encode_bin_trm(self, binv: int):
        self.bins += 1
        self.range -= 2
        if binv:
            self.low += self.range
            self.low <<= 7
            self.range = 2 << 7
            self.bits_left -= 7
        elif self.range >= 256:
            return
        else:
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
        self._test_write()

    def _test_write(self):
        if self.bits_left < 12:
            self._write_out()

    def _write_out(self):
        lead = self.low >> (24 - self.bits_left)
        self.bits_left += 8
        self.low &= 0xFFFFFFFF >> self.bits_left
        if lead == 0xFF:
            self.num_buffered += 1
        elif self.num_buffered > 0:
            carry = lead >> 8
            self.bw.u((self.buffered_byte + carry) & 0xFF, 8)
            self.buffered_byte = lead & 0xFF
            fill = (0xFF + carry) & 0xFF
            while self.num_buffered > 1:
                self.bw.u(fill, 8)
                self.num_buffered -= 1
        else:
            self.num_buffered = 1
            self.buffered_byte = lead

    def finish(self):
        """Flush remaining state (TEncBinCoderCABAC.cpp:81-108)."""
        if self.low >> (32 - self.bits_left):
            self.bw.u((self.buffered_byte + 1) & 0xFF, 8)
            while self.num_buffered > 1:
                self.bw.u(0x00, 8)
                self.num_buffered -= 1
            self.low -= 1 << (32 - self.bits_left)
        else:
            if self.num_buffered > 0:
                self.bw.u(self.buffered_byte, 8)
            while self.num_buffered > 1:
                self.bw.u(0xFF, 8)
                self.num_buffered -= 1
        self.bw.u((self.low >> 8) & ((1 << (24 - self.bits_left)) - 1),
                  24 - self.bits_left)

    def flush_with_stop_bit(self):
        """terminate(1) + finish + stop bit + zero alignment = end of slice
        substream (TEncBinCABAC::flush)."""
        self.encode_bin_trm(1)
        self.finish()
        self.bw.u(1, 1)
        self.bw.align_zero()
        self.start()


# ---------------------------------------------------------------------------
# Fractional-bit RD counter
# ---------------------------------------------------------------------------

class CabacCounter:
    """Accumulates fractional bits (15-bit fixed point) instead of coding.

    Used for all trial encodes (FAST_BIT_EST); mirrors
    TEncBinCoderCABACCounter.cpp:73-135.
    """

    __slots__ = ("frac_bits", "ctx")

    def __init__(self, ctx: ContextSet):
        self.ctx = ctx
        self.frac_bits = 0

    def encode_bin(self, binv: int, ctx_idx: int):
        st = int(self.ctx.state[ctx_idx])
        self.frac_bits += int(ENTROPY_BITS[st ^ binv])
        self.ctx.state[ctx_idx] = NEXT_STATE_MPS[st] if binv == (st & 1) \
            else NEXT_STATE_LPS[st]

    def encode_bin_ep(self, binv: int):
        self.frac_bits += 32768

    def encode_bins_ep(self, value: int, num: int):
        self.frac_bits += 32768 * num

    def encode_bin_trm(self, binv: int):
        self.frac_bits += int(ENTROPY_BITS[126 ^ binv])

    def align(self):
        pass

    def encode_aligned_bins_ep(self, value: int, num: int):
        self.frac_bits += 32768 * num

    def bits(self) -> float:
        return self.frac_bits / 32768.0
