"""Bitstream I/O: Annex-B byte streams, NAL units, RBSP (de)escaping, and
bit-level readers/writers incl. Exp-Golomb codes.

Parity (reference file:line): Annex-B NAL extraction `AnnexBread.cpp`,
emulation-prevention handling `NALread.cpp` / `NALwrite.cpp:47-100`,
bit readers/writers `TComBitStream.{h,cpp}`.
"""

from __future__ import annotations


# ---------------------------------------------------------------------------
# Annex-B framing
# ---------------------------------------------------------------------------

def split_annexb(data: bytes) -> list[bytes]:
    """Split an Annex-B byte stream into NAL unit payloads (still escaped).

    Accepts 3- or 4-byte start codes; trailing zero bytes after a NAL are
    dropped (they belong to the next start code / trailing padding).
    """
    nals = []
    i = 0
    n = len(data)
    # find first start code
    while i + 2 < n and not (data[i] == 0 and data[i + 1] == 0 and data[i + 2] == 1):
        i += 1
    while i + 2 < n:
        i += 3  # skip start code
        start = i
        j = i
        while j + 2 < n and not (data[j] == 0 and data[j + 1] == 0 and data[j + 2] == 1):
            j += 1
        end = j if j + 2 < n else n
        # strip trailing zeros that are part of the next start code prefix
        while end > start and data[end - 1] == 0:
            end -= 1
        nals.append(data[start:end])
        i = j
    return nals


def strip_emulation_prevention(payload: bytes) -> bytes:
    """Remove 0x03 emulation-prevention bytes: 00 00 03 xx -> 00 00 xx."""
    return strip_emulation_prevention_pos(payload)[0]


def strip_emulation_prevention_pos(payload: bytes) -> tuple[bytes, list]:
    """Strip EPBs and also return, for each removed 0x03, the index (in the
    STRIPPED output) of the byte that followed it — needed to convert
    slice-header entry-point offsets (escaped-byte counts) into unescaped
    substream sizes (TDecCAVLC.cpp:1438-1473)."""
    out = bytearray()
    pos = []
    zeros = 0
    i = 0
    n = len(payload)
    while i < n:
        b = payload[i]
        if zeros >= 2 and b == 3 and i + 1 < n and payload[i + 1] <= 3:
            zeros = 0
            i += 1
            pos.append(len(out))
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out), pos


def count_emulation_prevention(rbsp: bytes) -> int:
    """Number of EPBs NAL escaping will insert into this (sub)stream
    (TComOutputBitstream::countStartCodeEmulations).  Substreams start and
    end on byte-aligned CABAC flushes whose final byte is non-zero, so
    counting per substream matches escaping the concatenated payload."""
    cnt = 0
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            cnt += 1
            zeros = 0
        zeros = zeros + 1 if b == 0 else 0
    return cnt


def insert_emulation_prevention(rbsp: bytes) -> bytes:
    """Insert 0x03 after any 00 00 followed by a byte <= 3 (NALwrite.cpp:47-100)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


# ---------------------------------------------------------------------------
# Bit reader
# ---------------------------------------------------------------------------

class BitReader:
    """MSB-first bit reader over an (already unescaped) RBSP buffer."""

    __slots__ = ("data", "pos", "n")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0            # bit position
        self.n = len(data) * 8

    def u(self, nbits: int) -> int:
        """Read nbits as unsigned MSB-first."""
        v = 0
        p = self.pos
        data = self.data
        for _ in range(nbits):
            v = (v << 1) | ((data[p >> 3] >> (7 - (p & 7))) & 1)
            p += 1
        self.pos = p
        return v

    def flag(self) -> int:
        p = self.pos
        self.pos += 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def ue(self) -> int:
        """Unsigned Exp-Golomb."""
        zeros = 0
        while self.flag() == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("invalid exp-golomb code")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        """Signed Exp-Golomb."""
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def byte_align(self):
        self.pos = (self.pos + 7) & ~7

    def bits_left(self) -> int:
        return self.n - self.pos

    def more_rbsp_data(self) -> bool:
        """True if there is RBSP data before rbsp_trailing_bits."""
        if self.pos >= self.n:
            return False
        # find last byte with a set bit (the rbsp_stop_one_bit)
        last = len(self.data) - 1
        while last >= 0 and self.data[last] == 0:
            last -= 1
        if last < 0:
            return False
        b = self.data[last]
        stop_bit = 7
        while not ((b >> stop_bit) & 1):
            stop_bit -= 1
        last_data_bit = last * 8 + (7 - stop_bit)
        return self.pos < last_data_bit


# ---------------------------------------------------------------------------
# Bit writer
# ---------------------------------------------------------------------------

class BitWriter:
    """MSB-first bit writer producing an RBSP buffer (escaping applied later)."""

    __slots__ = ("buf", "held", "held_bits")

    def __init__(self):
        self.buf = bytearray()
        self.held = 0
        self.held_bits = 0

    def u(self, value: int, nbits: int):
        assert nbits <= 32 and (nbits == 32 or value < (1 << nbits)), (value, nbits)
        self.held = (self.held << nbits) | value
        self.held_bits += nbits
        while self.held_bits >= 8:
            self.held_bits -= 8
            self.buf.append((self.held >> self.held_bits) & 0xFF)
        self.held &= (1 << self.held_bits) - 1

    def flag(self, v: int):
        self.u(1 if v else 0, 1)

    def ue(self, value: int):
        assert value >= 0
        code = value + 1
        nbits = code.bit_length()
        self.u(0, nbits - 1)
        self.u(code, nbits)

    def se(self, value: int):
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def byte_align_with_stop_bit(self):
        """rbsp_trailing_bits(): stop one bit then zero pad."""
        self.u(1, 1)
        if self.held_bits:
            self.u(0, 8 - self.held_bits)

    def align_zero(self):
        if self.held_bits:
            self.u(0, 8 - self.held_bits)

    def num_bits(self) -> int:
        return len(self.buf) * 8 + self.held_bits

    def get_bytes(self) -> bytes:
        assert self.held_bits == 0, "unaligned bitstream"
        return bytes(self.buf)


def make_nal(nal_type: int, rbsp: bytes, temporal_id: int = 0,
             layer_id: int = 0) -> bytes:
    """2-byte NAL header + escaped payload (no start code)."""
    hdr = bytes([(nal_type << 1) | (layer_id >> 5),
                 ((layer_id & 31) << 3) | (temporal_id + 1)])
    return hdr + insert_emulation_prevention(rbsp)


def write_annexb(nals: list[bytes], first_long: bool = True) -> bytes:
    """Join NAL units with start codes. Parameter-set and first NALs get
    4-byte start codes (AnnexBwrite.h semantics)."""
    out = bytearray()
    for i, nal in enumerate(nals):
        nal_type = (nal[0] >> 1) & 63
        long_sc = i == 0 or nal_type in (32, 33, 34)  # VPS/SPS/PPS
        out += b"\x00\x00\x00\x01" if long_sc else b"\x00\x00\x01"
        out += nal
    return bytes(out)
