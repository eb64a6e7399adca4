"""A small FLAC writer for the tests: every subframe type, residual coding
and channel assignment of the format, chosen per frame by the caller, so
that a decoder can be held against known samples without an audio
dataset.

``write_flac(path, samples, frames, ...)`` writes ``samples`` (int [n,
channels] at ``bps`` bits) as the frames ``frames`` describe, each a
:class:`Frame`: its block size, channel assignment (``"independent"``,
``"left_side"``, ``"right_side"``, ``"mid_side"``) and one
:class:`Subframe` per coded channel (CONSTANT, VERBATIM, FIXED of order
0-4 or LPC with given coefficients; wasted bits; Rice coding with 4- or
5-bit parameters over 2 ** porder partitions, some of them escaped to raw
samples).  STREAMINFO carries the samples' MD5; each frame carries its
header CRC-8 and its CRC-16.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

SAMPLE_RATE_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5,
                     22050: 6, 24000: 7, 32000: 8, 44100: 9, 48000: 10,
                     96000: 11}
SAMPLE_SIZE_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}
BLOCK_SIZE_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8,
                    512: 9, 1024: 10, 2048: 11, 4096: 12, 8192: 13,
                    16384: 14, 32768: 15}
ASSIGNMENTS = {"left_side": 8, "right_side": 9, "mid_side": 10}
FIXED_COEFS = [[], [1], [2, -1], [3, -3, 1], [4, -6, 4, -1]]


@dataclasses.dataclass
class Subframe:
    kind: str = "fixed"            # constant | verbatim | fixed | lpc
    order: int = 2                 # fixed: 0-4; lpc: len(coefs)
    coefs: Sequence[int] = ()      # lpc, applied to x[i-1], x[i-2], ...
    precision: int = 12            # lpc coefficient bits
    shift: int = 10                # lpc
    wasted: int = 0                # low zero bits removed before coding
    method: int = 0                # 0: 4-bit Rice parameters, 1: 5-bit
    porder: int = 0                # 2 ** porder partitions
    escape: Sequence[int] = ()     # partitions written as raw samples


@dataclasses.dataclass
class Frame:
    block: int
    subframes: List[Subframe]
    assignment: str = "independent"


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def bits(self, v: int, n: int):
        if n == 0:
            return
        self.acc = (self.acc << n) | (int(v) & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def unary(self, q: int):
        """q zeros, then a one."""
        while q >= 32:
            self.bits(0, 32)
            q -= 32
        self.bits(1, q + 1)

    def align(self):
        if self.n:
            self.bits(0, 8 - self.n)


def crc8(data: bytes) -> int:
    c = 0
    for byte in data:
        c ^= byte
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
    return c


def crc16(data: bytes) -> int:
    c = 0
    for byte in data:
        c ^= byte << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else \
                (c << 1) & 0xFFFF
    return c


def _coded_number(w: BitWriter, v: int):
    """The UTF-8-like coding of the frame number."""
    if v < 0x80:
        w.bits(v, 8)
        return
    n = 1
    while v >= 1 << (6 * n + 6 - n):
        n += 1
    w.bits(((0xFF << (7 - n)) & 0xFF) | (v >> (6 * n)), 8)
    for i in range(n - 1, -1, -1):
        w.bits(0x80 | ((v >> (6 * i)) & 0x3F), 8)


def _signed_width(vals) -> int:
    """Bits of the narrowest two's complement that holds every value (0
    when all are 0, as an escaped partition of zeros is written)."""
    return max([(v if v >= 0 else -v - 1).bit_length() + 1
                for v in vals if v] or [0])


def _residuals(w: BitWriter, res: List[int], order: int, block: int,
               sf: Subframe):
    w.bits(sf.method, 2)
    w.bits(sf.porder, 4)
    parts = 1 << sf.porder
    per = block >> sf.porder
    assert per << sf.porder == block and per >= order
    escape_code = 15 if sf.method == 0 else 31
    max_param = escape_code - 1
    pos = 0
    for p in range(parts):
        n = per - (order if p == 0 else 0)
        vals = res[pos:pos + n]
        pos += n
        if p in sf.escape:
            width = _signed_width(vals)
            w.bits(escape_code, 5 if sf.method else 4)
            w.bits(width, 5)
            for v in vals:
                w.bits(v, width)
            continue
        zig = [2 * v if v >= 0 else -2 * v - 1 for v in vals]
        mean = sum(zig) / max(len(zig), 1)
        k = min(max(int(mean).bit_length() - 1, 0), max_param)
        w.bits(k, 5 if sf.method else 4)
        for u in zig:
            w.unary(u >> k)
            w.bits(u, k)
    assert pos == block - order


def _subframe(w: BitWriter, x: List[int], bps: int, sf: Subframe):
    block = len(x)
    if sf.wasted:
        assert all(v % (1 << sf.wasted) == 0 for v in x)
        x = [v >> sf.wasted for v in x]
        bps -= sf.wasted
    w.bits(0, 1)
    if sf.kind == "constant":
        assert len(set(x)) == 1
        typ = 0
    elif sf.kind == "verbatim":
        typ = 1
    elif sf.kind == "fixed":
        typ = 8 + sf.order
    else:
        typ = 31 + len(sf.coefs)
    w.bits(typ, 6)
    if sf.wasted:
        w.bits(1, 1)
        w.unary(sf.wasted - 1)
    else:
        w.bits(0, 1)
    if sf.kind == "constant":
        w.bits(x[0], bps)
        return
    if sf.kind == "verbatim":
        for v in x:
            w.bits(v, bps)
        return
    if sf.kind == "fixed":
        order, coefs, shift = sf.order, FIXED_COEFS[sf.order], 0
    else:
        order, coefs, shift = len(sf.coefs), list(sf.coefs), sf.shift
    for v in x[:order]:
        w.bits(v, bps)
    if sf.kind == "lpc":
        w.bits(sf.precision - 1, 4)
        w.bits(shift, 5)
        for c in coefs:
            assert -(1 << (sf.precision - 1)) <= c < 1 << (sf.precision - 1)
            w.bits(c, sf.precision)
    res = [x[i] - (sum(c * x[i - 1 - j] for j, c in enumerate(coefs))
                   >> shift)
           for i in range(order, block)]
    _residuals(w, res, order, block, sf)


def _frame(index: int, pcm: np.ndarray, frame: Frame, sample_rate: int,
           bps: int) -> bytes:
    w = BitWriter()
    w.bits(0x3FFE, 14)
    w.bits(0, 1)                           # reserved
    w.bits(0, 1)                           # fixed block size
    block = frame.block
    if block in BLOCK_SIZE_CODES:
        bs_code, tail = BLOCK_SIZE_CODES[block], None
    elif block <= 256:
        bs_code, tail = 6, (block - 1, 8)
    else:
        bs_code, tail = 7, (block - 1, 16)
    w.bits(bs_code, 4)
    w.bits(SAMPLE_RATE_CODES[sample_rate], 4)
    channels = pcm.shape[1]
    w.bits(ASSIGNMENTS.get(frame.assignment, channels - 1), 4)
    w.bits(SAMPLE_SIZE_CODES[bps], 3)
    w.bits(0, 1)                           # reserved
    _coded_number(w, index)
    if tail:
        w.bits(*tail)
    w.bits(crc8(bytes(w.out)), 8)
    cols = [[int(v) for v in pcm[:, c]] for c in range(channels)]
    widths = [bps] * channels
    if frame.assignment != "independent":
        left, right = cols
        side = [a - b for a, b in zip(left, right)]
        if frame.assignment == "left_side":
            cols, widths = [left, side], [bps, bps + 1]
        elif frame.assignment == "right_side":
            cols, widths = [side, right], [bps + 1, bps]
        else:
            mid = [(a + b) >> 1 for a, b in zip(left, right)]
            cols, widths = [mid, side], [bps, bps + 1]
    assert len(frame.subframes) == len(cols)
    for x, width, sf in zip(cols, widths, frame.subframes):
        _subframe(w, x, width, sf)
    w.align()
    w.bits(crc16(bytes(w.out)), 16)
    return bytes(w.out)


def md5_of(samples: np.ndarray, bps: int) -> bytes:
    width = (bps + 7) // 8
    raw = samples.reshape(-1).astype("<i4").view(np.uint8).reshape(-1, 4)
    return hashlib.md5(raw[:, :width].tobytes()).digest()


def write_flac(path, samples: np.ndarray, frames: List[Frame],
               sample_rate: int = 16000, bps: int = 16,
               md5: Optional[bytes] = None) -> Tuple[int, ...]:
    """Write ``samples`` (int [n, channels]) as ``frames`` (their blocks
    must add up to n).  ``md5``: STREAMINFO's MD5 (default: the samples').
    Returns each frame's offset in the file."""
    samples = np.asarray(samples)
    n, channels = samples.shape
    assert sum(f.block for f in frames) == n
    blocks = [f.block for f in frames]
    head = BitWriter()
    head.out += b"fLaC"
    head.bits(0, 1)                        # not the last metadata block
    head.bits(0, 7)                        # STREAMINFO
    head.bits(34, 24)
    head.bits(max(blocks[:-1] or blocks), 16)
    head.bits(max(blocks), 16)
    head.bits(0, 24)                       # frame sizes unknown
    head.bits(0, 24)
    head.bits(sample_rate, 20)
    head.bits(channels - 1, 3)
    head.bits(bps - 1, 5)
    head.bits(n, 36)
    head.out += md5 if md5 is not None else md5_of(samples, bps)
    head.bits(1, 1)                        # last metadata block: PADDING
    head.bits(1, 7)
    head.bits(8, 24)
    head.out += bytes(8)
    out = bytearray(head.out)
    offsets = []
    start = 0
    for i, f in enumerate(frames):
        offsets.append(len(out))
        out += _frame(i, samples[start:start + f.block], f, sample_rate, bps)
        start += f.block
    with open(path, "wb") as fh:
        fh.write(bytes(out))
    return tuple(offsets)
