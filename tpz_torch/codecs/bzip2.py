"""bzip2 codec on a torch device (port of tpz/codecs/bzip2.py).

There is no "auto" and no backend choice: `device` names where the work
runs, and a CUDA device without a card raises. Encode runs every
non-empty buffer on the device (the host does RLE1 and the framing). A
stream the device decode declines decodes on the host and is counted in
kernels/bzip2_pipeline.host_declines. `IncrementalDecoder`, the engine
of api.DecodeStream, decodes each completed block on the host through
the C++ decoder, as the reference's does.
"""

from __future__ import annotations

import numpy as np

from tpz_torch import oracle
from tpz_torch.errors import CompressionError, DataError, UnexpectedEof
from tpz_torch.kernels import bzip2_pipeline
from tpz_torch.kernels.bzip2_pipeline import (BLOCK_MAGIC, EOS_MAGIC,
                                              _peek_bits, _splice_eos)
from tpz_torch.utils.profiling import _nohook


def compress(data: bytes, level: int = 9, *, device="cuda") -> bytes:
    return bzip2_pipeline.compress(data, level, device)


def compress_many(datas, level: int = 9, *, device="cuda",
                  stage_hook=_nohook) -> list[bytes]:
    """Batch encode: every buffer's blocks share one device dispatch; each
    buffer is its own stream."""
    return bzip2_pipeline.compress_many(list(datas), level, device,
                                        stage_hook)


def decompress(data: bytes, *, device="cuda") -> bytes:
    return bzip2_pipeline.decompress(data, device)


def decompress_many(datas, *, device="cuda",
                    stage_hook=_nohook) -> list[bytes]:
    """Batch decode: every stream's blocks of one level bucket share one
    device dispatch."""
    return bzip2_pipeline.decompress_many(list(datas), device, stage_hook)


def _find_magics(buf, start_bit: int, end_bit: int) -> list[int]:
    """Bit positions in [start_bit, end_bit - 48] where a 48-bit block or
    end-of-stream magic begins. They are candidates: compressed payload
    can hold the pattern by chance, and callers verify by decoding."""
    b = np.frombuffer(buf, np.uint8)
    lo = max(0, start_bit // 8)
    hi = min(len(b), (end_bit + 7) // 8)
    if hi - lo < 7:
        return []
    w = b[lo:hi].astype(np.uint16)
    out = []
    pats = [m.to_bytes(6, "big") for m in (BLOCK_MAGIC, EOS_MAGIC)]
    for s in range(8):
        if s == 0:
            # Full width: w[:-1] would drop the last byte and miss a
            # byte-aligned magic in the last 6 bytes.
            sb = w.astype(np.uint8)
        else:
            sb = (((w[:-1] << s) | (w[1:] >> (8 - s))) & 0xFF).astype(
                np.uint8)
        for pat in pats:
            cand = np.flatnonzero(sb[: len(sb) - 5] == pat[0])
            for k in range(1, 6):
                if cand.size == 0:
                    break
                cand = cand[sb[cand + k] == pat[k]]
            for c in cand:
                bitpos = (lo + int(c)) * 8 + s
                if start_bit <= bitpos <= end_bit - 48:
                    out.append(bitpos)
    out.sort()
    return out


class IncrementalDecoder:
    """Block-granular streaming .bz2 decode (port of the reference's).

    write(b) appends compressed bytes and returns the plaintext of every
    block that became complete. A block ends where the next 48-bit block
    or end-of-stream magic begins; the search runs over new bytes only (a
    cursor and a cache of candidates), and each completed block decodes
    alone, as a synthesised one-block stream, through the C++ host
    decoder, which checks its CRC; the stream's combined CRC is checked at
    its end. Cost is O(total bytes) across any write pattern. A candidate
    magic that lies inside a block's payload by chance fails its block's
    decode and is skipped."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._base = 0          # bit position of _buf[0] in the input
        self._state = "header"  # header | block
        self._level = 9
        self._crcs: list[int] = []
        self._cur = 0           # input bit of the next undecoded element
        self._scan = 0          # every magic starting below it is known
        self._cands: list[int] = []  # candidate magic starts, sorted
        self._bad: set[int] = set()  # rejected candidates
        self.ended_clean = True

    def _peek(self, gbit: int, n: int):
        return _peek_bits(bytes(self._buf), gbit - self._base, n)

    def _end_bit(self) -> int:
        return self._base + 8 * len(self._buf)

    def _extend_scan(self) -> None:
        """Scan the bytes past the frontier for candidate magics and cache
        every hit (a later magic already in the buffer is found once and
        kept)."""
        lim = self._end_bit()
        if lim - 48 < self._scan:
            return
        for c in _find_magics(self._buf, self._scan - self._base,
                              lim - self._base):
            g = c + self._base
            if g >= self._scan:
                self._cands.append(g)
        self._scan = lim - 47

    def _trim(self) -> None:
        cut = (self._cur - self._base) // 8
        if cut > (1 << 16):
            del self._buf[:cut]
            self._base += 8 * cut

    def _synth_block(self, m0: int, m1: int, crc: int) -> bytes:
        """A one-block stream: 'BZh<level>', bits [m0, m1), the
        end-of-stream magic and the combined CRC (the block's own)."""
        lo = (m0 - self._base) // 8
        hi = min(len(self._buf), (m1 - self._base + 7) // 8 + 1)
        seg = np.frombuffer(self._buf[lo:hi], np.uint8).astype(np.uint16)
        s = (m0 - self._base) & 7
        if s:
            seg = np.append(seg, 0).astype(np.uint16)
            seg = (((seg[:-1] << s) | (seg[1:] >> (8 - s))) & 0xFF)
        body = bytearray(b"BZh" + bytes([0x30 + self._level]))
        body += seg.astype(np.uint8).tobytes()
        return _splice_eos(body, 32 + (m1 - m0), [crc])

    def write(self, data: bytes) -> bytes:
        self._buf += data
        out = bytearray()
        while True:
            if self._state == "header":
                avail = self._end_bit() - self._cur
                if avail <= 0:
                    break
                self.ended_clean = False
                if avail < 32:
                    break
                hdr = self._peek(self._cur, 32)
                lvl = (hdr & 0xFF) - 0x30
                if (hdr >> 8) != 0x425A68 or not 1 <= lvl <= 9:
                    raise DataError("bad bzip2 stream header")
                self._level = lvl
                self._cur += 32
                # The previous stream's scans may have run past _cur;
                # rescanning would duplicate cached candidates.
                self._scan = max(self._scan, self._cur)
                self._cands = [g for g in self._cands if g >= self._cur]
                self._crcs = []
                self._state = "block"
            else:
                if self._end_bit() - self._cur < 48:
                    break
                magic = self._peek(self._cur, 48)
                if magic == EOS_MAGIC:
                    if self._end_bit() - self._cur < 80:
                        break
                    combined = 0
                    for c in self._crcs:
                        combined = (((combined << 1) | (combined >> 31))
                                    ^ c) & 0xFFFFFFFF
                    if self._peek(self._cur + 48, 32) != combined:
                        raise DataError("bzip2 combined CRC mismatch")
                    self._cur = -(-(self._cur + 80) // 8) * 8
                    self._state = "header"
                    self.ended_clean = True
                    self._trim()
                    continue
                if magic != BLOCK_MAGIC:
                    raise DataError("bad bzip2 block magic")
                self._extend_scan()
                nxt = next((g for g in self._cands
                            if g >= self._cur + 48 and g not in self._bad),
                           None)
                if nxt is None:
                    break
                crc = self._peek(self._cur + 48, 32)
                try:
                    out += oracle.bzip2_decode(
                        self._synth_block(self._cur, nxt, crc))
                except CompressionError:
                    # A magic inside the payload by chance: not a block
                    # boundary. Try the next candidate.
                    self._bad.add(nxt)
                    continue
                self._crcs.append(crc)
                self._bad = {b for b in self._bad if b > nxt}
                self._cands = [g for g in self._cands if g >= nxt]
                self._cur = nxt
                self._trim()
        return bytes(out)

    def finish(self) -> bytes:
        out = self.write(b"")
        if not self.ended_clean or self._state == "block":
            raise UnexpectedEof("bzip2 stream truncated")
        if self._state == "header" and self._end_bit() > self._cur:
            raise UnexpectedEof("bzip2 stream truncated")
        return out
