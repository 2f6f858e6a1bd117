"""Bit packing in torch (port of tpz/kernels/bitpack.py `length_symbol`,
`dist_symbol`, `assemble_stream_v2` and `assemble_stream_msb`).

DEFLATE (LSB-first):

Every input position contributes up to two slots (literal/length code
with its extra bits, distance code with its extra bits) plus one
end-of-block slot per block. Tokens are emitted in position order, so a
slot's absolute bit offset is the block's body offset plus the row's
exclusive prefix sum of slot widths; dead slots have width 0 and shift
nothing. Each slot (<= 28 bits) lands in at most two 32-bit words, and
contributions to one word occupy disjoint bit ranges, so a scatter-add
assembles the words exactly (add == or). u32 values ride in int64 (H3).
"""

from __future__ import annotations

import torch

from tpz_torch.utils.bits import U32

STORED_CHUNK = 32768  # must match cpp/deflate.cc kStoredChunk


def _bitlen(x: torch.Tensor, maxbits: int) -> torch.Tensor:
    c = torch.zeros_like(x)
    for k in range(maxbits):
        c = c + (x >= (1 << k)).to(x.dtype)
    return c


def length_symbol(ml: torch.Tensor):
    """RFC 1951 length symbol, extra-bit count and extra value for match
    lengths 3..258 (int32 in, int32 out)."""
    l = torch.clamp(ml - 3, min=0)
    e = torch.clamp(_bitlen(l, 9) - 3, min=0)
    sym_mid = 257 + 4 * (e + 1) + ((l >> e) & 3)
    sym = torch.where(ml <= 10, 254 + ml, sym_mid)
    sym = torch.where(ml >= 258, 285, sym)
    plain = (ml <= 10) | (ml >= 258)
    extra_bits = torch.where(plain, 0, e)
    extra_val = torch.where(plain, 0, l & ((1 << e) - 1))
    return sym, extra_bits, extra_val


def dist_symbol(md: torch.Tensor):
    """RFC 1951 distance symbol, extra-bit count and extra value for
    distances 1..32768."""
    d = torch.clamp(md - 1, min=0)
    e = torch.clamp(_bitlen(d, 16) - 2, min=0)
    sym = torch.where(d < 4, d, 2 * (e + 1) + ((d >> e) & 1))
    extra_val = d & ((1 << e) - 1)
    return sym, e, extra_val


def _scatter_words(words: torch.Tensor, off: torch.Tensor, val: torch.Tensor,
                   live: torch.Tensor) -> None:
    """Add u32 slot values `val` (int64) at absolute bit offsets `off`
    into `words` (int64, last entry a spare slot for dead slots)."""
    spare = words.shape[0] - 1
    w0 = torch.where(live, off >> 5, spare - 1)
    sh = off & 31
    v = torch.where(live, val, 0)
    lo = (v << sh) & U32
    hi = torch.where(sh > 0, v >> (32 - sh), 0)
    words.index_add_(0, w0.reshape(-1), lo.reshape(-1))
    words.index_add_(0, (w0 + 1).reshape(-1), hi.reshape(-1))


def assemble_stream_v2(data_block, is_token, mlen, mdist, table320,
                       body_off, btype, block_len, chunk1_off, header,
                       total_words: int) -> torch.Tensor:
    """Pack every block's body and header bits into one u32 word stream.

    data_block [NB, B] int32 bytes; is_token [NB, B] bool; mlen/mdist
    [NB, B] int32; table320 [NB, 320] int32 packed (bit-reversed code |
    len << 16): cols 0..287 litlen, 288..317 dist, 318/319 zero (raw-byte
    slots of stored blocks); body_off, btype, block_len, chunk1_off [NB];
    header = (vals int64, nbits int32, offs int32) [NB, H] slots at
    absolute bit offsets. Returns [total_words] int64 u32 words."""
    NB, B = data_block.shape
    dev = data_block.device
    pos = torch.arange(B, device=dev, dtype=torch.int32).expand(NB, B)
    stored = (btype == 0)[:, None]
    is_match = is_token & (mlen > 0)

    lsym, l_eb, l_ev = length_symbol(torch.clamp(mlen, 0, 258))
    dsym, d_eb, d_ev = dist_symbol(torch.clamp(mdist, min=1))

    # Slot 0: literal/length code (dyn+fixed) or raw byte (stored).
    live0 = torch.where(stored, pos < block_len[:, None], is_token)
    idx0 = torch.where(stored, 318, torch.where(is_match, lsym, data_block))
    ev0 = torch.where(stored, data_block, torch.where(is_match, l_ev, 0))
    eb0 = torch.where(stored, 8, torch.where(is_match, l_eb, 0))
    # Slot 1: distance code (matches only).
    live1 = is_match & ~stored
    idx1 = 288 + torch.clamp(dsym, 0, 29)
    ev1 = torch.where(live1, d_ev, 0)
    eb1 = torch.where(live1, d_eb, 0)

    # [NB, 2B + 1]: interleaved slots, then the EOB slot (not in stored).
    live = torch.cat([torch.stack([live0, live1], 2).reshape(NB, 2 * B),
                      (btype != 0)[:, None]], dim=1)
    idx = torch.cat([torch.stack([idx0, idx1], 2).reshape(NB, 2 * B),
                     torch.full((NB, 1), 256, dtype=torch.int32, device=dev)],
                    dim=1)
    ev = torch.cat([torch.stack([ev0, ev1], 2).reshape(NB, 2 * B),
                    torch.zeros((NB, 1), dtype=torch.int32, device=dev)],
                   dim=1)
    eb = torch.cat([torch.stack([eb0, eb1], 2).reshape(NB, 2 * B),
                    torch.zeros((NB, 1), dtype=torch.int32, device=dev)],
                   dim=1)

    cl = torch.gather(table320, 1, torch.where(live, idx, 318).to(torch.int64))
    clen = cl >> 16
    code = (cl & 0xFFFF).to(torch.int64)
    nbits = torch.where(live, clen + eb, 0)
    val = torch.where(live, code | (ev.to(torch.int64) << clen), 0)

    excl = torch.cumsum(nbits, dim=1) - nbits
    off = body_off[:, None].to(torch.int64) + excl
    # Stored chunk 1 jumps over the second chunk's 40-bit header (body_off
    # is chunk 0's data offset, so the gap is chunk1_off - body_off - 8c0).
    gap = torch.where(chunk1_off > 0,
                      chunk1_off - body_off - 8 * STORED_CHUNK, 0)
    col = torch.arange(2 * B + 1, device=dev).expand(NB, 2 * B + 1)
    off = off + torch.where(stored & ((col >> 1) >= STORED_CHUNK),
                            gap[:, None].to(torch.int64), 0)

    words = torch.zeros(total_words + 2, dtype=torch.int64, device=dev)
    _scatter_words(words, off, val, nbits > 0)
    hv, hn, ho = header
    _scatter_words(words, ho.to(torch.int64), hv.to(torch.int64), hn > 0)
    return words[:total_words]


def assemble_stream_msb(vals, nbits, body_off, total_words: int):
    """MSB-first bit packing (the LZHUF and bzip2 direction): slots in
    position order per block at body_off + the row's exclusive prefix sum
    of widths. Word w holds stream bits [32w, 32w + 32) with bit 32w at
    its MSB; the caller views the words big-endian to get bytes.

    vals [NB, S] int64 u32 values (the value's MSB is written first);
    nbits [NB, S] int32, 0..31 (0 = dead slot); body_off [NB] absolute
    bit offsets. Returns [total_words] int64 u32 words. The reference's
    cumsum-and-sort word assembly only spared the TPU's per-update scatter
    cost; a slot lands in at most two words with disjoint bit ranges, so
    an `index_add_` of both halves assembles them exactly (add == or)."""
    n = nbits.to(torch.int64)
    off = (body_off.to(torch.int64)[:, None] + torch.cumsum(n, dim=1) - n)
    v = vals.to(torch.int64) & U32
    # The value occupies bits [shift, shift + n) from the top of the 64-bit
    # big-endian window at word w0: it is shifted left by s = 64 - shift - n
    # (2 <= s <= 64 for 1 <= n <= 31), and split into the two words.
    shift = off & 31
    s = 64 - shift - n
    high = s >= 32
    hi = torch.where(high, v << torch.clamp(s - 32, 0, 32),
                     v >> torch.clamp(32 - s, 0, 32)) & U32
    lo = torch.where(high, 0, (v & (U32 >> torch.clamp(s, 0, 32)))
                     << torch.clamp(s, 0, 31))
    live = n > 0
    words = torch.zeros(total_words + 2, dtype=torch.int64,
                        device=vals.device)
    _scatter_msb(words, off >> 5, hi, lo, live)
    return words[:total_words] & U32


def _scatter_msb(words, w0, hi, lo, live) -> None:
    """Add hi into word w0 and lo into w0 + 1 for live slots; dead slots
    and words past the end land on the two spare entries."""
    spare = words.shape[0] - 2
    w0 = torch.where(live & (w0 < spare), w0, spare)
    words.index_add_(0, w0.reshape(-1), torch.where(live, hi, 0).reshape(-1))
    words.index_add_(0, (w0 + 1).reshape(-1),
                     torch.where(live, lo, 0).reshape(-1))
