"""LHA `-lh5-` (LZHUF over an 8 KiB dictionary), written and read from
the format alone, in the port's container.

The format, as LHa for UNIX (https://github.com/jca02266/lha) and the
ar002 code it descends from write it: an LZ77 parse over the last 8192
bytes (matches of 3 to 256 bytes) whose tokens are coded in blocks of
static Huffman codes, bits MSB first. A block is

  16 bits       its token count (1 to 65,535)
  T table       TBIT = 5 bits n; n == 0: TBIT bits, the one symbol (all
                lengths 0); else n lengths of 3 bits, 7 extended by a
                unary run of ones ended by a zero, and after the third a
                2-bit count of zero lengths skipped
  C table       CBIT = 9 bits n; n == 0: CBIT bits, the one symbol; else
                n lengths of the 510 literal and length symbols, each a
                T code: 0 one zero length, 1 + 4 bits 3-18 zeros, 2 + 9
                bits 20-531 zeros, k >= 3 the length k - 2
  P table       PBIT = 4 bits n; n == 0: PBIT bits, the one symbol; else
                n lengths as the T table's, without the skip
  tokens        a C code: a byte below 256, else the match length
                sym - 253; after a match a P code c, then c - 1 raw bits
                r: the distance is c + 1 for c < 2, else 2^(c-1) + r + 1

Codes are canonical (shorter codes first, then by symbol) and complete,
of at most 16 bits; a table with one symbol is the n == 0 form and its
code takes no bits. The body is padded to a byte with zero bits.

The container is the port's: b"TPZL", b"lh5", the plaintext's size as
<Q, the body. LHA keeps a CRC-16 of the plaintext in its archive header;
the container has none, so the size is the only integrity field.

The writer follows LHa for UNIX 1.14i where it decides what the body
holds:

- the parse, `encode` in slide.c: at each position the longest match
  over the last 8191 bytes, the nearest of equal length
  (`search_dict_1`, which breaks off at 256 bytes); the match is sent
  unless the match one byte on is longer, in which case the byte is
  sent as a literal (one step of lazy evaluation). LHA walks a 3-byte
  hash chain back through the whole window, re-hashing further in where
  a chain grew past 256 (`too_flag`); this writer tries the CHAIN
  nearest earlier positions with the same three bytes, so its matches
  are at most as long as LHA's;
- the blocks, `output_st1` in huf.c: tokens are buffered in
  `bufsiz` = 32 KiB (`alloc_buf`), a literal one byte, a match three,
  and a flag byte before every eight tokens; at each flag byte the
  block is sent when `output_pos >= bufsiz - 3 * CHAR_BIT`. So a block
  holds at most ~29,100 tokens, never the count field's 65,535;
  `encode_body` takes other cuts for hand-built streams;
- the code lengths, `make_tree` and `make_len` in maketree.c (below).

LHA stores a member whose body would outgrow its input as `-lh0-`; the
container has no such method, so this writer always writes the body.

NumPy does the work that is the same at every position (the match
candidates, by one sort; the bits each position would decode; the bit
writer, by prefix sums; the LZ77 copies, by pointer jumping). The walks
that follow one token to the next are plain Python loops. Imports the
standard library and NumPy alone.
"""

from __future__ import annotations

import heapq
import struct

import numpy as np

MAGIC = b"TPZL"
METHOD = b"lh5"
HEADER = len(MAGIC) + len(METHOD) + 8
DICBIT = 13
WINDOW = 1 << DICBIT
THRESHOLD = 3
MAX_MATCH = 256
NC = 255 + MAX_MATCH + 2 - THRESHOLD  # 510
NT = 19
TBIT = 5
CBIT = 9
NP = DICBIT + 1
PBIT = 4
MAX_LEN = 16
# The block header's largest token count.
MAX_COUNT = 0xFFFF
# LHA's token buffer (huf.c: alloc_buf, output_st1): BUF_BYTES, and a
# block sent at a flag byte once BUF_BYTES - BUF_SLACK of it are used.
BUF_BYTES = 16 * 1024 * 2
BUF_SLACK = 3 * 8
# Candidates tried at each position, nearest first.
CHAIN = 16


# ---------------------------------------------------------------- codes

def huffman_lengths(freq) -> tuple[np.ndarray | None, int]:
    """(code lengths, the one symbol) of `freq` as LHA's make_tree and
    make_len build them: a Huffman tree, its leaves deeper than 16 bits
    put at 16, then Kraft's sum restored by lengthening the shortest
    code that can take it; the longest codes go to the leaves taken
    first from the heap (the rarest). Fewer than two symbols used:
    (None, the symbol or 0)."""
    n = len(freq)
    used = [int(s) for s in np.flatnonzero(freq)]
    if len(used) < 2:
        return None, (used[0] if used else 0)
    heap = [(int(freq[s]), s) for s in used]
    heapq.heapify(heap)
    kids, taken, node = {}, [], n
    while len(heap) > 1:
        fa, a = heapq.heappop(heap)
        fb, b = heapq.heappop(heap)
        taken += [x for x in (a, b) if x < n]
        kids[node] = (a, b)
        heapq.heappush(heap, (fa + fb, node))
        node += 1
    count = [0] * (MAX_LEN + 1)
    stack = [(heap[0][1], 0)]
    while stack:
        x, d = stack.pop()
        if x < n:
            count[min(d, MAX_LEN)] += 1
        else:
            stack += [(kids[x][0], d + 1), (kids[x][1], d + 1)]
    cum = sum(count[i] << (MAX_LEN - i) for i in range(1, MAX_LEN + 1))
    while cum != 1 << MAX_LEN:
        count[MAX_LEN] -= 1
        for i in range(MAX_LEN - 1, 0, -1):
            if count[i]:
                count[i] -= 1
                count[i + 1] += 2
                break
        cum -= 1
    lens = np.zeros(n, np.int64)
    it = iter(taken)
    for k in range(MAX_LEN, 0, -1):
        for _ in range(count[k]):
            lens[next(it)] = k
    return lens, 0


def canonical_codes(lens) -> np.ndarray:
    """Canonical codes: by length, then by symbol, shorter codes first."""
    count = np.bincount(lens, minlength=MAX_LEN + 1)
    start = [0] * (MAX_LEN + 2)
    for i in range(1, MAX_LEN + 1):
        start[i + 1] = (start[i] + int(count[i])) << 1
    codes = np.zeros(len(lens), np.int64)
    for s in np.flatnonzero(lens):
        k = int(lens[s])
        codes[s] = start[k]
        start[k] += 1
    return codes


def _rle_zeros(clen):
    """The C lengths, trailing zeros cut, as T symbols: (symbol, extra
    value, extra bits) in order, as LHA's write_c_len emits them."""
    n = len(clen)
    while n > 0 and clen[n - 1] == 0:
        n -= 1
    out, i = [], 0
    while i < n:
        k = int(clen[i])
        i += 1
        if k:
            out.append((k + 2, 0, 0))
            continue
        run = 1
        while i < n and clen[i] == 0:
            i += 1
            run += 1
        if run <= 2:
            out += [(0, 0, 0)] * run
        elif run <= 18:
            out.append((1, run - 3, 4))
        elif run == 19:
            out += [(0, 0, 0), (1, 15, 4)]
        else:
            out.append((2, run - 20, CBIT))
    return n, out


def _pt_lens(fields, lens, nbit, special):
    """A T or P table's lengths as LHA's write_pt_len writes them."""
    n = len(lens)
    while n > 0 and lens[n - 1] == 0:
        n -= 1
    fields.append((n, nbit))
    i = 0
    while i < n:
        k = int(lens[i])
        i += 1
        if k <= 6:
            fields.append((k, 3))
        else:
            fields.append(((1 << (k - 3)) - 2, k - 3))
        if i == special:
            while i < 6 and lens[i] == 0:
                i += 1
            fields.append(((i - special) & 3, 2))


def _block_header(fields, count, clen, cone, plen, pone):
    fields.append((count, 16))
    if clen is None:
        fields += [(0, TBIT), (0, TBIT), (0, CBIT), (cone, CBIT)]
    else:
        n, tsyms = _rle_zeros(clen)
        tfreq = np.bincount([s for s, _, _ in tsyms], minlength=NT)
        tlen, tone = huffman_lengths(tfreq)
        if tlen is None:
            fields += [(0, TBIT), (tone, TBIT)]
            tlen, tcode = np.zeros(NT, np.int64), np.zeros(NT, np.int64)
        else:
            _pt_lens(fields, tlen, TBIT, 3)
            tcode = canonical_codes(tlen)
        fields.append((n, CBIT))
        for s, v, nb in tsyms:
            fields.append((int(tcode[s]), int(tlen[s])))
            if nb:
                fields.append((v, nb))
    if plen is None:
        fields += [(0, PBIT), (pone, PBIT)]
    else:
        _pt_lens(fields, plen, PBIT, -1)


# --------------------------------------------------------------- writer

def _words(a: np.ndarray) -> np.ndarray:
    """Little-endian 64-bit words at every byte offset of a (zero past
    its end), for comparing 8 bytes at a time."""
    pad = np.concatenate([a, np.zeros(MAX_MATCH + 16, np.uint8)])
    return np.ndarray((a.size + MAX_MATCH + 8,), "<u8", pad, 0, (1,))


def _match_len(words, i, j, lim):
    """Common prefix of the bytes at i and at j (j < i), at most lim."""
    got = np.zeros(i.size, np.int64)
    act = np.arange(i.size)
    while act.size:
        x = words[i[act] + got[act]] ^ words[j[act] + got[act]]
        eq = x == 0
        ne = act[~eq]
        low = x[~eq] & (~x[~eq] + np.uint64(1))
        got[ne] += (np.frexp(low.astype(np.float64))[1] - 1) // 8
        got[act[eq]] += 8
        act = act[eq]
        act = act[got[act] < lim[act]]
    return np.minimum(got, lim)


def _best_matches(a: np.ndarray):
    """(length, distance) of the longest match at each position over the
    last WINDOW - 1 bytes, the nearest of equal length: the CHAIN nearest
    earlier positions with the same three bytes, found by one stable
    sort of the 3-byte keys, a position dropping out once its match
    takes all 256 bytes it may (or all that are left). Length 0 where
    none."""
    n = a.size
    best = np.zeros(n, np.int64)
    dist = np.zeros(n, np.int64)
    m = n - THRESHOLD + 1
    if m < 2:
        return best, dist
    b = a.astype(np.int64)
    key = (b[:m] << 16) | (b[1:m + 1] << 8) | b[2:m + 2]
    order = np.argsort(key, kind="stable")
    same = key[order[1:]] == key[order[:-1]]
    prev = np.full(m, -1, np.int64)
    prev[order[1:][same]] = order[:-1][same]
    words = _words(a)
    pad = words.base
    pos = np.arange(m)
    lim = np.minimum(MAX_MATCH, n - pos)
    cand = prev.copy()
    live = np.flatnonzero((cand >= 0) & (pos - cand < WINDOW))
    for _ in range(CHAIN):
        if not live.size:
            break
        j = cand[live]
        # A candidate can only be longer where it also holds the byte
        # just past the longest match found so far.
        b_i = best[live]
        try_ = (b_i < lim[live]) & (pad[live + b_i] == pad[j + b_i])
        ti, tj = live[try_], j[try_]
        got = _match_len(words, ti, tj, lim[ti])
        better = got > best[ti]
        best[ti[better]] = got[better]
        dist[ti[better]] = ti[better] - tj[better]
        cand[live] = prev[j]
        live = live[(cand[live] >= 0) & (live - cand[live] < WINDOW)
                    & (best[live] < lim[live])]
    return best, dist


def _lazy(best):
    """LHA's parse: each token's start, and its match length (0 for a
    literal). At p a match of best[p] >= 3 bytes, unless best[p + 1] is
    longer; else a literal."""
    longer = np.concatenate([best[1:] > best[:-1], [False]])
    mlen = np.where((best >= THRESHOLD) & ~longer, best, 0)
    step = np.maximum(mlen, 1).tolist()
    starts, p, n = [], 0, len(step)
    while p < n:
        starts.append(p)
        p += step[p]
    starts = np.array(starts, np.int64)
    return starts, mlen[starts]


def _bit_length(v: np.ndarray) -> np.ndarray:
    return np.frexp(v.astype(np.float64))[1].astype(np.int64)


def _pack(vals: np.ndarray, nbits: np.ndarray) -> bytes:
    """Fields of at most 16 bits, MSB first, end to end, padded to a
    byte with zeros. Each field lands in the 3 bytes at its offset; the
    fields' bits are disjoint, so a byte's parts are summed."""
    off = np.cumsum(nbits) - nbits
    total = int(off[-1] + nbits[-1]) if nbits.size else 0
    nbytes = (total + 7) // 8
    v = vals.astype(np.int64) << (24 - (off & 7) - nbits)
    at = off >> 3
    out = np.zeros(nbytes + 3, np.float64)
    for k in range(3):
        out += np.bincount(at + k, weights=(v >> (16 - 8 * k)) & 0xFF,
                           minlength=nbytes + 3)
    return out[:nbytes].astype(np.uint8).tobytes()


def lha_blocks(is_match: np.ndarray) -> list:
    """(first token, end token) of each block as LHA's output_st1 cuts
    them: the tokens in groups of eight from the stream's start, each
    group a flag byte and a byte a literal, three a match; a block ends
    before the first group at whose flag byte it has used BUF_BYTES -
    BUF_SLACK bytes or more."""
    n = is_match.size
    groups = np.add.reduceat(np.where(is_match, 3, 1),
                             np.arange(0, n, 8)) + 1 if n else []
    used = np.concatenate([[0], np.cumsum(groups)])
    s, cuts = 0, []
    while s < len(groups):
        e = min(int(np.searchsorted(used, used[s] + BUF_BYTES - BUF_SLACK)),
                len(groups))
        cuts.append((8 * s, min(8 * e, n)))
        s = e
    return cuts


def encode_body(data: bytes, blocks=lha_blocks) -> bytes:
    """The raw -lh5- body of `data` (b"" for b""), its tokens sent in
    the blocks that blocks(is_match) cuts."""
    a = np.frombuffer(bytes(data), np.uint8)
    if not a.size:
        return b""
    best, dist = _best_matches(a)
    starts, mlen = _lazy(best)
    is_match = mlen > 0
    csym = np.where(is_match, mlen - THRESHOLD + 256, a[starts])
    p = np.where(is_match, dist[starts] - 1, 0)
    psym = _bit_length(p)
    raw_n = np.maximum(psym - 1, 0)
    raw = p & ((1 << raw_n) - 1)
    vals, nbits = [], []
    for t0, t1 in blocks(is_match):
        cs, ps, m = csym[t0:t1], psym[t0:t1], is_match[t0:t1]
        clen, cone = huffman_lengths(np.bincount(cs, minlength=NC))
        plen, pone = huffman_lengths(np.bincount(ps[m], minlength=NP))
        fields = []
        _block_header(fields, t1 - t0, clen, cone, plen, pone)
        vals.append(np.array([v for v, _ in fields], np.int64))
        nbits.append(np.array([b for _, b in fields], np.int64))
        ccode = canonical_codes(clen) if clen is not None else None
        pcode = canonical_codes(plen) if plen is not None else None
        z = np.zeros(t1 - t0, np.int64)
        tok = np.stack([
            ccode[cs] if clen is not None else z,
            clen[cs] if clen is not None else z,
            np.where(m, pcode[ps], 0) if plen is not None else z,
            np.where(m, plen[ps], 0) if plen is not None else z,
            np.where(m, raw[t0:t1], 0), np.where(m, raw_n[t0:t1], 0)], 1)
        vals.append(tok[:, 0::2].reshape(-1))
        nbits.append(tok[:, 1::2].reshape(-1))
    return _pack(np.concatenate(vals), np.concatenate(nbits))


def encode(data: bytes, level: int) -> bytes:
    """One stream in the port's container, its body as a plain -lh5-
    writer writes it: LHA's lazy parse over CHAIN candidates, its blocks
    (lha_blocks) and its code lengths. LZHUF has no levels; `level` is
    taken and not used."""
    return MAGIC + METHOD + struct.pack("<Q", len(data)) + encode_body(data)


# --------------------------------------------------------------- reader

class _Reader:
    """The body's bits, MSB first. Fields come from `get`; the decode of
    a block's tokens reads any position through `peek`."""

    def __init__(self, body: bytes):
        self.nbits = 8 * len(body)
        b = np.concatenate([np.frombuffer(body, np.uint8),
                            np.zeros(32, np.uint8)]).astype(np.int64)
        # The 32 bits at each byte offset, big-endian; zero past the end,
        # far enough for a token that starts up to 64 bits past it.
        self.w = (b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]
        self.pos = 0

    def peek(self, q: np.ndarray, n) -> np.ndarray:
        """n <= 25 bits (a number, or one for each q) at each bit q."""
        return (self.w[q >> 3] >> (32 - (q & 7) - n)) & ((1 << n) - 1)

    def get(self, n: int) -> int:
        if self.pos + n > self.nbits:
            raise ValueError("the body ends inside a block header")
        v = int(self.w[self.pos >> 3]) >> (32 - (self.pos & 7) - n)
        self.pos += n
        return v & ((1 << n) - 1)


def _read_pt_lens(r: _Reader, nsym: int, nbit: int, special: int):
    """(lengths, None) or (None, the one symbol) of a T or P table."""
    n = r.get(nbit)
    if n == 0:
        one = r.get(nbit)
        if one >= nsym:
            raise ValueError(f"one-symbol table names symbol {one}")
        return None, one
    if n > nsym:
        raise ValueError(f"table of {n} lengths, the alphabet has {nsym}")
    lens = np.zeros(nsym, np.int64)
    i = 0
    while i < n:
        k = r.get(3)
        if k == 7:
            while r.get(1):
                k += 1
                if k > MAX_LEN:
                    raise ValueError("a code length past 16 bits")
        lens[i] = k
        i += 1
        if i == special:
            skip = r.get(2)
            if i + skip > n:
                raise ValueError("zero lengths skipped past the table")
            i += skip
    return lens, None


def _read_c_lens(r: _Reader, tdec):
    n = r.get(CBIT)
    if n == 0:
        one = r.get(CBIT)
        if one >= NC:
            raise ValueError(f"one-symbol C table names symbol {one}")
        return None, one
    if n > NC:
        raise ValueError(f"C table of {n} lengths")
    lens = np.zeros(NC, np.int64)
    i = 0
    while i < n:
        sym, k = tdec(r)
        if sym == 0:
            i += 1
            continue
        if sym <= 2:
            run = 3 + r.get(4) if sym == 1 else 20 + r.get(CBIT)
            if i + run > n:
                raise ValueError("zero lengths run past the C table")
            i += run
            continue
        lens[i] = sym - 2
        i += 1
    return lens, None


def _table(lens, one, nsym):
    """symbol << 5 | code length for every 16-bit window: a complete
    canonical code, or the one symbol at 0 bits."""
    if lens is None:
        return np.full(1 << MAX_LEN, one << 5, np.int64)
    syms = np.flatnonzero(lens)
    span = 1 << (MAX_LEN - lens[syms])
    if syms.size < 2 or int(span.sum()) != 1 << MAX_LEN:
        raise ValueError("a code table that is not one complete code")
    first = canonical_codes(lens)[syms] << (MAX_LEN - lens[syms])
    order = np.argsort(first)
    return np.repeat(syms[order] << 5 | lens[syms][order], span[order])


def _token_at(r: _Reader, q, ct, pt):
    """For a token that would start at each bit q: its C symbol, the bit
    after its C code, its P symbol, the bit of its raw bits and their
    count (0 for a literal)."""
    e = ct[r.peek(q, MAX_LEN)]
    cs, q2 = e >> 5, q + (e & 31)
    f = pt[r.peek(q2, MAX_LEN)]
    ps = f >> 5
    return (cs, q2, ps, q2 + (f & 31),
            np.where(cs >= 256, np.maximum(ps - 1, 0), 0))


def _next_bits(r: _Reader, q, ct, pt):
    """For each bit position q: the bit just past the token that would
    start there."""
    cs, q2, _, raw_at, n = _token_at(r, q, ct, pt)
    return np.where(cs >= 256, raw_at + n, q2)


def _block_tokens(r: _Reader, count: int, ct, pt):
    """The starts of the block's `count` tokens from r.pos, and the bit
    after the last. Each bit position's next token start is computed in
    bulk, a stretch at a time; the walk from one start to the next is
    serial."""
    parts, q, k = [], r.pos, 0
    while k < count:
        if q > r.nbits:
            raise ValueError("the body ends inside a block's tokens")
        lo = q
        n = min(12 * (count - k) + 64, r.nbits + 64 - lo)
        step = memoryview(_next_bits(r, np.arange(lo, lo + n), ct, pt) - lo)
        starts, i = [], 0
        walk = starts.append
        for _ in range(count - k):
            if i >= n:
                break
            walk(i)
            i = step[i]
        parts.append(np.array(starts, np.int64) + lo)
        k += len(starts)
        q = lo + i
    return np.concatenate(parts), q


def _tokens(r: _Reader, q, ct, pt):
    """(is match, literal or length, distance) of the tokens at q."""
    cs, _, ps, raw_at, n = _token_at(r, q, ct, pt)
    p = np.where(ps > 1, (1 << n) | r.peek(raw_at, n), ps)
    is_match = cs >= 256
    return is_match, np.where(is_match, cs - 256 + THRESHOLD, cs), p + 1


def read_header(r: _Reader):
    """The header of the block at r.pos: (token count, T table, C table,
    P table), each table (lengths, None) or (None, its one symbol)."""
    count = r.get(16)
    if count == 0:
        raise ValueError("a block of 0 tokens")
    t = _read_pt_lens(r, NT, TBIT, 3)
    tt = memoryview(_table(*t, NT))

    def tdec(rr):
        e = tt[(int(rr.w[rr.pos >> 3]) >> (16 - (rr.pos & 7))) & 0xFFFF]
        sym, k = e >> 5, e & 31
        if rr.pos + k > rr.nbits:
            raise ValueError("the body ends inside a block header")
        rr.pos += k
        return sym, k

    return count, t, _read_c_lens(r, tdec), _read_pt_lens(r, NP, PBIT, -1)


def decode_body(body: bytes, size: int) -> bytes:
    """The plaintext of a raw -lh5- body of `size` bytes. Raises
    ValueError where the body ends early, where whole blocks do not
    decode to exactly `size` bytes, where bytes or set bits follow the
    last token, or where a table or a distance is not valid."""
    r = _Reader(body)
    kinds, vals, dists = [], [], []
    produced = 0
    while produced < size:
        count, _, c, p = read_header(r)
        ct, pt = _table(*c, NC), _table(*p, NP)
        starts, r.pos = _block_tokens(r, count, ct, pt)
        m, v, d = _tokens(r, starts, ct, pt)
        produced += int(np.where(m, v, 1).sum())
        kinds.append(m)
        vals.append(v)
        dists.append(d)
    if produced != size:
        raise ValueError(f"whole blocks decode to {produced} bytes, the "
                         f"container states {size}")
    if r.pos > r.nbits:
        raise ValueError("the body ends inside the last token")
    if len(body) != (r.pos + 7) // 8:
        raise ValueError(f"{len(body) - (r.pos + 7) // 8} bytes after "
                         f"the last token")
    if r.pos & 7 and body[-1] & (0xFF >> (r.pos & 7)):
        raise ValueError("set bits after the last token")
    if not size:
        return b""
    return _expand(np.concatenate(kinds), np.concatenate(vals),
                   np.concatenate(dists), size)


def _expand(is_match, val, dist, size: int) -> bytes:
    """The LZ77 copies: each output byte points at its source (itself
    for a literal), and the pointers jump until each names a literal."""
    tl = np.where(is_match, val, 1)
    start = np.cumsum(tl) - tl
    if np.any(is_match & (dist > start)):
        raise ValueError("a match reaches before the start of the output")
    tok = np.repeat(np.arange(tl.size), tl)
    pos = np.arange(size, dtype=np.int64)
    src = np.where(is_match[tok], pos - dist[tok], pos)
    lit = ~is_match[tok]
    out = np.zeros(size, np.uint8)
    out[start[~is_match]] = val[~is_match]
    todo = np.flatnonzero(~lit)
    while todo.size:
        src[todo] = src[src[todo]]
        todo = todo[~lit[src[todo]]]
    return out[src].tobytes()


def decode(stream: bytes) -> bytes:
    """The plaintext of exactly one container holding an -lh5- body: the
    magic, the method and the size checked, the body read strictly
    (decode_body)."""
    if len(stream) < HEADER or stream[:4] != MAGIC:
        raise ValueError("not a TPZL container")
    if stream[4:7] != METHOD:
        raise ValueError(f"method {stream[4:7]!r}, not {METHOD!r}")
    (size,) = struct.unpack_from("<Q", stream, 7)
    return decode_body(stream[HEADER:], size)


def break_integrity(stream: bytes) -> bytes:
    """The stream with its size field lowered by one."""
    (size,) = struct.unpack_from("<Q", stream, 7)
    if size == 0:
        raise ValueError("an empty object's size cannot be lowered")
    return stream[:7] + struct.pack("<Q", size - 1) + stream[HEADER:]
