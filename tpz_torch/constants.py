"""Format constants of the port — its copy of tpz/constants.py.

Consumed by the port's kernels and by the C++ oracle that the port builds
(tpz_torch.oracle writes the oracle's generated_constants.h from this
file). tests/test_torch_own_copies.py holds every public name equal to the
reference package's and the generated header byte-equal to the one
cpp/gen_constants.py writes, so the two packages cannot drift.

Sources (public specifications, see SURVEY.md §0 for evidence status):
  - RFC 1951 (DEFLATE) §3.2.5-3.2.7: length/distance alphabets, code-length
    alphabet order, fixed Huffman code lengths.
  - RFC 1950 (zlib): Adler-32 modulus, CMF/FLG header rules.
  - RFC 1952 (gzip): magic bytes, reflected CRC-32 polynomial.
  - BZip2 stream format: non-reflected CRC-32 polynomial, block magics.
  - LHA lh4-lh7 (lzhuf): window sizes, pre-table size, match bounds.

Reference parity: the rust-compression crate implements these same tables in
src/deflate/, src/bzip2/, src/lzhuf/, src/crc32.rs, src/adler32.rs
(layout [MED] per SURVEY.md §2.1; the mount was empty so no file:line cites
are possible — the tables below are pinned by the RFCs instead).
"""

from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# DEFLATE (RFC 1951)
# --------------------------------------------------------------------------

# Length alphabet: codes 257..285. base length and number of extra bits.
# RFC 1951 §3.2.5.
DEFLATE_LENGTH_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51,
     59, 67, 83, 99, 115, 131, 163, 195, 227, 258],
    dtype=np.int32,
)
DEFLATE_LENGTH_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4,
     4, 5, 5, 5, 5, 0],
    dtype=np.int32,
)

# Distance alphabet: codes 0..29. RFC 1951 §3.2.5.
DEFLATE_DIST_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385,
     513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385,
     24577],
    dtype=np.int32,
)
DEFLATE_DIST_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10,
     10, 11, 11, 12, 12, 13, 13],
    dtype=np.int32,
)

# Code-length (CL) alphabet transmission order. RFC 1951 §3.2.7.
DEFLATE_CL_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)

DEFLATE_NUM_LITLEN = 288   # 286 used + 2 reserved (fixed tree defines 288)
DEFLATE_NUM_DIST = 30      # 30 used (32 in fixed tree numbering)
DEFLATE_NUM_CL = 19
DEFLATE_MAX_BITS = 15      # max code length for litlen/dist trees
DEFLATE_MAX_CL_BITS = 7    # max code length for the CL tree
DEFLATE_MIN_MATCH = 3
DEFLATE_MAX_MATCH = 258
DEFLATE_WINDOW = 32768
DEFLATE_END_OF_BLOCK = 256

# Two-level LSB decode-table layout for the device symbol walk (round 4):
# level-1 indexed by the low INFLATE_L1_BITS of the peek; codes longer
# than L1_BITS escape (entry len == 31) into 32-entry level-2 chunks
# indexed by peek bits L1_BITS..L1_BITS+4. Small enough that both
# tables live in SMEM per walk chain. A (legal but pathological) tree
# whose long codes overflow the L2 capacity declines to the host
# decoder (scan reports lit_bits = -1).
INFLATE_L1_BITS = 10
INFLATE_LIT_L2 = 4096
INFLATE_DIST_L2 = 1024
INFLATE_LIT_TW = (1 << INFLATE_L1_BITS) + INFLATE_LIT_L2    # 5120
INFLATE_DIST_TW = (1 << INFLATE_L1_BITS) + INFLATE_DIST_L2  # 2048

# Fixed-Huffman code lengths. RFC 1951 §3.2.6.
_fixed_ll = np.empty(288, dtype=np.int32)
_fixed_ll[0:144] = 8
_fixed_ll[144:256] = 9
_fixed_ll[256:280] = 7
_fixed_ll[280:288] = 8
DEFLATE_FIXED_LITLEN_LENGTHS = _fixed_ll
DEFLATE_FIXED_DIST_LENGTHS = np.full(30, 5, dtype=np.int32)


def deflate_length_sym(length: int) -> int:
    """Map a match length 3..258 to its length symbol 257..285."""
    idx = int(np.searchsorted(DEFLATE_LENGTH_BASE, length, side="right")) - 1
    if length == 258:
        idx = 28
    return 257 + idx


def deflate_dist_sym(dist: int) -> int:
    """Map a match distance 1..32768 to its distance symbol 0..29."""
    return int(np.searchsorted(DEFLATE_DIST_BASE, dist, side="right")) - 1


# Dense length -> symbol / extra-value tables (for vectorized kernels).
# LENGTH_SYM_TABLE[l] for l in 0..258 (entries <3 unused).
_len_sym = np.zeros(259, dtype=np.int32)
for _l in range(3, 259):
    _len_sym[_l] = deflate_length_sym(_l)
DEFLATE_LENGTH_SYM_TABLE = _len_sym

# dist -> symbol via log2 buckets: DIST_SYM_TABLE covers 1..32768 through
# two small tables (direct for <256, high-bits for >=256), zlib-style.
_dist_sym_lo = np.zeros(256, dtype=np.int32)   # for dist-1 in 0..255
for _d in range(1, 257):
    _dist_sym_lo[_d - 1] = deflate_dist_sym(_d)
_dist_sym_hi = np.zeros(256, dtype=np.int32)   # for (dist-1)>>7 in 0..255
for _k in range(256):
    _dist_sym_hi[_k] = deflate_dist_sym((_k << 7) + 1)
DEFLATE_DIST_SYM_LO = _dist_sym_lo
DEFLATE_DIST_SYM_HI = _dist_sym_hi

# --------------------------------------------------------------------------
# zlib (RFC 1950) / gzip (RFC 1952) framing
# --------------------------------------------------------------------------

ZLIB_CM_DEFLATE = 8
ZLIB_CINFO_32K = 7
ADLER32_MOD = 65521
ADLER32_NMAX = 5552  # max bytes before mod is required (fits u32)

GZIP_MAGIC = b"\x1f\x8b"
GZIP_CM_DEFLATE = 8
GZIP_OS_UNIX = 3

# CRC-32 polynomials.
CRC32_POLY_REFLECTED = 0xEDB88320   # gzip/zlib (bit-reflected)
CRC32_POLY_MSB = 0x04C11DB7         # bzip2 (MSB-first, non-reflected)


def make_crc32_table_reflected() -> np.ndarray:
    """Standard reflected CRC-32 byte table (gzip variant)."""
    tbl = np.empty(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (CRC32_POLY_REFLECTED if (c & 1) else 0)
        tbl[i] = c
    return tbl


def make_crc32_table_msb() -> np.ndarray:
    """Non-reflected MSB-first CRC-32 byte table (bzip2 variant)."""
    tbl = np.empty(256, dtype=np.uint32)
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) & 0xFFFFFFFF) ^ (CRC32_POLY_MSB if (c & 0x80000000) else 0)
        tbl[i] = c
    return tbl


CRC32_TABLE_REFLECTED = make_crc32_table_reflected()
CRC32_TABLE_MSB = make_crc32_table_msb()

# --------------------------------------------------------------------------
# BZip2 stream format
# --------------------------------------------------------------------------

BZIP2_STREAM_MAGIC = b"BZh"
BZIP2_BLOCK_MAGIC = 0x314159265359       # 48-bit
BZIP2_EOS_MAGIC = 0x177245385090         # 48-bit
BZIP2_BLOCK_UNIT = 100_000               # level * 100k pre-RLE1 bytes
BZIP2_MAX_ALPHA = 258                    # RUNA/RUNB + 255 MTF + EOB
BZIP2_MAX_CODE_LEN = 20                  # format limit (encoders use <=17)
BZIP2_MIN_TABLES = 2
BZIP2_MAX_TABLES = 6
BZIP2_GROUP_SIZE = 50
BZIP2_N_ITERS = 4                        # table-refinement passes (bzip2 uses 4)
BZIP2_RUNA = 0
BZIP2_RUNB = 1
BZIP2_RLE1_MAX_RUN = 255 + 4             # run encoded as 4 literals + count byte

# --------------------------------------------------------------------------
# LZHUF — LHA static-Huffman methods lh4..lh7 (SURVEY.md §0.1 Q4)
# --------------------------------------------------------------------------

# method name -> (dictionary bits, position-table size np)
# np = dict_bits + 1 (positions 0..dict_bits MSB-count alphabet); lh4 shares
# lh5's np per LHA convention.
LZHUF_METHODS = {
    "lh4": (12, 14),
    "lh5": (13, 14),
    "lh6": (15, 16),
    "lh7": (16, 17),
}
LZHUF_MIN_MATCH = 3
LZHUF_MAX_MATCH = 256
LZHUF_NC = 510          # C-table alphabet: 256 literals + match lengths 3..256
LZHUF_NT = 19           # pre-table (code-length-of-lengths) alphabet size
LZHUF_CBIT = 9          # bits to write C-table size
LZHUF_TBIT = 5          # bits to write pre-table size
LZHUF_MAX_CODE_LEN = 16
