"""Checksums: CRC-32 (the gzip reflected and the bzip2 MSB-first variant)
and Adler-32 (port of tpz/kernels/checksums.py).

CRC-32 is linear over GF(2): the register after A||B from a zero register
is Shift(|B|) . reg(A) ^ reg(B), where Shift(k) is the 32 x 32 matrix that
advances the register by k zero bytes (kept as its 32 columns, the image
of each input bit). The buffer is cut into chunks of `chunk` bytes,
aligned to its end (front zeros leave a zero register as it is); each
chunk's zero-initialised register is computed on its own and the
registers are combined by a tree of shift matrices.

`crc32_lanes` is the wrapper: the plain version `crc32_lanes_plain` for
a CPU tensor, the CUDA kernels of csrc/crc32_lanes.cu for a CUDA tensor
(a thread a chunk with the slice-by-4 tables in shared memory, then fold
passes of 1,024 registers a CUDA block); they replace the reference's
XLA stage `_crc_lanes` and its host combine. `crc32` folds the
0xFFFFFFFF start in by linearity and xors the result. On the CPU,
inputs under 16 KiB take the reference's table loop (`_crc32_host`), as
the reference's do.

Adler-32 is two weighted sums: a = 1 + sum(d), b = n + sum((n - i) d_i),
both mod 65521, as torch reductions in int64.

The GF(2) helpers run on the host in numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpz_torch.constants import (ADLER32_MOD, CRC32_TABLE_MSB,
                                 CRC32_TABLE_REFLECTED)
from tpz_torch.kernels.deflate_pipeline import _device

VARIANTS = ("reflected", "msb")
# Bytes a chunk (a thread of the kernel). A multiple of 16.
CRC_CHUNK = 256
# Registers one fold pass combines into one (a CUDA block), as a power of
# two: csrc/crc32_lanes.cu kFold, kFoldLevels.
FOLD = 1024
FOLD_LEVELS = 10
# Below this many bytes the CPU route takes the table loop.
HOST_BYTES = 1 << 14
_MASK = 0xFFFFFFFF

# ----------------------------------------------------------------- GF(2)


def _table(variant: str) -> np.ndarray:
    return CRC32_TABLE_REFLECTED if variant == "reflected" else CRC32_TABLE_MSB


def _advance_byte_reflected(state) -> int:
    s = int(state)
    return int((s >> 8) ^ CRC32_TABLE_REFLECTED[s & 0xFF])


def _advance_byte_msb(state) -> int:
    s = int(state)
    return int(((s << 8) & _MASK) ^ CRC32_TABLE_MSB[(s >> 24) & 0xFF])


def _matrix_from_advance(advance, nbytes: int) -> np.ndarray:
    """Columns of the matrix advancing the register by nbytes zero bytes:
    col[j] = advance^nbytes(1 << j)."""
    cols = np.empty(32, dtype=np.uint32)
    for j in range(32):
        s = 1 << j
        for _ in range(nbytes):
            s = advance(s)
        cols[j] = s
    return cols


def _mat_mul_vec(cols: np.ndarray, v: int) -> int:
    bits = (int(v) >> np.arange(32)) & 1
    return int(np.bitwise_xor.reduce(np.where(bits == 1, cols, 0)))


def _mat_mul_mat(a_cols: np.ndarray, b_cols: np.ndarray) -> np.ndarray:
    """(A @ B) columns: A applied to each column of B."""
    bits = (b_cols[:, None].astype(np.int64) >> np.arange(32)) & 1
    return np.bitwise_xor.reduce(np.where(bits == 1, a_cols[None, :],
                                          np.uint32(0)),
                                 axis=1).astype(np.uint32)


@functools.lru_cache(maxsize=1024)
def _shift_matrix(variant: str, nbytes: int) -> np.ndarray:
    """The matrix advancing by nbytes zero bytes, by repeated squaring."""
    adv = (_advance_byte_reflected if variant == "reflected"
           else _advance_byte_msb)
    result = (np.uint32(1) << np.arange(32, dtype=np.uint32))  # identity
    sq = _matrix_from_advance(adv, 1)
    n = nbytes
    while n:
        if n & 1:
            result = _mat_mul_mat(sq, result)
        sq = _mat_mul_mat(sq, sq)
        n >>= 1
    return result


@functools.lru_cache(maxsize=None)
def _level_mats(variant: str, chunk: int, levels: int) -> np.ndarray:
    """[levels, 32] uint32: Shift(chunk * 2^l) for l < levels, each the
    square of the one before."""
    out = np.empty((levels, 32), dtype=np.uint32)
    out[0] = _shift_matrix(variant, chunk)
    for lev in range(1, levels):
        out[lev] = _mat_mul_mat(out[lev - 1], out[lev - 1])
    return out


# ------------------------------------------------------------ chunk lanes


def _check(data: torch.Tensor, variant: str, chunk: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown CRC variant {variant!r}")
    if chunk < 16 or chunk % 16:
        raise ValueError(f"crc32 lanes: chunk {chunk} must be a positive "
                         "multiple of 16")
    if data.dtype != torch.uint8 or data.dim() != 1 \
            or not data.is_contiguous():
        raise ValueError("crc32 lanes: data must be a contiguous 1-D uint8 "
                         f"tensor, got {data.dtype} {tuple(data.shape)}")


def _n_levels(L: int) -> int:
    """Levels the fold passes over L registers read (10 a pass)."""
    passes = 0
    while L > 1:
        L = -(-L // FOLD)
        passes += 1
    return max(passes, 1) * FOLD_LEVELS


def _apply(cols: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The matrix (32 int64 columns) applied to each int64 register."""
    out = torch.zeros_like(v)
    for j in range(32):
        out ^= cols[j] * ((v >> j) & 1)
    return out


def _fold_plain(regs: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """The kernel's fold passes, level by level over the whole array:
    zero registers in front to a whole number of FOLD groups, then each
    pair (left, right) -> Shift . left ^ right."""
    x, lev = regs, 0
    while x.numel() > 1:
        pad = (-x.numel()) % FOLD
        x = torch.cat([x.new_zeros(pad), x])
        for k in range(FOLD_LEVELS):
            x = _apply(mats[lev + k], x[0::2]) ^ x[1::2]
        lev += FOLD_LEVELS
    return x[0]


def crc32_lanes_plain(data: torch.Tensor, variant: str = "reflected",
                      chunk: int = CRC_CHUNK):
    """(regs [L] int64, reg 0-d int64): each chunk's zero-initialised,
    un-xored register (chunks of `chunk` bytes aligned to the end of
    data [n] uint8; L = ceil(n / chunk)), and the buffer's, combined by the
    same tree as the kernel. One trip per byte of a chunk, vectorised over
    the chunks."""
    _check(data, variant, chunk)
    n = data.numel()
    if n == 0:
        z = torch.zeros((), dtype=torch.int64, device=data.device)
        return z.new_zeros(0), z
    L = -(-n // chunk)
    rows = torch.cat([data.new_zeros(L * chunk - n), data]).view(L, chunk)
    rows = rows.to(torch.int64)
    tab = torch.from_numpy(_table(variant).astype(np.int64)).to(data.device)
    s = torch.zeros(L, dtype=torch.int64, device=data.device)
    for j in range(chunk):
        b = rows[:, j]
        if variant == "reflected":
            s = (s >> 8) ^ tab[(s ^ b) & 0xFF]
        else:
            s = ((s << 8) & _MASK) ^ tab[((s >> 24) ^ b) & 0xFF]
    mats = torch.from_numpy(_level_mats(variant, chunk, _n_levels(L)).astype(
        np.int64)).to(data.device)
    return s, _fold_plain(s, mats)


def _slice4_tables(variant: str) -> np.ndarray:
    """[4, 256] uint32: T_k[v] = T_0[v] (the byte table) advanced by k
    more zero bytes."""
    t = np.empty((4, 256), dtype=np.uint32)
    t[0] = _table(variant)
    for k in range(1, 4):
        p = t[k - 1]
        if variant == "reflected":
            t[k] = (p >> 8) ^ t[0][p & 0xFF]
        else:
            t[k] = (p << 8) ^ t[0][p >> 24]
    return t


@functools.lru_cache(maxsize=None)
def _device_tables(variant: str, chunk: int, levels: int, device: str):
    """The slice-by-4 tables [4, 256] and the level matrices [levels, 32]
    as int32 bit patterns on `device`, copied there once."""
    return (torch.from_numpy(_slice4_tables(variant).view(np.int32)).to(
                device),
            torch.from_numpy(_level_mats(variant, chunk, levels).view(
                np.int32)).to(device))


def crc32_lanes(data: torch.Tensor, variant: str = "reflected",
                chunk: int = CRC_CHUNK):
    """(regs [L] int64, reg 0-d int64) as crc32_lanes_plain: the plain
    version for a CPU tensor, the kernels of csrc/crc32_lanes.cu for a
    CUDA tensor (one chunk pass, then fold passes until one register is
    left; one launch counted a call)."""
    if data.device.type == "cpu":
        return crc32_lanes_plain(data, variant, chunk)
    if data.device.type != "cuda":
        raise ValueError(f"crc32 lanes: unsupported device {data.device}")
    _check(data, variant, chunk)
    n = data.numel()
    dev = data.device
    if n == 0:
        z = torch.zeros((), dtype=torch.int64, device=dev)
        return z.new_zeros(0), z
    L = -(-n // chunk)
    tab, mats = _device_tables(variant, chunk, _n_levels(L), str(dev))
    regs = torch.empty(L, dtype=torch.int64, device=dev)
    from tpz_torch.kernels import _build

    stream = torch.cuda.current_stream(dev).cuda_stream
    msb = int(variant == "msb")
    with torch.cuda.device(dev):
        rc = _build.lib().tpz_crc32_lanes(
            data.data_ptr(), n, chunk, msb, tab.data_ptr(), regs.data_ptr(),
            None, 0, None, None, 0, stream)
        if rc != 0:
            raise RuntimeError(f"crc32 lanes: crc32_chunks launch failed: "
                               f"cudaError {rc}")
        x, lev = regs, 0
        while x.numel() > 1:
            y = torch.empty(-(-x.numel() // FOLD), dtype=torch.int64,
                            device=dev)
            rc = _build.lib().tpz_crc32_lanes(
                None, 0, chunk, msb, None, None, x.data_ptr(), x.numel(),
                mats[lev].data_ptr(), y.data_ptr(), 1, stream)
            if rc != 0:
                raise RuntimeError(f"crc32 lanes: crc32_fold launch failed: "
                                   f"cudaError {rc}")
            x, lev = y, lev + FOLD_LEVELS
    crc32_lanes.launches += 1
    return regs, x[0]


crc32_lanes.launches = 0
# The CUDA kernels of one call, in launch order (the fold once a pass).
crc32_lanes.kernels = ("crc32_chunks", "crc32_fold")


# --------------------------------------------------------------- CRC-32


def _crc32_host(data: np.ndarray, variant: str) -> int:
    """The byte-table loop (the reference's small-input host path)."""
    tab = _table(variant)
    s = 0
    if variant == "reflected":
        for b in data.tolist():
            s = (s >> 8) ^ int(tab[(s ^ b) & 0xFF])
        return s
    for b in data.tolist():
        s = ((s << 8) & _MASK) ^ int(tab[((s >> 24) ^ b) & 0xFF])
    return s


def _as_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return data.astype(np.uint8, copy=False).reshape(-1)
    return np.frombuffer(memoryview(data), dtype=np.uint8)


def crc32(data, variant: str = "reflected", *, device="cuda") -> int:
    """CRC-32 of a byte buffer.

    "reflected": the gzip/zlib polynomial 0xEDB88320, init and final xor
    0xFFFFFFFF (equals zlib.crc32). "msb": the bzip2 polynomial
    0x04C11DB7 MSB-first, the same init and final xor. On "cuda" every
    size runs crc32_lanes on the card."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown CRC variant {variant!r}")
    device = _device(device)
    a = _as_u8(data)
    n = a.size
    if n == 0:
        raw = 0
    elif device.type == "cpu" and n < HOST_BYTES:
        raw = _crc32_host(a, variant)
    else:
        t = torch.from_numpy(a.copy()).to(device)
        raw = int(crc32_lanes(t, variant)[1])
    # The 0xFFFFFFFF start, by linearity: reg(init, M) = Shift(|M|) . init
    # ^ reg(0, M).
    init_part = _mat_mul_vec(_shift_matrix(variant, n), _MASK)
    return (raw ^ init_part ^ _MASK) & _MASK


def crc32_combine(crc_a: int, crc_b: int, len_b: int,
                  variant: str = "reflected") -> int:
    """The CRC of A||B from the CRCs of the parts (both with the standard
    init and xor, which cancel): Shift(len_b) . crc_a ^ crc_b (zlib's
    crc32_combine)."""
    return (_mat_mul_vec(_shift_matrix(variant, len_b), crc_a)
            ^ crc_b) & _MASK


# -------------------------------------------------------------- Adler-32


def adler32(data, *, device="cuda") -> int:
    """Adler-32 (RFC 1950), equals zlib.adler32. On "cuda" every size runs
    as two torch reductions on the card."""
    device = _device(device)
    a = _as_u8(data)
    n = a.size
    if n == 0:
        return 1
    if device.type == "cpu" and n < HOST_BYTES:
        s1 = s2 = 0
        for byte in a.tolist():
            s1 += byte
            s2 += s1
        return ((s2 + n) % ADLER32_MOD) << 16 | (1 + s1) % ADLER32_MOD
    d = torch.from_numpy(a.copy()).to(device).to(torch.int64)
    w = (n - torch.arange(n, dtype=torch.int64, device=device)) % ADLER32_MOD
    s1 = int(d.sum()) % ADLER32_MOD
    s2 = int((d * w).sum()) % ADLER32_MOD
    return ((n + s2) % ADLER32_MOD) << 16 | (1 + s1) % ADLER32_MOD
