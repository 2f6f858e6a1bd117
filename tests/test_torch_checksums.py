"""The port's checksums (tpz_torch/kernels/checksums.py) held against the
JAX package's (tpz/kernels/checksums.py, its device route on JAX's CPU),
stdlib zlib and the C++ oracle; the CRC lane kernel's plain version
(`crc32_lanes_plain`, what `crc32_lanes` runs for a CPU tensor) against
JAX's `_crc_lanes` on the same [L, M] words. Everything compared is an
integer, so the tolerance is exact equality."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpz import oracle as joracle
from tpz.kernels import checksums as jck
from tpz_torch import oracle
from tpz_torch.kernels import checksums as ck
from tpz_torch.utils import corpus

SIZES = [0, 1, 3, 15, 16, 17, 1023, 1024, 1025, 4097, 16383, 16384,
         70_001, (1 << 17) + 5]


def _data(n):
    return corpus.mixed(n, seed=n % 97) if n else b""


@pytest.mark.parametrize("n", SIZES)
def test_crc32_and_adler32_equal_zlib_the_oracle_and_the_reference(n):
    d = _data(n)
    assert ck.crc32(d, "reflected", device="cpu") == zlib.crc32(d)
    assert ck.crc32(d, "reflected", device="cpu") == \
        oracle.crc32_reflected(d) ^ 0xFFFFFFFF
    msb = ck.crc32(d, "msb", device="cpu")
    assert msb == oracle.crc32_msb(d) ^ 0xFFFFFFFF == \
        joracle.crc32_msb(d) ^ 0xFFFFFFFF
    assert ck.adler32(d, device="cpu") == zlib.adler32(d) == \
        oracle.adler32(d)
    if n >= 1 << 14:
        assert msb == jck.crc32(d, "msb", use_device=True)
        assert ck.crc32(d, device="cpu") == jck.crc32(d, use_device=True)
        assert ck.adler32(d, device="cpu") == jck.adler32(d, use_device=True)


@pytest.mark.parametrize("variant", ck.VARIANTS)
@pytest.mark.parametrize("split", [0, 1, 999, 4096, 20_000])
def test_crc32_combine_equals_the_reference(variant, split):
    d = _data(20_000)
    a, b = d[:split], d[split:]
    ca = ck.crc32(a, variant, device="cpu")
    cb = ck.crc32(b, variant, device="cpu")
    got = ck.crc32_combine(ca, cb, len(b), variant)
    assert got == ck.crc32(d, variant, device="cpu")
    assert got == jck.crc32_combine(ca, cb, len(b), variant)


@pytest.mark.parametrize("variant", ck.VARIANTS)
def test_gf2_helpers_equal_the_reference(variant):
    np.testing.assert_array_equal(ck._shift_matrix(variant, 4),
                                  jck._m32_cols(variant))
    for nbytes in (0, 1, 4, 17, 1024, 65_536, (1 << 24) + 5):
        np.testing.assert_array_equal(ck._shift_matrix(variant, nbytes),
                                      jck._shift_matrix(variant, nbytes))
    mats = ck._level_mats(variant, 1024, 20)
    for lev in (0, 1, 9, 19):
        np.testing.assert_array_equal(
            mats[lev], jck._shift_matrix(variant, 1024 << lev))
    v = 0x9E3779B9
    assert ck._mat_mul_vec(mats[3], v) == jck._mat_mul_vec(mats[3], v)


def _words(data: bytes, lanes: int, variant: str) -> np.ndarray:
    """The reference's [L, M] uint32 words of `data` (its length a multiple
    of 4 * lanes): little-endian for "reflected", big-endian for "msb"."""
    a = np.frombuffer(data, np.uint8)
    w = a.view("<u4") if variant == "reflected" else \
        a.view(">u4").astype(np.uint32)
    return np.ascontiguousarray(w.reshape(lanes, -1))


@pytest.mark.parametrize("variant", ck.VARIANTS)
@pytest.mark.parametrize("lanes,m", [(1, 4), (8, 64), (64, 16), (300, 4)])
def test_plain_lanes_equal_jax_crc_lanes(variant, lanes, m):
    d = _data(lanes * m * 4)
    want = np.asarray(jck._crc_lanes(jnp.asarray(_words(d, lanes, variant)),
                                     variant))
    regs, reg = ck.crc32_lanes_plain(
        torch.frombuffer(bytearray(d), dtype=torch.uint8), variant,
        chunk=4 * m)
    np.testing.assert_array_equal(regs.numpy(), want.astype(np.int64))
    # The tree combine equals the reference's host combine.
    acc, shift = 0, jck._shift_matrix(variant, 4 * m)
    for r in want:
        acc = jck._mat_mul_vec(shift, acc) ^ int(r)
    assert int(reg) == acc


def _register(data: bytes, variant: str) -> int:
    """The oracle's zero-initialised, un-xored register."""
    fn = oracle.crc32_reflected if variant == "reflected" else \
        oracle.crc32_msb
    return fn(data, 0)


@pytest.mark.parametrize("variant", ck.VARIANTS)
@pytest.mark.parametrize("n,chunk", [(1, 16), (3, 1024), (4097, 1024),
                                     (1024 * 1025 + 5, 16),
                                     (50_000, 4096), (1024 * 16, 16),
                                     ((1 << 24) + 5, 16)])
def test_lanes_front_aligned_chunks(variant, n, chunk):
    """Chunks aligned to the end of the buffer (the first one short), and
    one to three fold passes: the registers equal each chunk's own, and
    the combined one the buffer's."""
    d = _data(n) if n < 1 << 20 else np.random.default_rng(n).integers(
        0, 256, n, dtype=np.uint8).tobytes()
    regs, reg = ck.crc32_lanes(
        torch.frombuffer(bytearray(d), dtype=torch.uint8), variant, chunk)
    L = -(-n // chunk)
    assert regs.shape == (L,)
    front = L * chunk - n
    bounds = [max(0, k * chunk - front) for k in range(L + 1)]
    for k in sorted({0, 1, L // 2, L - 1} & set(range(L))):
        assert int(regs[k]) == _register(d[bounds[k]:bounds[k + 1]],
                                         variant)
    assert int(reg) == _register(d, variant)


def test_lanes_check_their_arguments():
    t = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple of 16"):
        ck.crc32_lanes(t, "reflected", chunk=24)
    with pytest.raises(ValueError, match="unknown CRC variant"):
        ck.crc32_lanes(t, "crc64")
    with pytest.raises(ValueError, match="uint8"):
        ck.crc32_lanes(t.to(torch.int32), "reflected")
    assert [int(x) for x in ck.crc32_lanes(t[:0])[0]] == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ck.crc32(b"abc")
        with pytest.raises(RuntimeError, match="cuda"):
            ck.adler32(b"abc")


@pytest.mark.parametrize("variant", ck.VARIANTS)
def test_slice4_tables(variant):
    """The kernel's slice-by-4 tables: T_k[v] is byte v's register (from
    zero) advanced by k zero bytes, so a word's four loads equal four
    byte steps."""
    t = ck._slice4_tables(variant)
    for v in (0, 1, 0x80, 0xA5, 0xFF):
        for k in range(4):
            assert int(t[k][v]) == _register(bytes([v]) + bytes(k), variant)
    rng = np.random.default_rng(7)
    for _ in range(50):
        s = int(rng.integers(0, 1 << 32))
        w = rng.integers(0, 256, 4, dtype=np.uint8)
        ref = s
        for b in w.tolist():
            ref = (ref >> 8) ^ int(t[0][(ref ^ b) & 0xFF]) \
                if variant == "reflected" else \
                ((ref << 8) & 0xFFFFFFFF) ^ int(t[0][((ref >> 24) ^ b) & 0xFF])
        x = s ^ int(w.view("<u4" if variant == "reflected" else ">u4")[0])
        idx = [x & 0xFF, (x >> 8) & 0xFF, (x >> 16) & 0xFF, x >> 24]
        if variant == "msb":
            idx = idx[::-1]
        got = 0
        for k, i in enumerate(idx):
            got ^= int(t[3 - k][i])
        assert got == ref
