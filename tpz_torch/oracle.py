"""The C++ oracle (`cpp/`), built privately and bound with ctypes.

The DEFLATE encode path calls its encoder only for a buffer above
MAX_DEVICE_SPAN, as the reference does; otherwise that encoder is here
for byte-identity checks (tests and `chip_smoke.py`). The LZHUF encode
path plans its blocks on the device (kernels/lzhuf_plan_device.py); the
host planner (`lzhuf_plan`: code lengths, canonical codes and block
headers), which the reference calls, is the tests' reference for that
plan. The bzip2 encode path calls its
RLE1 and block split (`bzip2_rle1`), as the reference does. The decode
paths call its
host scans, as the reference does: the DEFLATE header scan and segment
indexer, the LZHUF token indexer and the bzip2 header scan, which read
block headers and cut streams without writing output; the bzip2 RLE1
inverse and CRC checks after the device iBWT; and the host decoders for
the shapes the device path declines. `build()` compiles `cpp/*.cc` with
g++ into `build/oracle/libtpz_oracle.so` and never writes into `cpp/`,
so the reference package's own build (`make -C cpp`) stays independent
of it.
The oracle's `generated_constants.h` is written from the port's own
`tpz_torch/constants.py` (`write_constants_header`).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

from tpz_torch import REPO_ROOT, errors
from tpz_torch import constants as C
from tpz_torch.utils.build import cached_build, inputs_key

CPP_DIR = os.path.join(REPO_ROOT, "cpp")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "oracle")
LIB_NAME = "libtpz_oracle.so"
_SOURCES = ("huffman.cc", "lzss.cc", "deflate.cc", "checksums.cc",
            "lzhuf.cc", "bzip2.cc", "capi.cc")
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread")

CONSTANTS = os.path.join(REPO_ROOT, "tpz_torch", "constants.py")

# cpp/gen_constants.py does `from tpz import constants`. It runs in a child
# whose `tpz` is a stub module with one member, `constants`: the port's
# tpz_torch/constants.py, registered as `tpz` and `tpz.constants`. The stub
# has no __path__, so nothing can load from the reference package.
_GEN_BOOT = r"""
import importlib.util, runpy, sys, types
gen, out, consts = sys.argv[1:4]
spec = importlib.util.spec_from_file_location("tpz.constants", consts)
C = importlib.util.module_from_spec(spec)
spec.loader.exec_module(C)
pkg = types.ModuleType("tpz")
pkg.constants = C
sys.modules["tpz"] = pkg
sys.modules["tpz.constants"] = C
sys.argv = [gen, out]
runpy.run_path(gen, run_name="__main__")
"""

_LIB = None


def _inputs() -> list[str]:
    names = sorted(n for n in os.listdir(CPP_DIR)
                   if n.endswith((".cc", ".h")) and n != "generated_constants.h")
    return [os.path.join(CPP_DIR, n) for n in names]


def build(out_dir: str = BUILD_DIR) -> str:
    """Build the oracle library unless it is current; returns its path."""
    key = inputs_key([*_inputs(), os.path.join(CPP_DIR, "gen_constants.py"),
                      CONSTANTS], *_CXXFLAGS)
    return cached_build(out_dir, LIB_NAME, key,
                        lambda tmp: _compile(out_dir, tmp))


def _compile(out_dir: str, out_path: str) -> None:
    # Sources are copied beside the generated header: a quoted include
    # searches the including file's directory first, so a stale
    # cpp/generated_constants.h could otherwise shadow the fresh one.
    src = os.path.join(out_dir, "src")
    shutil.rmtree(src, ignore_errors=True)
    os.makedirs(src)
    for path in _inputs():
        shutil.copy(path, src)
    write_constants_header(os.path.join(src, "generated_constants.h"))
    procs = [subprocess.Popen(
        ["g++", *_CXXFLAGS, "-c", "-o", os.path.join(src, s + ".o"),
         os.path.join(src, s)], stderr=subprocess.PIPE) for s in _SOURCES]
    for s, p in zip(_SOURCES, procs):
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"g++ failed on {s}:\n{err.decode()}")
    subprocess.run(
        ["g++", *_CXXFLAGS, "-shared", "-o", out_path,
         *[os.path.join(src, s + ".o") for s in _SOURCES]],
        check=True, capture_output=True)


def write_constants_header(out_path: str) -> None:
    """Write the oracle's generated_constants.h from the port's
    constants, with the reference's own generator (cpp/gen_constants.py)."""
    subprocess.run([sys.executable, "-c", _GEN_BOOT,
                    os.path.join(CPP_DIR, "gen_constants.py"), out_path,
                    CONSTANTS], check=True, capture_output=True)


def lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        L = ctypes.CDLL(build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        L.tpz_deflate_encode.restype = ctypes.c_int
        L.tpz_deflate_encode.argtypes = [
            u8p, ctypes.c_size_t, i32p, u8p, ctypes.POINTER(ctypes.c_size_t)]
        L.tpz_deflate_encode_many.restype = ctypes.c_int
        L.tpz_deflate_encode_many.argtypes = [
            u8p, i64p, i64p, ctypes.c_int32, i32p, u8p, i64p, i64p,
            ctypes.c_int32]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        szp = ctypes.POINTER(ctypes.c_size_t)
        L.tpz_inflate.restype = ctypes.c_int
        L.tpz_inflate.argtypes = [u8p, ctypes.c_size_t, u8p, szp, szp]
        L.tpz_inflate_scan_headers.restype = ctypes.c_int
        L.tpz_inflate_scan_headers.argtypes = [
            u8p, ctypes.c_size_t, i64p, ctypes.c_int32, i32p, i64p,
            i32p, i32p, i32p, i32p, i32p, i32p, u32p, u32p]
        L.tpz_inflate_scan_segments.restype = ctypes.c_int
        L.tpz_inflate_scan_segments.argtypes = [
            u8p, ctypes.c_size_t, i64p, i64p, i64p, ctypes.c_int32, i32p,
            i64p, i32p, i32p, i32p, i32p, i32p, i32p, u32p, u32p]
        L.tpz_inflate_index.restype = ctypes.c_int
        # Buffers by address: inflate_index runs once a member of a BGZF
        # file, where building a ctypes pointer an argument costs more
        # than the walk of a small stream.
        vp = ctypes.c_void_p
        L.tpz_inflate_index.argtypes = [
            vp, ctypes.c_size_t, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, vp, vp, vp, vp, vp, vp, vp, szp]
        u16p = ctypes.POINTER(ctypes.c_uint16)
        L.tpz_lzhuf_encode.restype = ctypes.c_int
        L.tpz_lzhuf_encode.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int32, ctypes.c_int32, u8p, szp]
        L.tpz_lzhuf_decode.restype = ctypes.c_int
        L.tpz_lzhuf_decode.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int32, ctypes.c_size_t, u8p, szp]
        L.tpz_lzhuf_index.restype = ctypes.c_int
        L.tpz_lzhuf_index.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int32, ctypes.c_size_t,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p, i64p,
            i64p, i32p, i32p, i32p, u8p, u8p, i32p, i32p, i64p, i64p]
        L.tpz_lzhuf_plan.restype = ctypes.c_int
        L.tpz_lzhuf_plan.argtypes = [
            u32p, u32p, u32p, ctypes.c_int32, ctypes.c_int32, i64p, i64p,
            u8p, u16p, u8p, u16p, u8p, ctypes.c_size_t]
        L.tpz_bzip2_encode.restype = ctypes.c_int
        L.tpz_bzip2_encode.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int32, u8p, szp]
        L.tpz_bzip2_decode.restype = ctypes.c_int
        L.tpz_bzip2_decode.argtypes = [u8p, ctypes.c_size_t, u8p, szp]
        L.tpz_bzip2_scan_headers.restype = ctypes.c_int
        L.tpz_bzip2_scan_headers.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int32, i64p, i64p, u32p, u32p,
            i32p, i32p, i32p, u8p, u8p, u8p, i32p]
        L.tpz_bzip2_scan_to_last.restype = ctypes.c_int
        L.tpz_bzip2_scan_to_last.argtypes = [
            u8p, ctypes.c_size_t, u8p, ctypes.c_int64, i64p, i64p, u32p,
            u32p, i32p]
        L.tpz_bzip2_rle1_inverse.restype = ctypes.c_int
        L.tpz_bzip2_rle1_inverse.argtypes = [
            u8p, i64p, i64p, u32p, ctypes.c_int32, u8p, szp]
        L.tpz_bzip2_rle1.restype = ctypes.c_int
        L.tpz_bzip2_rle1.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int32, u8p, szp, i64p, i64p,
            u32p, i32p]
        L.tpz_bwt_ref.restype = ctypes.c_uint32
        L.tpz_bwt_ref.argtypes = [u8p, ctypes.c_size_t, u8p]
        for name in ("crc32_reflected", "crc32_msb", "adler32"):
            fn = getattr(L, f"tpz_{name}")
            fn.restype = ctypes.c_uint32
            fn.argtypes = [u8p, ctypes.c_size_t, ctypes.c_uint32]
        L.tpz_lzss_tokenize.restype = ctypes.c_int
        L.tpz_lzss_tokenize.argtypes = [u8p, ctypes.c_size_t, i32p, i32p, szp]
        L.tpz_lzss_pack.restype = ctypes.c_int
        L.tpz_lzss_pack.argtypes = [
            i32p, ctypes.c_size_t, ctypes.c_int32, u8p, szp]
        L.tpz_lzss_unpack.restype = ctypes.c_int
        L.tpz_lzss_unpack.argtypes = [
            u8p, ctypes.c_size_t, ctypes.c_int64, ctypes.c_int32, u8p, szp]
        L.tpz_deflate_encode_flush.restype = ctypes.c_int
        L.tpz_deflate_encode_flush.argtypes = [
            u8p, ctypes.c_size_t, i32p, u8p, szp]
        vp = ctypes.c_void_p
        L.tpz_inflate_stream_new.restype = vp
        L.tpz_inflate_stream_new.argtypes = []
        L.tpz_inflate_stream_free.restype = None
        L.tpz_inflate_stream_free.argtypes = [vp]
        L.tpz_inflate_stream_feed.restype = ctypes.c_int
        L.tpz_inflate_stream_feed.argtypes = [
            vp, u8p, ctypes.c_size_t, i32p, i64p, i64p]
        L.tpz_inflate_stream_take.restype = ctypes.c_int64
        L.tpz_inflate_stream_take.argtypes = [vp, u8p, ctypes.c_int64]
        L.tpz_lzhuf_stream_new.restype = vp
        L.tpz_lzhuf_stream_new.argtypes = [ctypes.c_int32, ctypes.c_uint64]
        L.tpz_lzhuf_stream_free.restype = None
        L.tpz_lzhuf_stream_free.argtypes = [vp]
        L.tpz_lzhuf_stream_feed.restype = ctypes.c_int
        L.tpz_lzhuf_stream_feed.argtypes = [
            vp, u8p, ctypes.c_size_t, i32p, i64p]
        L.tpz_lzhuf_stream_take.restype = ctypes.c_int64
        L.tpz_lzhuf_stream_take.argtypes = [vp, u8p, ctypes.c_int64]
        _LIB = L
    return _LIB


def params_array(
    window: int = 32768,
    min_match: int = 3,
    max_match: int = 258,
    max_chain: int = 32,
    hash_bits: int = 15,
    block_size: int = 65536,
    lazy: bool = False,
    too_far_rule: bool = True,
    too_far: int = 4096,
    max_lazy: int = 258,
    n_extend: int = 1,
    screen_bytes: int = 8,
    suffix_mode: bool = False,
    restart: int = 0,
) -> np.ndarray:
    """The oracle's 14-int32 LZSS parameter block (layout of cpp/capi.cc
    ParamsFromArray)."""
    return np.array(
        [window, min_match, max_match, max_chain, hash_bits, block_size,
         int(lazy), int(too_far_rule), too_far, max_lazy, n_extend,
         screen_bytes, int(suffix_mode), restart],
        dtype=np.int32,
    )


def _u8(data) -> np.ndarray:
    return np.frombuffer(bytes(data), dtype=np.uint8)


def _ptr(a: np.ndarray, typ):
    if a.size == 0:
        a = np.zeros(1, a.dtype)
    return a.ctypes.data_as(ctypes.POINTER(typ))


def deflate_encode(data, params: np.ndarray | None = None) -> bytes:
    a = _u8(data)
    p = np.ascontiguousarray(
        params if params is not None else params_array(), dtype=np.int32)
    cap = a.size + (a.size >> 3) + 1024
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_deflate_encode(
        _ptr(a, ctypes.c_uint8), a.size, _ptr(p, ctypes.c_int32),
        _ptr(out, ctypes.c_uint8), ctypes.byref(n))
    errors.raise_for_status(st, "deflate_encode")
    return out[: n.value].tobytes()


def deflate_encode_flush(data, params: np.ndarray | None = None) -> bytes:
    """An Action::Flush segment: every block BFINAL=0, then a Z_SYNC_FLUSH
    empty stored block, so segments concatenate into one valid stream."""
    a = _u8(data)
    p = np.ascontiguousarray(
        params if params is not None else params_array(), dtype=np.int32)
    cap = a.size + (a.size >> 3) + 1024
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_deflate_encode_flush(
        _ptr(a, ctypes.c_uint8), a.size, _ptr(p, ctypes.c_int32),
        _ptr(out, ctypes.c_uint8), ctypes.byref(n))
    errors.raise_for_status(st, "deflate_encode_flush")
    return out[: n.value].tobytes()


def deflate_encode_many(datas, params: np.ndarray | None = None,
                        n_threads: int | None = None) -> list[bytes]:
    """Threaded raw-DEFLATE encode of independent buffers."""
    datas = [bytes(d) for d in datas]
    if not datas:
        return []
    n = len(datas)
    p = np.ascontiguousarray(
        params if params is not None else params_array(), dtype=np.int32)
    lens = np.array([len(d) for d in datas], dtype=np.int64)
    offs = np.zeros(n, dtype=np.int64)
    offs[1:] = np.cumsum(lens)[:-1]
    blob = np.frombuffer(b"".join(datas) or b"\0", dtype=np.uint8)
    out_lens = lens + (lens >> 3) + 1024
    out_offs = np.zeros(n, dtype=np.int64)
    out_offs[1:] = np.cumsum(out_lens)[:-1]
    out_blob = np.zeros(int(out_lens.sum()), dtype=np.uint8)
    nt = n_threads or min(n, os.cpu_count() or 1)
    st = lib().tpz_deflate_encode_many(
        _ptr(blob, ctypes.c_uint8), _ptr(offs, ctypes.c_int64),
        _ptr(lens, ctypes.c_int64), n, _ptr(p, ctypes.c_int32),
        _ptr(out_blob, ctypes.c_uint8), _ptr(out_offs, ctypes.c_int64),
        _ptr(out_lens, ctypes.c_int64), nt)
    errors.raise_for_status(st, "deflate_encode_many")
    return [out_blob[out_offs[i]:out_offs[i] + out_lens[i]].tobytes()
            for i in range(n)]


def _scan_out(nb: int) -> dict:
    return {"btype": np.zeros(nb, np.int32), "body_bit": np.zeros(nb, np.int64),
            "c0_pos": np.zeros(nb, np.int32), "c0_len": np.zeros(nb, np.int32),
            "c1_pos": np.zeros(nb, np.int32), "c1_len": np.zeros(nb, np.int32),
            "lit_bits": np.zeros(nb, np.int32),
            "dist_bits": np.zeros(nb, np.int32),
            "lit_tab": np.zeros((nb, C.INFLATE_LIT_TW), np.uint32),
            "dist_tab": np.zeros((nb, C.INFLATE_DIST_TW), np.uint32)}


def _scan_ptrs(out: dict) -> list:
    types = (ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
             ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
             ctypes.c_uint32, ctypes.c_uint32)
    return [_ptr(a, t) for a, t in zip(out.values(), types)]


def inflate_scan_headers(stream, end_bits: np.ndarray) -> dict:
    """Header-only scan of an indexed stream (cpp InflateScanHeaders): per
    block its type, body bit offset, stored-chunk layout and the two-level
    decode tables [nb, INFLATE_LIT_TW] / [nb, INFLATE_DIST_TW] (entries
    sym << 5 | len; len 31 escapes into the 32-entry L2 chunk at
    entry >> 5). lit_bits[b] == -1 marks a tree the tables cannot hold."""
    a = _u8(stream)
    eb = np.ascontiguousarray(end_bits, dtype=np.int64)
    out = _scan_out(eb.shape[0])
    st = lib().tpz_inflate_scan_headers(
        _ptr(a, ctypes.c_uint8), a.size, _ptr(eb, ctypes.c_int64),
        eb.shape[0], *_scan_ptrs(out))
    errors.raise_for_status(st, "inflate_scan_headers")
    return out


def inflate_scan_segments(stream, hdr_bits: np.ndarray, seg_bits: np.ndarray,
                          end_bits: np.ndarray) -> dict:
    """inflate_scan_headers for entries that may share a block header and
    start mid-block (the segments of inflate_index)."""
    a = _u8(stream)
    hb, sb, eb = (np.ascontiguousarray(x, dtype=np.int64)
                  for x in (hdr_bits, seg_bits, end_bits))
    out = _scan_out(eb.shape[0])
    st = lib().tpz_inflate_scan_segments(
        _ptr(a, ctypes.c_uint8), a.size, _ptr(hb, ctypes.c_int64),
        _ptr(sb, ctypes.c_int64), _ptr(eb, ctypes.c_int64), eb.shape[0],
        *_scan_ptrs(out))
    errors.raise_for_status(st, "inflate_scan_segments")
    return out


def inflate_index(stream, seg_out: int = 1 << 16,
                  max_span_bytes: int = (1 << 16) + 6144, offset: int = 0):
    """Token-aligned segment index over any raw DEFLATE stream (cpp
    InflateIndex): one host symbol walk that writes no output. The stream
    starts at byte `offset` of the bytes-like `stream` and may run to its
    end; it is read in place, not copied. Returns per-segment arrays
    (hdr_bits, seg_bits, end_bits, out_lens, carry_len, carry_dist; bits
    from `offset`) and `consumed` bytes, or None when the stream does not
    fit the device path."""
    a = np.frombuffer(stream, np.uint8)
    n = max(0, a.size - offset)
    addr = a.ctypes.data + min(offset, a.size)
    max_segs = max(16, 2 * (n // 1024) + 64 * 1024)
    # Rows hdr_bits, seg_bits, end_bits, out_lens and, in row 4's first
    # entry, the segment count; then carry_len, carry_dist.
    w64 = np.empty((5, max_segs), np.int64)
    w32 = np.empty((2, max_segs), np.int32)
    a64, a32 = w64.ctypes.data, w32.ctypes.data
    r64, r32 = 8 * max_segs, 4 * max_segs
    consumed = ctypes.c_size_t(0)
    st = lib().tpz_inflate_index(
        addr, n, seg_out, max_segs, max_span_bytes, a64, a64 + r64,
        a64 + 2 * r64, a64 + 3 * r64, a32, a32 + r32, a64 + 4 * r64,
        ctypes.byref(consumed))
    if st != 0:
        return None
    k = int(w64[4, 0])
    idx = dict(zip(("hdr_bits", "seg_bits", "end_bits", "out_lens"),
                   w64[:4, :k].copy()))
    idx.update(zip(("carry_len", "carry_dist"), w32[:, :k].copy()))
    idx["consumed"] = int(consumed.value)
    return idx


def inflate(data, max_out: int | None = None) -> tuple[bytes, int]:
    """Host raw-DEFLATE decode. Returns (plaintext, consumed input bytes)."""
    a = _u8(data)
    cap = max_out if max_out is not None else max(1024, 64 * a.size + 1024)
    for _ in range(8):
        out = np.zeros(cap, dtype=np.uint8)
        n = ctypes.c_size_t(cap)
        consumed = ctypes.c_size_t(0)
        st = lib().tpz_inflate(
            _ptr(a, ctypes.c_uint8), a.size, _ptr(out, ctypes.c_uint8),
            ctypes.byref(n), ctypes.byref(consumed))
        if st == errors.STATUS_BUFFER_TOO_SMALL and max_out is None:
            cap = n.value
            continue
        errors.raise_for_status(st, "inflate")
        return out[:n.value].tobytes(), consumed.value
    errors.raise_for_status(errors.STATUS_BUFFER_TOO_SMALL, "inflate: output cap")


# ------------------------------------------------------------- checksums

def crc32_reflected(data, state: int = 0xFFFFFFFF) -> int:
    """The gzip CRC-32 register after `data` from `state` (no final xor)."""
    a = _u8(data)
    return int(lib().tpz_crc32_reflected(_ptr(a, ctypes.c_uint8), a.size,
                                         state))


def crc32_msb(data, state: int = 0xFFFFFFFF) -> int:
    """The bzip2 (MSB-first) CRC-32 register after `data` from `state`."""
    a = _u8(data)
    return int(lib().tpz_crc32_msb(_ptr(a, ctypes.c_uint8), a.size, state))


def adler32(data, state: int = 1) -> int:
    a = _u8(data)
    return int(lib().tpz_adler32(_ptr(a, ctypes.c_uint8), a.size, state))


# ------------------------------------------------------------------ LZSS

def lzss_tokenize(data, params: np.ndarray | None = None) -> np.ndarray:
    """[N, 4] int32 tokens (pos, len, lit, dist); len == 0 is a literal."""
    a = _u8(data)
    p = np.ascontiguousarray(
        params if params is not None else params_array(), dtype=np.int32)
    cap = max(16, a.size + 16)
    toks = np.zeros((cap, 4), dtype=np.int32)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_lzss_tokenize(
        _ptr(a, ctypes.c_uint8), a.size, _ptr(p, ctypes.c_int32),
        _ptr(toks, ctypes.c_int32), ctypes.byref(n))
    errors.raise_for_status(st, "lzss_tokenize")
    return toks[: n.value].copy()


def lzss_pack(tokens: np.ndarray, min_match: int = 3) -> bytes:
    """[N, 4] tokens as the raw LZSS tagged-byte stream
    (codecs/lzss.py)."""
    toks = np.ascontiguousarray(tokens, dtype=np.int32)
    ntok = toks.shape[0] if toks.ndim == 2 else 0
    cap = max(16, 4 * ntok + 16)
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_lzss_pack(
        _ptr(toks, ctypes.c_int32), ntok, min_match,
        _ptr(out, ctypes.c_uint8), ctypes.byref(n))
    errors.raise_for_status(st, "lzss_pack")
    return out[: n.value].tobytes()


def lzss_unpack(data, orig_size: int, min_match: int = 3) -> bytes:
    """Decode the raw LZSS tagged-byte stream to `orig_size` bytes.

    A code of 3 input bytes yields at most 255 + min_match, so `data`
    can yield no more than `most` bytes. A larger `orig_size` must fail
    as the stream runs out (or on a bad reference first); it is decoded
    at `most` + 1, which fails the same way, so an untrusted size never
    sizes the output buffer. (The reference allocates `orig_size` bytes
    first, and a huge one raises numpy's MemoryError; ROADMAP R10.)"""
    a = _u8(data)
    most = a.size * (255 + max(min_match, 0)) // 3
    n_out = min(orig_size, most + 1)
    cap = max(16, n_out)
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_lzss_unpack(
        _ptr(a, ctypes.c_uint8), a.size, n_out, min_match,
        _ptr(out, ctypes.c_uint8), ctypes.byref(n))
    errors.raise_for_status(st, "lzss_unpack")
    return out[: n.value].tobytes()


# ------------------------------------------------------------------ LZHUF

def _lzhuf_np(dict_bits: int) -> int:
    return next(v[1] for v in C.LZHUF_METHODS.values() if v[0] == dict_bits)


def lzhuf_encode(data, dict_bits: int = 13, max_chain: int = 16) -> bytes:
    """Raw LHA lh4-lh7 stream (no size header; LHA archives carry the
    original size externally, as does the container)."""
    a = _u8(data)
    cap = a.size + (a.size >> 2) + 4096
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_lzhuf_encode(_ptr(a, ctypes.c_uint8), a.size, dict_bits,
                                max_chain, _ptr(out, ctypes.c_uint8),
                                ctypes.byref(n))
    errors.raise_for_status(st, "lzhuf_encode")
    return out[: n.value].tobytes()


def lzhuf_decode(data, orig_size: int, dict_bits: int = 13) -> bytes:
    """Host decode of a raw lh4-lh7 stream of `orig_size` output bytes."""
    a = _u8(data)
    cap = orig_size + 16
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_lzhuf_decode(_ptr(a, ctypes.c_uint8), a.size, dict_bits,
                                orig_size, _ptr(out, ctypes.c_uint8),
                                ctypes.byref(n))
    errors.raise_for_status(st, "lzhuf_decode")
    return out[: n.value].tobytes()


def lzhuf_index(data, orig_size: int, dict_bits: int,
                seg_out: int = 1 << 16):
    """Token-aligned segment index over an lzhuf body (cpp LzhufIndex):
    one host token walk that writes no output. Returns per-segment arrays
    (seg_bits, end_bits, out_lens, carry_len, carry_dist, block_ids) and
    per-block code lengths and constant codes (c_lens [nblk, 510], p_lens
    [nblk, 20], c_consts, p_consts; -1 = not constant), or None when the
    stream does not fit the device path."""
    a = _u8(data)
    max_segs = max(8, 2 * (orig_size // seg_out) + 16)
    max_blocks = max(8, orig_size // 4096 + 16)
    i64 = {k: np.zeros(max_segs, np.int64)
           for k in ("seg_bits", "end_bits", "out_lens")}
    i32 = {k: np.zeros(max_segs, np.int32)
           for k in ("carry_len", "carry_dist", "block_ids")}
    clens = np.zeros((max_blocks, 510), np.uint8)
    plens = np.zeros((max_blocks, 20), np.uint8)
    ccon = np.zeros(max_blocks, np.int32)
    pcon = np.zeros(max_blocks, np.int32)
    nseg = np.zeros(1, np.int64)
    nblk = np.zeros(1, np.int64)
    st = lib().tpz_lzhuf_index(
        _ptr(a, ctypes.c_uint8), a.size, dict_bits, orig_size, seg_out,
        max_segs, max_blocks,
        *[_ptr(v, ctypes.c_int64) for v in i64.values()],
        *[_ptr(v, ctypes.c_int32) for v in i32.values()],
        _ptr(clens, ctypes.c_uint8), _ptr(plens, ctypes.c_uint8),
        _ptr(ccon, ctypes.c_int32), _ptr(pcon, ctypes.c_int32),
        _ptr(nseg, ctypes.c_int64), _ptr(nblk, ctypes.c_int64))
    if st != 0:
        return None
    ks, kb = int(nseg[0]), int(nblk[0])
    idx = {name: v[:ks] for name, v in {**i64, **i32}.items()}
    idx.update(c_lens=clens[:kb], p_lens=plens[:kb], c_consts=ccon[:kb],
               p_consts=pcon[:kb])
    return idx


def lzhuf_plan(c_freq: np.ndarray, p_freq: np.ndarray,
               token_counts: np.ndarray, dict_bits: int) -> dict:
    """Host planning for the LZHUF encode pipeline (cpp LzhufPlan): per
    block the c and p code lengths and canonical codes, the header bits
    at absolute offsets, each block's body bit offset and the total.

    c_freq [NB, 510] uint32, p_freq [NB, np] uint32 (padded rows fine),
    token_counts [NB] uint32. p tables come back strided [NB, 20]."""
    cf = np.ascontiguousarray(c_freq, dtype=np.uint32)
    nb = cf.shape[0]
    npad = np.zeros((nb, 20), dtype=np.uint32)
    npad[:, : p_freq.shape[1]] = p_freq
    # LzhufPlan reads p_freq rows with stride np: rebuild tight rows.
    pf = np.ascontiguousarray(npad[:, :_lzhuf_np(dict_bits)])
    tc = np.ascontiguousarray(token_counts, dtype=np.uint32)
    body_off = np.zeros(nb, dtype=np.int64)
    total_bits = np.zeros(1, dtype=np.int64)
    c_len = np.zeros((nb, 510), dtype=np.uint8)
    c_code = np.zeros((nb, 510), dtype=np.uint16)
    p_len = np.zeros((nb, 20), dtype=np.uint8)
    p_code = np.zeros((nb, 20), dtype=np.uint16)
    cap = int(tc.sum()) * 8 + 512 * nb + 1024
    header = np.zeros(cap, dtype=np.uint8)
    st = lib().tpz_lzhuf_plan(
        _ptr(cf, ctypes.c_uint32), _ptr(pf, ctypes.c_uint32),
        _ptr(tc, ctypes.c_uint32), nb, dict_bits,
        _ptr(body_off, ctypes.c_int64), _ptr(total_bits, ctypes.c_int64),
        _ptr(c_len, ctypes.c_uint8), _ptr(c_code, ctypes.c_uint16),
        _ptr(p_len, ctypes.c_uint8), _ptr(p_code, ctypes.c_uint16),
        _ptr(header, ctypes.c_uint8), cap)
    errors.raise_for_status(st, "lzhuf_plan")
    return {"body_off": body_off, "total_bits": int(total_bits[0]),
            "c_len": c_len, "c_code": c_code, "p_len": p_len,
            "p_code": p_code, "header": header}


# ------------------------------------------------------------------ bzip2

BZ_SEL_CAP = 18432


def bzip2_encode(data, level: int = 9) -> bytes:
    a = _u8(data)
    cap = a.size + (a.size >> 2) + 4096
    out = np.zeros(cap, dtype=np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_bzip2_encode(_ptr(a, ctypes.c_uint8), a.size, level,
                                _ptr(out, ctypes.c_uint8), ctypes.byref(n))
    errors.raise_for_status(st, "bzip2_encode")
    return out[: n.value].tobytes()


def bzip2_rle1(data, level: int = 9):
    """Host RLE1 and block split for the device encode (cpp
    Bzip2Rle1Blocks). Returns (rle_bytes, block_off, block_len,
    block_crc): int64 offsets and lengths into rle_bytes, uint32 CRCs of
    each block's input bytes."""
    a = _u8(data)
    cap = 2 * a.size + 4096
    rle = np.zeros(cap, dtype=np.uint8)
    rle_len = ctypes.c_size_t(cap)
    cap_blocks = max(4, 2 + a.size // 100000)
    off = np.zeros(cap_blocks, dtype=np.int64)
    ln = np.zeros(cap_blocks, dtype=np.int64)
    crc = np.zeros(cap_blocks, dtype=np.uint32)
    nb = ctypes.c_int32(cap_blocks)
    st = lib().tpz_bzip2_rle1(
        _ptr(a, ctypes.c_uint8), a.size, level, _ptr(rle, ctypes.c_uint8),
        ctypes.byref(rle_len), _ptr(off, ctypes.c_int64),
        _ptr(ln, ctypes.c_int64), _ptr(crc, ctypes.c_uint32),
        ctypes.byref(nb))
    errors.raise_for_status(st, "bzip2_rle1")
    k = nb.value
    return rle[:rle_len.value], off[:k], ln[:k], crc[:k]


def bwt_ref(data) -> tuple[np.ndarray, int]:
    """The oracle's reference rotation-sort BWT: (last column, origin
    pointer)."""
    a = _u8(data)
    out = np.zeros(max(1, a.size), dtype=np.uint8)
    orig = lib().tpz_bwt_ref(_ptr(a, ctypes.c_uint8), a.size,
                             _ptr(out, ctypes.c_uint8))
    return out[:a.size], int(orig)


def bzip2_decode(data) -> bytes:
    """Host decode of a (possibly concatenated) .bz2 stream."""
    a = _u8(data)
    cap = max(4096, 80 * a.size)
    for _ in range(8):
        out = np.zeros(cap, dtype=np.uint8)
        n = ctypes.c_size_t(cap)
        st = lib().tpz_bzip2_decode(_ptr(a, ctypes.c_uint8), a.size,
                                    _ptr(out, ctypes.c_uint8), ctypes.byref(n))
        if st == errors.STATUS_BUFFER_TOO_SMALL:
            cap = n.value
            continue
        errors.raise_for_status(st, "bzip2_decode")
        return out[: n.value].tobytes()
    errors.raise_for_status(errors.STATUS_BUFFER_TOO_SMALL,
                            "bzip2_decode: output cap")


def bzip2_scan_headers(data):
    """Header-only scan for the device decode (cpp Bzip2ScanHeaders): per
    block the symbol stream's bit offset, the slice end (the next block
    magic), orig pointer and CRC, alphabet size, table and selector counts,
    initial MTF list, selectors [nb, BZ_SEL_CAP] and the 6 x 258 code
    lengths. None on shapes the device path does not take."""
    a = _u8(data)
    cap = max(4, a.size // 100 + 8)
    out = {"sym_bits": np.zeros(cap, np.int64),
           "end_bits": np.zeros(cap, np.int64),
           "origs": np.zeros(cap, np.uint32), "crcs": np.zeros(cap, np.uint32),
           "n_useds": np.zeros(cap, np.int32), "nts": np.zeros(cap, np.int32),
           "nsels": np.zeros(cap, np.int32),
           "mtf_init": np.zeros((cap, 256), np.uint8),
           "selectors": np.zeros((cap, BZ_SEL_CAP), np.uint8),
           "lens": np.zeros((cap, 6, 258), np.uint8)}
    types = (ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
             ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint8,
             ctypes.c_uint8, ctypes.c_uint8)
    nb = np.zeros(1, np.int32)
    st = lib().tpz_bzip2_scan_headers(
        _ptr(a, ctypes.c_uint8), a.size, cap,
        *[_ptr(v, t) for v, t in zip(out.values(), types)],
        _ptr(nb, ctypes.c_int32))
    if st == errors.STATUS_UNEXPECTED:
        return None
    errors.raise_for_status(st, "bzip2_scan_headers")
    k = int(nb[0])
    return {name: v[:k] for name, v in out.items()}


def bzip2_scan_to_last(data):
    """Host symbol decode of every block to its BWT last column (cpp
    Bzip2ScanToLast). Returns (blob, offs, lens, origs, crcs), or None
    when the stream's shape is not supported."""
    a = _u8(data)
    cap_blocks = max(4, a.size // 100 + 8)
    blob_cap = 16 * a.size + (1 << 16)  # worst-case bzip2 expansion
    blob = np.zeros(blob_cap, np.uint8)
    offs = np.zeros(cap_blocks, np.int64)
    lens = np.zeros(cap_blocks, np.int64)
    origs = np.zeros(cap_blocks, np.uint32)
    crcs = np.zeros(cap_blocks, np.uint32)
    nb = ctypes.c_int32(cap_blocks)
    st = lib().tpz_bzip2_scan_to_last(
        _ptr(a, ctypes.c_uint8), a.size, _ptr(blob, ctypes.c_uint8), blob_cap,
        _ptr(offs, ctypes.c_int64), _ptr(lens, ctypes.c_int64),
        _ptr(origs, ctypes.c_uint32), _ptr(crcs, ctypes.c_uint32),
        ctypes.byref(nb))
    if st == errors.STATUS_UNEXPECTED:
        return None
    errors.raise_for_status(st, "bzip2_scan_to_last")
    n = nb.value
    return blob, offs[:n], lens[:n], origs[:n], crcs[:n]


def bzip2_rle1_inverse(bwt_blob: np.ndarray, offs, lens, crcs) -> bytes:
    """RLE1 inverse of each block's iBWT output (bwt_blob[offs:offs+lens])
    with each block's CRC checked (cpp Bzip2Rle1Inverse); DataError on a
    mismatch."""
    a = np.ascontiguousarray(bwt_blob, np.uint8)
    o = np.ascontiguousarray(offs, np.int64)
    ln = np.ascontiguousarray(lens, np.int64)
    c = np.ascontiguousarray(crcs, np.uint32)
    cap = int(255 * np.sum(ln) // 4 + 4096)
    out = np.zeros(cap, np.uint8)
    n = ctypes.c_size_t(cap)
    st = lib().tpz_bzip2_rle1_inverse(
        _ptr(a, ctypes.c_uint8), _ptr(o, ctypes.c_int64),
        _ptr(ln, ctypes.c_int64), _ptr(c, ctypes.c_uint32), len(o),
        _ptr(out, ctypes.c_uint8), ctypes.byref(n))
    errors.raise_for_status(st, "bzip2_rle1_inverse")
    return out[: n.value].tobytes()


# ------------------------------------------------------- resumable decoders

class _Stream:
    """A resumable C++ decoder: feed compressed increments, take the
    plaintext that became decodable. O(total) across any write pattern."""

    _prefix = ""

    def feed(self, data) -> bytes:
        if self._h is None:
            raise RuntimeError(f"{self._prefix} stream closed")
        a = _u8(data)
        fin = ctypes.c_int32(0)
        pending = ctypes.c_int64(0)
        st = self._feed(a, fin, pending)
        errors.raise_for_status(st, f"{self._prefix}_stream")
        self.finished = bool(fin.value)
        k = int(pending.value)
        if k == 0:
            return b""
        out = np.empty(k, dtype=np.uint8)
        got = getattr(lib(), f"tpz_{self._prefix}_stream_take")(
            self._h, _ptr(out, ctypes.c_uint8), k)
        return out[:got].tobytes()

    def close(self) -> None:
        if self._h is not None:
            getattr(lib(), f"tpz_{self._prefix}_stream_free")(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class InflateStream(_Stream):
    """Resumable raw-DEFLATE decoder (cpp InflateStream). Once `finished`,
    `consumed` is the input bytes the stream spanned."""

    _prefix = "inflate"

    def __init__(self) -> None:
        self._h = lib().tpz_inflate_stream_new()
        self.finished = False
        self.consumed = 0

    def _feed(self, a, fin, pending):
        consumed = ctypes.c_int64(0)
        st = lib().tpz_inflate_stream_feed(
            self._h, _ptr(a, ctypes.c_uint8), a.size, ctypes.byref(fin),
            ctypes.byref(consumed), ctypes.byref(pending))
        self.consumed = int(consumed.value)
        return st


class LzhufStream(_Stream):
    """Resumable lh4-lh7 decoder (cpp LzhufStream) of `orig_size` bytes."""

    _prefix = "lzhuf"

    def __init__(self, dict_bits: int, orig_size: int) -> None:
        self._h = lib().tpz_lzhuf_stream_new(dict_bits, orig_size)
        self.finished = orig_size == 0

    def _feed(self, a, fin, pending):
        return lib().tpz_lzhuf_stream_feed(
            self._h, _ptr(a, ctypes.c_uint8), a.size, ctypes.byref(fin),
            ctypes.byref(pending))
