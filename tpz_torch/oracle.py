"""The C++ oracle (`cpp/`), built privately and bound with ctypes.

The port's main path never calls it: it is here for byte-identity checks
(tests and `chip_smoke.py`). `build()` compiles `cpp/*.cc` with g++ into
`build/oracle/libtpz_oracle.so` and never writes into `cpp/`, so the
reference package's own build (`make -C cpp`) stays independent of it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

from tpz_torch._shared import REPO_ROOT, errors
from tpz_torch.utils.build import cached_build, inputs_key

CPP_DIR = os.path.join(REPO_ROOT, "cpp")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "oracle")
LIB_NAME = "libtpz_oracle.so"
_SOURCES = ("huffman.cc", "lzss.cc", "deflate.cc", "checksums.cc",
            "lzhuf.cc", "bzip2.cc", "capi.cc")
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread")

# cpp/gen_constants.py does `from tpz import constants`; run it with a
# stub `tpz` package whose __path__ is the reference package directory, so
# tpz/constants.py loads without tpz/__init__.py (which imports jax).
_GEN_BOOT = r"""
import os, runpy, sys, types
gen, out, pkgdir = sys.argv[1:4]
pkg = types.ModuleType("tpz")
pkg.__path__ = [pkgdir]
sys.modules["tpz"] = pkg
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
                      os.path.join(REPO_ROOT, "tpz", "constants.py")],
                     *_CXXFLAGS)
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
    subprocess.run(
        [sys.executable, "-c", _GEN_BOOT,
         os.path.join(CPP_DIR, "gen_constants.py"),
         os.path.join(src, "generated_constants.h"),
         os.path.join(REPO_ROOT, "tpz")],
        check=True, capture_output=True)
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
