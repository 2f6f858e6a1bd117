"""Builds and loads the port's CUDA kernels.

`nvcc` compiles every `tpz_torch/csrc/*.cu` for sm_90a, one process per
source, all started together (the `*.cuh` headers they include are part
of the build key, so a change to one rebuilds), and links the objects
into one shared library with a plain C interface,
`build/kernels/libtpz_torch_kernels.so`,
loaded with ctypes. It builds at first use and again whenever the sources
change. Nothing here runs at import of the package: only a kernel wrapper
handed a CUDA tensor calls `lib()`.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess

from tpz_torch import REPO_ROOT
from tpz_torch.utils.build import cached_build, inputs_key

CSRC = os.path.join(REPO_ROOT, "tpz_torch", "csrc")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "kernels")
LIB_NAME = "libtpz_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Shared memory one CUDA block may opt into on an H100 (sm_90); wrappers
# check their kernels' needs against it before a launch.
SHARED_LIMIT = 232448

_LIB = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build_inputs() -> tuple[list[str], list[str]]:
    """(the CUDA sources nvcc compiles, the headers they include)."""
    return (sorted(glob.glob(os.path.join(CSRC, "*.cu"))),
            sorted(glob.glob(os.path.join(CSRC, "*.cuh"))))


def build(out_dir: str = BUILD_DIR) -> str:
    """Compile the kernels unless the library is current; returns its
    path. What nvcc and ptxas printed (registers, spills) goes to
    build.log beside it."""
    sources, headers = build_inputs()

    def compile_to(out_path):
        objs = [os.path.join(out_dir, os.path.basename(s) + ".o")
                for s in sources]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources, objs)]
        log = []
        for s, p in zip(sources, procs):
            out, _ = p.communicate()
            log.append(f"== {os.path.basename(s)}\n{out}")
            if p.returncode:
                for q in procs:
                    q.wait()
                raise RuntimeError(f"nvcc failed on {s}:\n{out}")
        r = subprocess.run([_nvcc(), "-shared", "-o", out_path, *objs],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc link failed:\n{r.stdout}{r.stderr}")
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write("".join(log))

    return cached_build(out_dir, LIB_NAME,
                        inputs_key(sources + headers, *NVCC_FLAGS), compile_to)


def lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        L = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.tpz_parse_walk_v3.restype = ci
        L.tpz_parse_walk_v3.argtypes = [vp] * 8 + [ci] * 11 + [vp]
        L.tpz_symbol_walk.restype = ci
        L.tpz_symbol_walk.argtypes = [vp] * 12 + [ci] * 6 + [vp]
        L.tpz_resolve_walk.restype = ci
        L.tpz_resolve_walk.argtypes = [vp] * 3 + [ci] * 3 + [vp]
        L.tpz_parse_v1_walk.restype = ci
        L.tpz_parse_v1_walk.argtypes = [vp] * 6 + [ci] * 7 + [vp]
        L.tpz_lzhuf_walk.restype = ci
        L.tpz_lzhuf_walk.argtypes = [vp] * 8 + [ci] * 4 + [vp]
        L.tpz_lzhuf_walk_occupancy.restype = ci
        L.tpz_lzhuf_walk_occupancy.argtypes = [ci] * 3
        L.tpz_bzip2_walk.restype = ci
        L.tpz_bzip2_walk.argtypes = [vp] * 11 + [ci] * 5 + [vp]
        L.tpz_ibwt_walk.restype = ci
        L.tpz_ibwt_walk.argtypes = [vp] * 7 + [ci] * 7 + [vp]
        L.tpz_ibwt_walk_resident.restype = ci
        L.tpz_ibwt_walk_resident.argtypes = [ci]
        L.tpz_reach_walk.restype = ci
        L.tpz_reach_walk.argtypes = [vp] * 3 + [ci] * 3 + [vp]
        L.tpz_parse_v3w_walk.restype = ci
        L.tpz_parse_v3w_walk.argtypes = [vp] * 6 + [ci] * 10 + [vp]
        L.tpz_mtf_encode.restype = ci
        L.tpz_mtf_encode.argtypes = [vp] * 4 + [ci] * 4 + [vp]
        L.tpz_suffix_screen_v3.restype = ci
        L.tpz_suffix_screen_v3.argtypes = [vp] * 6 + [ci] * 8 + [vp]
        ll = ctypes.c_longlong
        L.tpz_deflate_pack.restype = ci
        L.tpz_deflate_pack.argtypes = [vp] * 13 + [ci] * 3 + [ll, vp]
        L.tpz_lzhuf_pack.restype = ci
        L.tpz_lzhuf_pack.argtypes = [vp] * 10 + [ci] * 5 + [ll, vp]
        L.tpz_crc32_lanes.restype = ci
        L.tpz_crc32_lanes.argtypes = [vp, ll, ci, ci, vp, vp, vp, ll, vp, vp,
                                      ci, vp]
        _LIB = L
    return _LIB
