"""The port keeps its own copies of the reference package's jax-free
files (tpz_torch/constants.py, errors.py, action.py, utils/corpus.py) and
writes the
C++ oracle's generated_constants.h from its own constants. These tests
hold the copies equal to the reference's, the header byte-equal to the
one the reference generator writes, and show in a fresh interpreter that
importing the port and loading its oracle loads neither jax nor any file
under tpz/. Everything compared is exact."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpz.action as jaction
import tpz.constants as jconstants
import tpz.errors as jerrors
from tpz.utils import corpus as jcorpus
from tpz_torch import REPO_ROOT, api, oracle
from tpz_torch import action, constants, errors
from tpz_torch.kernels import checksums
from tpz_torch.utils import corpus


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_") and not callable(v)
            and not isinstance(v, type(os))}


def test_constants_equal_the_reference():
    mine, ref = _public(constants), _public(jconstants)
    assert sorted(mine) == sorted(ref)
    for name, v in ref.items():
        if isinstance(v, np.ndarray):
            assert mine[name].dtype == v.dtype, name
            np.testing.assert_array_equal(mine[name], v, err_msg=name)
        else:
            assert mine[name] == v, name


def test_errors_equal_the_reference():
    names = sorted(k for k, v in vars(jerrors).items()
                   if isinstance(v, type) and issubclass(v, Exception))
    assert names == sorted(k for k, v in vars(errors).items()
                           if isinstance(v, type) and issubclass(v, Exception))
    for status in range(-1, 8):
        raised = []
        for mod in (errors, jerrors):
            try:
                mod.raise_for_status(status, "probe")
                raised.append(None)
            except Exception as e:  # noqa: BLE001 — comparing the classes
                raised.append((type(e).__name__, str(e)))
        assert raised[0] == raised[1], status


def test_action_equals_the_reference():
    assert [(a.name, a.value) for a in action.Action] == [
        (a.name, a.value) for a in jaction.Action]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kind", ["text", "mixed", "repetitive",
                                  "random_bytes"])
def test_corpus_equals_the_reference(kind, seed):
    n = 20_000 + 333 * seed
    assert getattr(corpus, kind)(n, seed=seed) == getattr(jcorpus, kind)(
        n, seed=seed)


def test_generated_header_equals_the_reference_generators(tmp_path):
    mine = tmp_path / "port.h"
    ref = tmp_path / "ref.h"
    oracle.write_constants_header(str(mine))
    subprocess.run([sys.executable, os.path.join(REPO_ROOT, "cpp",
                                                 "gen_constants.py"),
                    str(ref)], check=True, capture_output=True,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert mine.read_bytes() == ref.read_bytes()


def test_port_loads_nothing_from_the_reference_package():
    """A fresh interpreter imports the port's api (its streaming classes
    too), its bzip2 modules (both directions), its parse walks, raw LZSS,
    the checksums and the CLI, builds and loads its oracle, encodes and
    decodes LZHUF, bzip2 (whole and streamed), raw LZSS and a gzip stream
    on the CPU, takes both checksums, runs the greedy parse and the v3w
    walk, imports the sharded shape and the run reports and runs a
    sharded gzip encode on a CPU mesh: jax stays unloaded and no loaded
    module's file lies under tpz/."""
    oracle.build()  # so the child only loads it
    code = (
        "import bz2, json, os, sys\n"
        "import torch\n"
        "import tpz_torch.api as api\n"
        "import tpz_torch.codecs.bzip2, tpz_torch.kernels.bzip2_pipeline\n"
        "import tpz_torch.kernels.bzip2_walk, tpz_torch.kernels.ibwt_walk\n"
        "import tpz_torch.kernels.bwt, tpz_torch.kernels.mtf\n"
        "import tpz_torch.kernels.rle, tpz_torch.kernels.bzip2_plan_device\n"
        "from tpz_torch.kernels import checksums, parse\n"
        "import tpz_torch.__main__, tpz_torch.codecs.lzss\n"
        "import tpz_torch.parallel.distributed, tpz_torch.utils.metrics\n"
        "from tpz_torch.parallel import mesh\n"
        "from tpz_torch import REPO_ROOT, oracle\n"
        "from tpz_torch.action import Action\n"
        "import gzip, zlib\n"
        "oracle.lib()\n"
        "d = b'tpz stream ' * 2000\n"
        "s = api.CodecStream('bzip2', device='cpu')\n"
        "blob = s.drive(d, Action.FLUSH) + s.drive(d, Action.FINISH)\n"
        "s = api.DecodeStream('bzip2')\n"
        "assert s.write(blob) + s.finish() == d + d\n"
        "s = api.DecodeStream('gzip')\n"
        "assert s.write(gzip.compress(d)) + s.finish() == d\n"
        "blob = api.compress(d, 'lzss', device='cpu')\n"
        "assert api.decompress(blob, 'lzss', device='cpu') == d\n"
        "assert checksums.crc32(d, device='cpu') == zlib.crc32(d)\n"
        "assert checksums.adler32(d, device='cpu') == zlib.adler32(d)\n"
        "blob = api.compress(b'abc' * 100, 'lh5', device='cpu')\n"
        "assert api.decompress(blob, 'lh5', device='cpu') == b'abc' * 100\n"
        "bz = bz2.compress(b'tpz bzip2', 1)\n"
        "assert api.decompress(bz, 'bzip2', device='cpu') == b'tpz bzip2'\n"
        "bz = api.compress(b'tpz bzip2 encode', 'bzip2', 9, device='cpu')\n"
        "assert bz2.decompress(bz) == b'tpz bzip2 encode'\n"
        "ml = torch.tensor([[4, 0, 0, 0, 3, 0, 0, 1]], dtype=torch.int32)\n"
        "tok = parse.greedy_parse(ml, ml, torch.tensor([8]))[0]\n"
        "assert tok.tolist() == [[1, 0, 0, 0, 1, 0, 0, 1]]\n"
        "z = torch.zeros((1, 256), dtype=torch.int32)\n"
        "parse.parse_extend_v3w(z, z, torch.zeros((1, 1024), dtype=torch.int32),\n"
        "                       torch.tensor([256], dtype=torch.int32), 256)\n"
        "m = mesh.make_mesh(2, device='cpu')\n"
        "assert gzip.decompress(mesh.sharded_compress(d, m, level=1)) == d\n"
        "ref = os.path.join(REPO_ROOT, 'tpz') + os.sep\n"
        "bad = sorted(n for n, m in list(sys.modules.items())\n"
        "             if (getattr(m, '__file__', None) or '').startswith(ref))\n"
        "print(json.dumps({'jax': 'jax' in sys.modules,\n"
        "                  'tpz': 'tpz' in sys.modules, 'ref': bad}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, check=True, cwd=REPO_ROOT,
                       env=dict(os.environ, PYTHONPATH=REPO_ROOT))
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {
        "jax": False, "tpz": False, "ref": []}


# The helpers the root tools use, each imported and driven on the CPU in a
# fresh interpreter of its own.
_BENCH_MODULES = {
    "corpus": (
        "from tpz_torch.utils import corpus\n"
        "bufs = corpus.make_corpus([(4096, 1), (4096, 2)])\n"
        "assert bufs == [corpus.mixed(4096, 1), corpus.mixed(4096, 2)]\n"),
    "profiling": (
        "import tempfile, torch\n"
        "from tpz_torch.utils import profiling\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    with profiling.trace(d, device='cpu'):\n"
        "        with profiling.span('tpz_probe'):\n"
        "            torch.ones(8).sum()\n"),
}


@pytest.mark.parametrize("module", sorted(_BENCH_MODULES))
def test_bench_modules_load_nothing_from_the_reference_package(module):
    """`utils.corpus.make_corpus` (two small buffers) and
    `utils.profiling` (a CPU trace of a spanned region), each in a
    fresh interpreter: jax stays unloaded and no loaded module's file
    lies under tpz/."""
    code = _BENCH_MODULES[module] + (
        "import json, os, sys\n"
        "from tpz_torch import REPO_ROOT\n"
        "ref = os.path.join(REPO_ROOT, 'tpz') + os.sep\n"
        "bad = sorted(n for n, m in list(sys.modules.items())\n"
        "             if (getattr(m, '__file__', None) or '').startswith(ref))\n"
        "print(json.dumps({'jax': 'jax' in sys.modules,\n"
        "                  'tpz': 'tpz' in sys.modules, 'ref': bad}))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, check=True, cwd=REPO_ROOT,
                       env=dict(os.environ, PYTHONPATH=REPO_ROOT))
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {
        "jax": False, "tpz": False, "ref": []}


@pytest.mark.parametrize("call", [
    lambda: api.compress(b"abc", "gzip"),
    lambda: api.compress_many([b"abc"], "lh5"),
    lambda: api.decompress(b"\x1f\x8b", "gzip"),
    lambda: api.decompress_many([b"TPZLlh7" + bytes(8)], "lh7"),
    lambda: api.decompress(b"BZh9", "bzip2"),
    lambda: api.decompress_many([b"BZh9"], "bzip2"),
    lambda: api.compress(b"abc", "bzip2"),
    lambda: api.compress_many([b"abc"], "bzip2"),
    lambda: api.compress(b"abc", "lzss"),
    lambda: api.CodecStream("gzip"),
    lambda: checksums.crc32(b"abc"),
    lambda: checksums.adler32(b"abc"),
], ids=["compress", "compress_many", "decompress", "decompress_many",
        "bzip2-decompress", "bzip2-decompress_many", "bzip2-compress",
        "bzip2-compress_many", "lzss-compress", "codec-stream", "crc32",
        "adler32"])
def test_entry_points_default_to_the_card(call):
    """The entry points run on the card unless the caller asks for the
    CPU; with no card they raise instead of running elsewhere."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        call()
