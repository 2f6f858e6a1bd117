"""`python -m tpz_torch` as a subprocess on device "cpu": compress and
decompress round trips through files (bytes equal to the api's, and for
lh5 and lzss to the reference CLI's `python -m tpz ... -b oracle`), the
stderr JSON line, and `selftest` over every format. The children run on
one torch thread: the plain encoders' small ops gain nothing from more,
and the other test workers share the CPU."""

import gzip
import json
import os
import subprocess
import sys

import pytest
import torch

from tpz_torch import REPO_ROOT, api
from tpz_torch.utils import corpus

DATA = corpus.mixed(5000, seed=31)
ENV = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1",
           JAX_PLATFORMS="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(*args, module="tpz_torch", check=True):
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, cwd=REPO_ROOT, env=ENV,
                          check=check)


@pytest.mark.parametrize("fmt,suffix", [("gzip", ".gz"), ("lh5", ".lh5"),
                                        ("lzss", ".lzss")])
def test_compress_decompress_round_trip(tmp_path, fmt, suffix):
    src = tmp_path / "doc.txt"
    src.write_bytes(DATA)
    r = _run("compress", str(src), "-f", fmt, "--device", "cpu")
    stats = json.loads(r.stderr.decode().strip().splitlines()[-1])
    comp = (tmp_path / ("doc.txt" + suffix)).read_bytes()
    assert stats == {**stats, "cmd": "compress", "format": fmt,
                     "in_bytes": len(DATA), "out_bytes": len(comp),
                     "output": str(src) + suffix}
    assert sorted(stats) == ["cmd", "format", "in_bytes", "mb_per_s",
                             "out_bytes", "output", "seconds"]
    assert comp == api.compress(DATA, fmt, device="cpu")
    if fmt == "gzip":
        assert gzip.decompress(comp) == DATA
    else:
        ref = tmp_path / "ref"
        _run("compress", str(src), "-f", fmt, "-b", "oracle", "-o",
             str(ref), module="tpz")
        assert comp == ref.read_bytes()
    src.unlink()
    _run("decompress", str(tmp_path / ("doc.txt" + suffix)), "-f", fmt,
         "--device", "cpu")
    assert src.read_bytes() == DATA
    # stdin to stdout.
    r = subprocess.run([sys.executable, "-m", "tpz_torch", "decompress", "-",
                        "-f", fmt, "--device", "cpu"], input=comp,
                       capture_output=True, cwd=REPO_ROOT, env=ENV,
                       check=True)
    assert r.stdout == DATA


def test_selftest_walks_every_format():
    r = _run("selftest", "-n", "4096", "--device", "cpu")
    lines = r.stdout.decode().strip().splitlines()
    assert [ln.split()[0] for ln in lines] == api.formats()
    assert all(ln.split()[1] == "OK" for ln in lines)


def test_cuda_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    r = _run("selftest", "-n", "64", check=False)
    assert r.returncode != 0
    assert b"torch.cuda.is_available() is False" in r.stderr
