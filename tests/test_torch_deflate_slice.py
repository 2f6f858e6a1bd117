"""The tpz_torch gzip/DEFLATE encode slice end to end on CPU, held against
the C++ oracle (built privately by tpz_torch.oracle into build/oracle) and
the JAX package's codec layer. Byte outputs: the tolerance is exact
equality."""

import gzip
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from tpz.codecs import deflate as jdeflate
from tpz.codecs import gzip_codec as jgzip
from tpz.utils import corpus
from tpz_torch import api, oracle
from tpz_torch.codecs import gzip_codec
from tpz_torch.codecs.deflate import DeflateConfig
from tpz_torch.kernels import deflate_pipeline

BATCH = [
    b"",
    b"x",
    corpus.random_bytes(70_000, seed=8),        # stored blocks
    corpus.mixed(200_000, seed=9),              # multi-block
    corpus.source_code(30_000, seed=18),        # candidate-2 extensions
    b"abcabcabcabc" * 20,                       # tiny: fixed Huffman
]


def _oracle(data, level):
    return oracle.deflate_encode(data, DeflateConfig(level).params_array())


@pytest.mark.parametrize("level", [1, 6, 9])
def test_deflate_compress_many_matches_oracle(level):
    out = api.compress_many(BATCH, "deflate", level, device="cpu")
    for i, (d, blob) in enumerate(zip(BATCH, out)):
        assert blob == _oracle(d, level), f"buffer {i}"
        assert zlib.decompress(blob, -15) == d


def test_empty_stream_is_oracle_empty_stream():
    assert deflate_pipeline.EMPTY_STREAM == oracle.deflate_encode(b"")
    assert api.compress(b"", "deflate", device="cpu") == oracle.deflate_encode(
        b"")


def test_single_buffer_compress_matches_oracle():
    d = corpus.text(1000, seed=3)
    assert api.compress(d, "deflate", 6, device="cpu") == _oracle(d, 6)


def test_gzip_compress_many_matches_oracle_framing():
    datas = [corpus.text(50_000, seed=4), b"", b"z"]
    out = api.compress_many(datas, "gzip", 6, device="cpu")
    for d, blob in zip(datas, out):
        ref = (jgzip.header_bytes(6) + _oracle(d, 6)
               + zlib.crc32(d).to_bytes(4, "little")
               + len(d).to_bytes(4, "little"))
        assert blob == ref
        assert gzip.decompress(blob) == d


def test_gzip_compress_tz_sidecar():
    d = corpus.mixed(150_000, seed=12)
    blob = api.compress(d, "gzip", 6, device="cpu")
    assert gzip.decompress(blob) == d
    pos, extra = jgzip.parse_header_extra(blob, 0)
    ends, lens = jgzip.parse_tz_extra(extra)
    body = blob[pos:-8]
    assert body == _oracle(d, 6)
    assert len(ends) == 3
    assert (np.diff(ends) > 0).all() and ends[0] > 0
    assert (int(ends[-1]) + 7) // 8 == len(body)
    np.testing.assert_array_equal(lens, [65536, 65536, 150_000 - 131072])
    assert gzip_codec._tz_extra(ends, lens) == extra


@pytest.mark.parametrize("level", range(1, 10))
def test_deflate_config_matches_reference(level):
    ref = jdeflate.DeflateConfig(level=level)
    got = DeflateConfig(level=level)
    for prop in ("level", "window", "block_size", "max_chain", "lazy",
                 "screen_bytes", "max_lazy", "suffix_mode", "restart"):
        assert getattr(got, prop) == getattr(ref, prop), prop
    np.testing.assert_array_equal(got.params_array(), ref.params_array())
    assert got.n_extend == ref.params_array()[10]


def test_gzip_header_matches_reference():
    for level in (1, 6, 9):
        assert gzip_codec.header_bytes(level, 7) == jgzip.header_bytes(level, 7)
    ext = gzip_codec._tz_extra([100, 200], [65536, 5])
    assert gzip_codec.header_bytes(6, 0, ext) == jgzip.header_bytes(6, 0, ext)


def test_port_never_imports_jax():
    code = ("import sys, tpz_torch, tpz_torch.api, tpz_torch.kernels.parse, "
            "tpz_torch.kernels._build, tpz_torch.oracle, "
            "tpz_torch.kernels.deflate_pipeline, "
            "tpz_torch.kernels.bzip2_pipeline, tpz_torch.codecs.bzip2; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'tpz' or m.startswith('tpz.') "
            "for m in sys.modules), 'reference package imported'")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        api.compress_many([b"abc" * 100], "gzip", device="cuda")


def test_unknown_format_raises():
    """A format the port does not know raises and names it, with the
    reference's message."""
    with pytest.raises(ValueError, match="unknown format 'lz77'"):
        api.compress(b"abc", "lz77", device="cpu")


def test_oversized_single_buffer_raises(monkeypatch):
    """A single buffer above MAX_DEVICE_SPAN used to raise; now, as in the
    reference, the oracle encodes it, each such buffer counts one host
    decline, and the rest of the batch stays on the device path."""
    monkeypatch.setattr(deflate_pipeline, "MAX_DEVICE_SPAN", 100_000)
    datas = [b"a" * 10, corpus.text(100_001, seed=5), b""]
    before = deflate_pipeline.host_declines
    out = api.compress_many(datas, "deflate", 6, device="cpu")
    assert out == [_oracle(d, 6) for d in datas]
    assert deflate_pipeline.host_declines == before + 1
    blob, ends, lens = deflate_pipeline.compress_indexed(
        datas[1], DeflateConfig(6), "cpu")
    assert (blob, ends, lens) == (_oracle(datas[1], 6), None, None)
    assert deflate_pipeline.host_declines == before + 2


def test_gzip_above_32_mib_encodes_as_the_reference():
    """33 MiB in one buffer, beside a small one and alone: the member's
    body is the oracle's stream, a member without a block index carries
    no TZ extra (as tpz/codecs/gzip_codec.py writes it), and stdlib gzip
    round-trips every buffer."""
    big = b"tpz-torch" * ((33 << 20) // 9 + 1)
    small = corpus.text(20_000, seed=6)
    assert len(big) > deflate_pipeline.MAX_DEVICE_SPAN
    before = deflate_pipeline.host_declines
    out = api.compress_many([big, small], "gzip", device="cpu")
    assert deflate_pipeline.host_declines == before + 1
    ref_body = _oracle(big, 6)
    hdr = gzip_codec.header_bytes(6)
    assert out[0] == hdr + ref_body + gzip_codec._trailer(big)
    assert gzip.decompress(out[0]) == big
    assert gzip.decompress(out[1]) == small
    single = api.compress(big, "gzip", device="cpu")
    assert deflate_pipeline.host_declines == before + 2
    pos, extra = jgzip.parse_header_extra(single, 0)
    assert extra == b"" and single[:pos] == jgzip.header_bytes(6)
    assert single[pos:-8] == ref_body
    assert gzip.decompress(single) == big


def test_oversized_batch_splits_into_groups(monkeypatch):
    monkeypatch.setattr(deflate_pipeline, "MAX_DEVICE_SPAN", 100_000)
    datas = [corpus.text(60_000, seed=1), corpus.text(50_000, seed=2),
             b"", corpus.text(30_000, seed=3)]
    out = api.compress_many(datas, "deflate", 6, device="cpu")
    for d, blob in zip(datas, out):
        assert blob == _oracle(d, 6)
