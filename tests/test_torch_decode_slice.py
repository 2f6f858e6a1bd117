"""The tpz_torch decode slice end to end on CPU: api.decompress /
decompress_many for gzip (with and without the 'TZ' index), raw DEFLATE
and zlib, on the port's own streams and on stdlib streams. Bytes: the
tolerance is exact equality.

The port's plain encoder costs about as much for a batch as for one
block on this CPU, so the level-6 streams come from one batch encode."""

import functools
import gzip
import os
import struct
import subprocess
import sys
import zlib

import pytest
import torch

from tpz.codecs import zlib_codec as jzlib
from tpz_torch import api, errors
from tpz_torch.utils import corpus
from tpz_torch.codecs import gzip_codec, zlib_codec
from tpz_torch.codecs.deflate import DeflateConfig
from tpz_torch.kernels import deflate_pipeline
from tpz_torch.kernels import inflate_pipeline as ip

DATA = corpus.source_code(6_000, seed=5) + corpus.text(800, seed=6)
BATCH = {
    "data": DATA,
    "src": corpus.source_code(8_000, seed=8),
    "x": b"x",
    "rep30": corpus.repetitive(30_000, seed=9),
    "rep20": corpus.repetitive(12_000, seed=2),
    "random": corpus.random_bytes(70_000, seed=4),  # two stored blocks
    "empty": b"",
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain decode stages run many tiny torch ops, for which intra-op
    threads only add overhead (and contend with the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def members(level):
    """name -> the port's TZ-indexed gzip member: every BATCH buffer at
    level 6, DATA alone at other levels."""
    names = list(BATCH) if level == 6 else ["data"]
    datas = [BATCH[n] for n in names]
    out = deflate_pipeline.compress_many(datas, DeflateConfig(level), "cpu",
                                         want_index=True)
    return {n: gzip_codec.header_bytes(level, 0, gzip_codec._tz_extra(
        bits, lens)) + body + gzip_codec._trailer(d)
        for n, d, (body, bits, lens) in zip(names, datas, out)}


def framed(fmt, level):
    blob = members(level)["data"]
    if fmt == "gzip-tz":
        return blob
    pos, _ = gzip_codec.parse_header_extra(blob, 0)
    body = blob[pos:-8]
    if fmt == "gzip":
        return gzip_codec.header_bytes(level) + body + gzip_codec._trailer(DATA)
    if fmt == "zlib":
        return (zlib_codec.header_bytes(level) + body
                + struct.pack(">I", zlib.adler32(DATA)))
    return body


@pytest.fixture
def no_declines():
    before = ip.host_declines
    yield
    assert ip.host_declines == before


def test_batch_members_are_api_members():
    assert members(6)["x"] == api.compress(b"x", "gzip", 6, device="cpu")
    assert gzip.decompress(members(6)["data"]) == DATA


@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("fmt", ["gzip-tz", "gzip", "deflate", "zlib"])
def test_port_streams_round_trip(fmt, level, no_declines):
    blob = framed(fmt, level)
    out = api.decompress(blob, fmt.split("-")[0], device="cpu")
    assert out == DATA


def test_tz_member_takes_the_indexed_route(monkeypatch):
    seen = []
    real = ip.decompress_many_indexed
    monkeypatch.setattr(ip, "decompress_many_indexed",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    assert api.decompress(members(6)["rep20"], "gzip",
                          device="cpu") == BATCH["rep20"]
    assert seen


def test_zlib_compress_framing():
    d = b"zlib framing " * 40
    for level in (1, 6, 9):
        z = api.compress(d, "zlib", level, device="cpu")
        assert z[:2] == jzlib.header_bytes(level)
        assert zlib.decompress(z) == d
    zs = api.compress_many([d, b""], "zlib", 6, device="cpu")
    assert [zlib.decompress(z) for z in zs] == [d, b""]
    assert api.decompress_many(zs, "zlib", device="cpu") == [d, b""]


@pytest.mark.parametrize("fmt", ["gzip", "deflate", "zlib"])
def test_empty_input(fmt, no_declines):
    blob = api.compress(b"", fmt, device="cpu")
    assert api.decompress(blob, fmt, device="cpu") == b""
    assert api.decompress(members(6)["empty"], "gzip", device="cpu") == b""


def test_empty_gzip_input_raises():
    with pytest.raises(errors.UnexpectedEof):
        api.decompress(b"", "gzip", device="cpu")


def test_stored_blocks(no_declines):
    d = BATCH["random"]
    for blob in (members(6)["random"], gzip.compress(d, 0),
                 gzip.compress(d, 6)):
        assert api.decompress(blob, "gzip", device="cpu") == d


def test_multi_member_gzip(no_declines):
    names = ("src", "x", "rep30")
    want = b"".join(BATCH[n] for n in names)
    tz = [members(6)[n] for n in names]
    assert api.decompress(b"".join(tz), "gzip", device="cpu") == want
    mixed = tz[0] + gzip.compress(BATCH["x"]) + tz[2]
    assert api.decompress(mixed, "gzip", device="cpu") == want
    bad = bytearray(b"".join(tz))
    bad[-6] ^= 1  # the last member's CRC
    with pytest.raises(errors.DataError):
        api.decompress(bytes(bad), "gzip", device="cpu")


@pytest.mark.parametrize("level", [1, 6, 9])
def test_foreign_stdlib_streams(level, no_declines):
    d = corpus.text(1_000, seed=level) + corpus.repetitive(8_000, seed=1)
    assert api.decompress(gzip.compress(d, level), "gzip", device="cpu") == d
    assert api.decompress(zlib.compress(d, level), "zlib", device="cpu") == d
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    raw = c.compress(d) + c.flush()
    assert api.decompress(raw, "deflate", device="cpu") == d


def test_decompress_many_mixed_batch(no_declines):
    names = ["data", "empty", "rep30", "x"]
    datas = [BATCH[n] for n in names]
    blobs = [members(6)[n] for n in names]
    blobs[1] = gzip.compress(b"")
    blobs[2] = gzip.compress(datas[2])
    assert api.decompress_many(blobs, "gzip", device="cpu") == datas


def test_batch_splits_into_groups(monkeypatch, no_declines):
    """Above MAX_DECODE_SPAN a batch splits into groups; a stream above
    it alone takes the single-stream route (shrunken caps)."""
    names = ["random", "rep20", "src"]
    datas = [BATCH[n] for n in names]
    blobs = [members(6)[n] for n in names]
    monkeypatch.setattr(ip, "MAX_DECODE_SPAN", 3 * ip.BLOCK)
    assert api.decompress_many(blobs, "gzip", device="cpu") == datas
    monkeypatch.setattr(ip, "MAX_DECODE_SPAN", ip.BLOCK)
    assert api.decompress_many(blobs, "gzip", device="cpu") == datas
    raws = [zlib.compress(d)[2:-4] for d in datas]
    items = [(r, ip.index_stream(r)) for r in raws]
    assert ip.decompress_many_segmented(items, "cpu") == datas
    monkeypatch.setattr(ip, "MAX_DECODE_SPAN_WIDE", ip.BLOCK)
    with pytest.raises(errors.DataError):
        ip.decompress_many_segmented(items, "cpu")


@pytest.mark.parametrize("fmt", ["gzip-tz", "gzip", "zlib"])
def test_flipped_body_byte_raises(fmt):
    blob = bytearray(framed(fmt, 6))
    blob[len(blob) // 2] ^= 0x5A
    with pytest.raises(errors.DataError):
        api.decompress(bytes(blob), fmt.split("-")[0], device="cpu")


def test_declines_are_counted():
    before = ip.host_declines
    with pytest.raises(errors.DataError):
        api.decompress(b"\x05\x00not deflate", "deflate", device="cpu")
    assert ip.host_declines == before + 1


def test_table_overflow_declines_to_host(monkeypatch):
    """A tree the two-level tables cannot hold (lit_bits < 0) goes to the
    host inflate and is counted."""
    real = ip.oracle.inflate_scan_headers

    def scan(*a):
        out = real(*a)
        out["lit_bits"][0] = -1
        return out

    monkeypatch.setattr(ip.oracle, "inflate_scan_headers", scan)
    before = ip.host_declines
    assert api.decompress(members(6)["data"], "gzip", device="cpu") == DATA
    assert ip.host_declines == before + 1


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fmt in ("gzip", "zlib", "deflate"):
        b = framed(fmt, 6)
        with pytest.raises(RuntimeError, match="cuda"):
            api.decompress(b, fmt, device="cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            api.decompress_many([b], fmt, device="cuda")


def test_unknown_format_raises():
    with pytest.raises(ValueError, match="lz77"):
        api.decompress(b"abc", "lz77", device="cpu")


def test_tz_sidecar_bounds_checked(no_declines):
    """A side-car that fails the bounds checks is ignored: the member takes
    the segmented route and still decodes."""
    blob = members(6)["data"]
    pos, extra = gzip_codec.parse_header_extra(blob, 0)
    ends, lens = gzip_codec.parse_tz_extra(extra)
    for bad_ends, bad_lens in ((ends + 10**6, lens), (ends * 0, lens),
                               (ends, lens + ip.BLOCK)):
        ext = gzip_codec._tz_extra(bad_ends, bad_lens)
        hdr = gzip_codec.header_bytes(6, 0, ext)
        crafted = hdr + blob[pos:]
        assert not gzip_codec._tz_index_ok(
            *gzip_codec.parse_tz_extra(ext), len(crafted) - len(hdr) - 8)
        assert api.decompress(crafted, "gzip", device="cpu") == DATA


def test_port_never_imports_jax():
    code = ("import sys, tpz_torch.api, tpz_torch.kernels.inflate_pipeline, "
            "tpz_torch.kernels.resolve_walk, tpz_torch.codecs.zlib_codec, "
            "tpz_torch.codecs.gzip_codec, tpz_torch.oracle; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'tpz' or m.startswith('tpz.') "
            "for m in sys.modules), 'reference package imported'")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)


def test_decode_stage_hook_sees_every_stage():
    want = ["scan", "h2d", "walk", "materialize", "resolve", "fetch", "crc"]
    for blob in (members(6)["x"], gzip.compress(b"x")):   # both routes
        stages = []
        gzip_codec.decompress_many([blob], device="cpu",
                                   stage_hook=stages.append)
        assert stages == want
    # A TZ member beside a stock one: the buffer takes the member walk,
    # both members one batched decode.
    stages = []
    api_blob = members(6)["x"] + gzip.compress(b"y")
    assert gzip_codec.decompress(api_blob, device="cpu",
                                 stage_hook=stages.append) == b"xy"
    assert stages == want
