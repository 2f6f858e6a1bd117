"""The gzip reader's member walk (codecs/gzip_codec.py) on the CPU: every
buffer that is neither BGZF's nor TZ-indexed, of one member or of many,
is walked member by member on the host, and all its members, with those
of every other such buffer of the call, decode in one batched segmented
decode. Each case is compared with stdlib gzip.decompress, on seeded
objects of at most a few hundred KiB: WARC files compressed record at a
time (the benchmark's record-at-a-time writer, and its schedule shrunk),
members with FNAME, FEXTRA, FCOMMENT and FHCRC between others, empty
members and members of stored blocks, a call that mixes BGZF,
TZ-indexed and stock buffers, a member the index declines, and damaged
files.

The objects repeat a random phrase, so the plain symbol walk takes few
trips, or are random bytes, which zlib stores."""

import contextlib
import functools
import gzip
import struct
import zlib

import numpy as np
import pytest
import torch

from benchmark.reference import bgzf_ref, warc_ref
from tpz_torch import api
from tpz_torch.codecs import bgzf, deflate, gzip_codec
from tpz_torch.codecs.deflate import DeflateConfig
from tpz_torch.errors import DataError, UnexpectedEof
from tpz_torch.kernels import deflate_pipeline
from tpz_torch.kernels import inflate_pipeline as ip

# The record schedule of benchmark/configs/warc.json, each size divided
# by 32: request, response (in turn), metadata.
SMALL_REQUEST, SMALL_METADATA = 24, 16
SMALL_RESPONSES = (256, 1024, 3072, 8192)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain stages run many tiny torch ops, for which intra-op
    threads only add overhead (and contend with the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def phrase_object(n: int, seed: int) -> bytes:
    phrase = np.random.default_rng(seed).integers(0, 256, 300, np.uint8)
    return np.resize(phrase, n).tobytes()


def random_object(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8).tobytes()


def member(record: bytes, level: int = 6) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, 31)
    return c.compress(record) + c.flush()


def small_schedule(n: int) -> list[int]:
    sizes, done = [], 0
    while done < n:
        capture, kind = divmod(len(sizes), 3)
        size = (SMALL_REQUEST, SMALL_RESPONSES[capture % 4],
                SMALL_METADATA)[kind]
        sizes.append(min(size, n - done))
        done += sizes[-1]
    return sizes


def record_file(obj: bytes, sizes) -> bytes:
    out, off = [], 0
    for size in sizes:
        out.append(member(obj[off:off + size]))
        off += size
    return b"".join(out)


def header(flags: int, extra: bytes = b"", name: bytes = b"",
           comment: bytes = b"") -> bytes:
    """A member header with FEXTRA (4), FNAME (8), FCOMMENT (16) and
    FHCRC (2) as `flags` asks."""
    h = b"\x1f\x8b\x08" + bytes([flags]) + b"\0\0\0\0\0\x03"
    if flags & 4:
        h += struct.pack("<H", len(extra)) + extra
    if flags & 8:
        h += name + b"\0"
    if flags & 16:
        h += comment + b"\0"
    if flags & 2:
        h += struct.pack("<H", zlib.crc32(h) & 0xFFFF)
    return h


def framed_member(record: bytes, flags: int) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    body = c.compress(record) + c.flush()
    return (header(flags, extra=b"XY\x03\0abc", name=b"record.warc",
                   comment=b"a comment") + body
            + struct.pack("<II", zlib.crc32(record), len(record)))


def files() -> dict:
    """name -> a stock multi-member (or single-member) gzip file."""
    warc = phrase_object(40_000, 1)
    small = phrase_object(30_000, 2)
    parts = [phrase_object(900, 3), b"", random_object(5000, 4),
             phrase_object(70_000, 5), b"", phrase_object(7, 6)]
    headed = [phrase_object(600, 7), phrase_object(2000, 8),
              phrase_object(1500, 9), phrase_object(300, 10)]
    return {
        "warc-schedule": warc_ref.encode(warc, 6),
        "warc-schedule-shrunk": record_file(small, small_schedule(
            len(small))),
        "tiny-large-empty-stored": b"".join(member(p) for p in parts),
        "headers-in-the-middle": (
            member(headed[0]) + framed_member(headed[1], 2 | 4 | 8 | 16)
            + framed_member(headed[2], 8 | 2) + member(headed[3])),
        "one-member": gzip.compress(phrase_object(50_000, 11), mtime=0),
        "one-empty-member": gzip.compress(b"", mtime=0),
        "level-1-and-9": (member(phrase_object(4000, 12), 1)
                          + member(phrase_object(4000, 13), 9)),
    }


FILES = files()
NAMES = sorted(FILES)


@pytest.fixture
def calls(monkeypatch):
    """Counts of decompress_many_segmented's calls from outside itself
    and of the spans gzip_codec and inflate_pipeline open; the route a
    member at a time took, deflate.decompress_prefix, raises."""
    seen = {"segmented": 0, "spans": []}
    inner = ip.decompress_many_segmented
    depth = [0]

    def segmented(*a, **k):
        seen["segmented"] += depth[0] == 0
        depth[0] += 1
        try:
            return inner(*a, **k)
        finally:
            depth[0] -= 1

    def span(name):
        seen["spans"].append(name)
        return contextlib.nullcontext()

    def per_member(*a, **k):
        raise AssertionError("a member decoded on its own")

    monkeypatch.setattr(ip, "decompress_many_segmented", segmented)
    monkeypatch.setattr(deflate, "decompress_prefix", per_member)
    monkeypatch.setattr(ip, "span", span)
    monkeypatch.setattr(gzip_codec, "span", span)
    return seen


@pytest.mark.parametrize("name", NAMES)
def test_each_file_reads_as_stdlib_gzip_reads_it(calls, name):
    f = FILES[name]
    before = gzip_codec.members, ip.host_declines
    assert gzip_codec.decompress(f, device="cpu") == gzip.decompress(f)
    n = 0
    d, rest = None, f
    while rest:
        d = zlib.decompressobj(31)
        d.decompress(rest)
        rest, n = d.unused_data, n + 1
    assert gzip_codec.members - before[0] == n
    assert ip.host_declines == before[1]
    assert calls["segmented"] == 1
    assert calls["spans"].count("inflate.index") == 1
    assert calls["spans"].count("inflate.batch") <= 1


def test_a_calls_buffers_decode_in_one_batched_decode(calls):
    """Every stock file of the module in one decompress_many call: one
    walk span, one segmented decode, one device batch."""
    out = api.decompress_many([FILES[n] for n in NAMES], "gzip",
                              device="cpu")
    assert out == [gzip.decompress(FILES[n]) for n in NAMES]
    assert calls["segmented"] == 1
    assert calls["spans"].count("inflate.index") == 1
    assert calls["spans"].count("inflate.batch") == 1


def test_the_warc_schedule_gives_the_records_as_members():
    f = FILES["warc-schedule"]
    before = gzip_codec.members
    assert api.decompress(f, "gzip", device="cpu") == phrase_object(40_000, 1)
    assert gzip_codec.members - before == len(warc_ref.record_sizes(40_000))


@functools.lru_cache(maxsize=None)
def tz_file() -> tuple[bytes, bytes]:
    """(two TZ-indexed members from the port's encoder, their plaintext)."""
    datas = [phrase_object(3000, 21), phrase_object(1200, 22)]
    out = deflate_pipeline.compress_many(datas, DeflateConfig(6), "cpu",
                                         want_index=True)
    return b"".join(
        gzip_codec.header_bytes(6, 0, gzip_codec._tz_extra(bits, lens))
        + body + gzip_codec._trailer(d)
        for d, (body, bits, lens) in zip(datas, out)), b"".join(datas)


def test_bgzf_tz_indexed_and_stock_buffers_in_one_call(calls):
    """Each kind keeps its route: the BGZF file its reader, the file
    whose members all carry TZ the indexed batch, and the stock files,
    and a TZ member beside a stock one, the member walk, whose members
    decode in one segmented call."""
    tz, tz_plain = tz_file()
    bgzf_obj = phrase_object(70_000, 23)
    mixed = tz + FILES["headers-in-the-middle"]
    batch = [FILES["warc-schedule-shrunk"], bgzf_ref.encode(bgzf_obj, 6), tz,
             mixed, FILES["one-member"]]
    before = bgzf.members, gzip_codec.members
    out = api.decompress_many(batch, "gzip", device="cpu")
    assert out == [gzip.decompress(b) for b in batch]
    assert out[1] == bgzf_obj and out[2] == tz_plain
    assert bgzf.members - before[0] == 3
    # The walk's members: the shrunk WARC file's, the mixed buffer's two
    # TZ and four stock members, and the single member.
    assert gzip_codec.members - before[1] == (
        len(small_schedule(30_000)) + 2 + 4 + 1)
    # BGZF's decode and the walk's; the indexed batch is neither.
    assert calls["segmented"] == 2
    assert calls["spans"].count("inflate.index") == 2


def test_a_single_member_reads_as_before():
    """One stock member: its index, one batch and its trailer check, the
    same bytes and stages as a member decoded on its own gave."""
    f = FILES["one-member"]
    seen = []
    assert gzip_codec.decompress_many([f], device="cpu",
                                      stage_hook=seen.append) == [
        phrase_object(50_000, 11)]
    assert seen == ["scan", "h2d", "walk", "materialize", "resolve",
                    "fetch", "crc"]
    pos, _ = gzip_codec.parse_header_extra(f, 0)
    body = f[pos:-8]
    assert ip.decompress_segmented(body, ip.index_stream(body),
                                   "cpu") == phrase_object(50_000, 11)


@pytest.mark.parametrize("buffers", [1, 2])
def test_a_member_whose_index_declines_goes_to_the_host(calls, monkeypatch,
                                                        buffers):
    """With the device span cut to 10,000 bytes, the 70,000-byte member
    is declined by its index: the host inflates it, which also gives its
    end, and the walk goes on past it. Each buffer is walked in a thread
    of its own, and the call counts every buffer's decline."""
    monkeypatch.setattr(ip, "MAX_DECODE_SPAN_WIDE", 10_000)
    f = FILES["tiny-large-empty-stored"]
    before = ip.host_declines
    assert gzip_codec.decompress_many([f] * buffers, device="cpu") == \
        [gzip.decompress(f)] * buffers
    assert ip.host_declines == before + buffers
    assert calls["spans"].count("inflate.host_decline") == buffers
    assert calls["segmented"] == 1


def crc_zeroed(f: bytes, k: int) -> bytes:
    """f with the CRC-32 of its k-th member zeroed."""
    off = 0
    for _ in range(k + 1):
        d = zlib.decompressobj(31)
        d.decompress(f[off:])
        off = len(f) - len(d.unused_data)
    return f[:off - 8] + b"\0" * 4 + f[off - 4:]


DAMAGED = {
    "trailer-cut": (lambda f: f[:-3], UnexpectedEof),
    "cut-inside-a-member": (lambda f: f[:len(f) // 2], UnexpectedEof),
    "trailing-garbage": (lambda f: f + b"garbage after the last member",
                         DataError),
    "crc-of-a-middle-member-zeroed": (lambda f: crc_zeroed(f, 2), DataError),
    "isize-of-the-last-member-wrong": (
        lambda f: f[:-4] + struct.pack("<I", struct.unpack("<I", f[-4:])[0]
                                       + 1), DataError),
    "empty": (lambda f: b"", UnexpectedEof),
}


@pytest.mark.parametrize("how", sorted(DAMAGED))
def test_a_damaged_file_raises_gzips_error(how):
    damage, error = DAMAGED[how]
    f = damage(FILES["warc-schedule-shrunk"])
    with pytest.raises(error):
        api.decompress_many([FILES["one-member"], f], "gzip", device="cpu")
    with pytest.raises(error):
        api.decompress(f, "gzip", device="cpu")
    if f:  # stdlib reads no bytes as no members; the port raises
        with pytest.raises((EOFError, OSError)):
            gzip.decompress(f)


def test_the_index_reads_a_member_in_place():
    """oracle.inflate_index at an offset of a buffer gives the index of
    the body copied out, and reads no further than the buffer's end."""
    from tpz_torch import oracle

    f = FILES["headers-in-the-middle"]
    pos = 0
    for _ in range(2):
        d = zlib.decompressobj(31)
        d.decompress(f[pos:])
        pos = len(f) - len(d.unused_data)
    body_at, _ = gzip_codec.parse_header_extra(f, pos)
    got = oracle.inflate_index(f, offset=body_at)
    want = oracle.inflate_index(f[body_at:])
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert oracle.inflate_index(f, offset=len(f)) is None
