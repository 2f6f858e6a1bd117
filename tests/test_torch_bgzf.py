"""The port's BGZF (codecs/bgzf.py) against the benchmark's plain BGZF
reference (benchmark/reference/bgzf_ref.py) and stdlib gzip, on the CPU
with seeded objects of at most 256 KiB: the reference and gzip read
every file the port writes, the port reads every file the reference
writes, a call's members decode in one device batch (also through
"gzip"), damaged files raise gzip's errors, files that are not all BGZF
are declined to the gzip reader, and the streaming shapes take "bgzf".

The plain encoder costs seconds a batch on this CPU, so the port's files
are written by one call in a module fixture; the objects repeat a random
phrase, so the plain symbol walk takes few trips, and one is random
bytes, which the encoder stores."""

import ast
import contextlib
import gzip
import inspect
import struct

import numpy as np
import pytest
import torch

from benchmark.reference import bgzf_ref
from tpz_torch import api
from tpz_torch.codecs import bgzf
from tpz_torch.errors import DataError, UnexpectedEof
from tpz_torch.kernels import inflate_pipeline

B = 65280
SIZES = (0, 1, B - 1, B, B + 1, 3 * B + 17)
SPEC_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def phrase_object(n: int, seed: int) -> bytes:
    phrase = np.random.default_rng(seed).integers(0, 256, 300, np.uint8)
    return np.resize(phrase, n).tobytes()


OBJECTS = {f"len-{n}": phrase_object(n, n) for n in SIZES}
OBJECTS["random"] = np.random.default_rng(9).integers(
    0, 256, 2 * B + 5, np.uint8).tobytes()
NAMES = sorted(OBJECTS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain stages run many tiny torch ops, for which intra-op
    threads only add overhead (and contend with the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_files():
    files = api.compress_many([OBJECTS[k] for k in NAMES], "bgzf", 6,
                              device="cpu")
    return dict(zip(NAMES, files))


@pytest.fixture(scope="module")
def port_reads():
    """The port's decode of the reference's files, one call, with the
    change of the module's counters."""
    before = (bgzf.members, bgzf.declines)
    out = api.decompress_many([bgzf_ref.encode(OBJECTS[k], 6)
                               for k in NAMES], "bgzf", device="cpu")
    return dict(zip(NAMES, out)), (bgzf.members - before[0],
                                   bgzf.declines - before[1])


def members(f: bytes) -> list[tuple[int, bytes]]:
    """(offset, member bytes) of each member, by BSIZE."""
    out, off = [], 0
    while off < len(f):
        size = struct.unpack_from("<H", f, off + 16)[0] + 1
        out.append((off, f[off:off + size]))
        off += size
    return out


@pytest.fixture
def spans(monkeypatch):
    """The names of the spans that inflate_pipeline and bgzf open, in
    order (their `span` recorded in place of a profiler, whose cost on
    the plain walk's many small ops would be most of a test's time)."""
    seen = []

    def span(name):
        seen.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(inflate_pipeline, "span", span)
    monkeypatch.setattr(bgzf, "span", span)
    return seen


def test_the_eof_marker_is_the_specs():
    assert bgzf.EOF_MARKER == SPEC_EOF == bgzf_ref.EOF
    assert gzip.decompress(SPEC_EOF) == b""


@pytest.mark.parametrize("name", NAMES)
def test_the_reference_and_gzip_read_the_ports_files(port_files, name):
    f, obj = port_files[name], OBJECTS[name]
    assert bgzf_ref.decode(f) == obj
    assert gzip.decompress(f) == obj
    ms = members(f)
    assert len(ms) == -(-len(obj) // B) + 1
    assert ms[-1][1] == SPEC_EOF
    for _, m in ms:
        assert len(m) <= bgzf.MAX_MEMBER
        # MTIME 0, XFL of level 6, OS 255, XLEN 6: htslib's header.
        assert m[:16] == b"\x1f\x8b\x08\x04\0\0\0\0\0\xff\x06\0BC\x02\0"
    if name == "random":
        # Stored: a whole block's bytes and at most two stored-block
        # headers of 5 bytes beside the 26 of the framing.
        assert all(B < len(m) - 26 <= B + 10 for _, m in ms[:2])


@pytest.mark.parametrize("name", NAMES)
def test_the_port_reads_the_references_files(port_reads, name):
    out, (taken, declined) = port_reads
    assert out[name] == OBJECTS[name]
    assert declined == 0
    assert taken == sum(-(-len(o) // B) + 1 for o in OBJECTS.values())


@pytest.mark.parametrize("fmt", ["bgzf", "gzip"])
def test_a_calls_members_decode_in_one_device_batch(spans, fmt):
    """Three files of 2, 1 and 3 data members and their EOF markers: one
    inflate.batch, where a member at a time made one a member."""
    objs = [phrase_object(n, 40 + n) for n in (B + 300, 700, 2 * B + 9)]
    files = [bgzf_ref.encode(o, 6) for o in objs]
    assert api.decompress_many(files, fmt, device="cpu") == objs
    assert spans.count("inflate.batch") == 1
    assert spans.count("inflate.index") == 1


def test_batches_split_at_the_decode_span(spans, monkeypatch):
    """With MAX_DECODE_SPAN at two blocks, five members of 65,280 bytes
    (and two EOF markers) decode in three batches, in order."""
    monkeypatch.setattr(inflate_pipeline, "MAX_DECODE_SPAN", 2 * B)
    objs = [phrase_object(3 * B, 51), phrase_object(2 * B, 52)]
    files = [bgzf_ref.encode(o, 6) for o in objs]
    assert bgzf.decompress_many(files, device="cpu") == objs
    assert spans.count("inflate.batch") == 3


def damaged(how: str) -> bytes:
    f = bgzf_ref.encode(phrase_object(B + 100, 61), 6)
    (o0, m0), (o1, m1), _ = members(f)
    if how == "bsize-past-the-end":
        return f[:o1 + 16] + struct.pack("<H", len(f) - o1 + 40) \
            + f[o1 + 18:]
    if how == "cut-mid-member":
        return f[:o1 + len(m1) // 2]
    if how == "zeroed-crc":
        return bgzf_ref.break_integrity(f)
    if how == "wrong-isize":
        return f[:o1 - 4] + struct.pack("<I", B - 1) + f[o1:]
    if how == "trailing-garbage":
        return f + b"trailing garbage bytes"
    raise ValueError(how)


ERRORS = {"bsize-past-the-end": UnexpectedEof, "cut-mid-member": UnexpectedEof,
          "zeroed-crc": DataError, "wrong-isize": DataError,
          "trailing-garbage": DataError}


@pytest.mark.parametrize("how", sorted(ERRORS))
def test_a_damaged_file_raises_gzips_error(how):
    with pytest.raises(ERRORS[how]):
        api.decompress_many([damaged(how)], "bgzf", device="cpu")


def not_all_bgzf(how: str) -> tuple[bytes, bytes]:
    """(file, its plaintext) whose members are not all BGZF's."""
    a, b = phrase_object(900, 71), phrase_object(1200, 72)
    if how == "stock-member-inside":
        return (bgzf_ref.encode(a, 6)[:-28] + gzip.compress(b, mtime=0)
                + SPEC_EOF, a + b)
    if how == "stock-gzip":
        return gzip.compress(a + b, mtime=0), a + b
    if how == "isize-above-a-member":
        # A stock member with a 'BC' subfield whose plaintext is larger
        # than any BGZF member's.
        big = phrase_object(bgzf.MAX_MEMBER + 10, 73)
        body = gzip.compress(big, mtime=0)[10:]
        size = 18 + len(body)
        return (b"\x1f\x8b\x08\x04\0\0\0\0\0\xff\x06\0BC\x02\0"
                + struct.pack("<H", size - 1) + body, big)
    raise ValueError(how)


@pytest.mark.parametrize("how", ["isize-above-a-member",
                                 "stock-gzip", "stock-member-inside"])
def test_a_file_not_all_bgzf_is_declined_and_decoded(spans, how):
    f, plain = not_all_bgzf(how)
    before = bgzf.declines
    assert api.decompress_many([f], "bgzf", device="cpu") == [plain]
    assert bgzf.declines == before + 1
    assert spans.count("bgzf.decline") == 1


def test_the_streaming_shapes_take_bgzf():
    """CodecStream writes a file the reference reads and refuses a flush
    (a BGZF file has one EOF marker); DecodeStream reads a file in
    pieces, each member checked, and raises on one cut short."""
    obj = phrase_object(B + 2000, 81)
    s = api.CodecStream("bgzf", 6, device="cpu")
    s.write(obj[:5000])
    with pytest.raises(DataError):
        s.flush()
    s.write(obj[5000:])
    f = s.finish()
    assert bgzf_ref.decode(f) == obj
    d = api.DecodeStream("bgzf")
    out = b"".join(d.write(f[i:i + 1000]) for i in range(0, len(f), 1000))
    assert out + d.finish() == obj
    d = api.DecodeStream("bgzf")
    d.write(f[:-40])
    with pytest.raises(UnexpectedEof):
        d.finish()


REF_BREACHES = {
    "no-eof-marker": lambda f: f[:-28],
    "bytes-after-the-eof-marker": lambda f: f + b"\0",
    "zeroed-crc": bgzf_ref.break_integrity,
    "bsize-one-short": lambda f: f[:16] + struct.pack(
        "<H", struct.unpack_from("<H", f, 16)[0] - 1) + f[18:],
    "flg-with-fname": lambda f: f[:3] + b"\x0c" + f[4:],
}


@pytest.mark.parametrize("breach", sorted(REF_BREACHES))
def test_the_references_reader_is_strict(breach):
    f = bgzf_ref.encode(phrase_object(3000, 91), 6)
    assert bgzf_ref.decode(f) == phrase_object(3000, 91)
    with pytest.raises(ValueError):
        bgzf_ref.decode(REF_BREACHES[breach](f))


def test_the_reference_imports_the_standard_library_alone():
    tree = ast.parse(inspect.getsource(bgzf_ref))
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names == {"__future__", "struct", "zlib"}
