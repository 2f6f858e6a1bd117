"""Every decode entry point of the port on sound and damaged streams that
stock tools write, against the reference package's oracle route.

Each case decodes one stream on device "cpu" through `api.decompress`,
`api.decompress_many` (the stream beside a sound one) or
`api.DecodeStream` (fed in 1 KiB writes), and holds the outcome to the
reference's: the same bytes, or an error in both with the same class
name. The reference is `tpz.api.decompress(stream, fmt,
backend="oracle")`, and for `DecodeStream` the reference's
`DecodeStream` fed the same writes: the reference's own streaming and
whole decoders differ where a damaged bzip2 block never ends (the
incremental decoder waits for more input and reports UnexpectedEof at
`finish`, the whole decoder DataError). The streams are written by
stdlib `gzip`, `zlib` and `bz2` (raw DEFLATE by `zlib.compressobj` with
wbits -15) from 1 KiB of `corpus.mixed`, then cut at half, cut inside
the header, given one byte flipped mid-body, a wrong trailer check
(CRC-32, Adler-32 or the bzip2 stream CRC; raw DEFLATE has none) or
trailing garbage. A case that another test file already holds (the same
format, stream and entry point, e.g. the sound streams through
`api.decompress` in test_torch_decode_slice.py and
test_torch_bzip2_decode.py, or the DecodeStream cases of
test_torch_stream.py) is left out. The port's decodes on the CPU run the
plain walks, one torch op a token trip, so the payload stays small and
the cases run on one torch thread."""

import bz2
import gzip
import zlib

import pytest
import torch

import tpz.api as japi
from tpz_torch import api
from tpz_torch.utils import corpus

FORMATS = ("gzip", "zlib", "deflate", "bzip2")
STREAMS = ("sound", "half", "header-cut", "flipped", "bad-check", "trailing")
ENTRIES = ("decompress", "decompress_many", "DecodeStream")
PIECE = 1024
GARBAGE = b"trailing garbage"
# (format, stream, entry point) that other test files hold already.
HELD = {
    *((f, "sound", e) for f in FORMATS for e in ("decompress", "DecodeStream")),
    ("gzip", "sound", "decompress_many"),
    ("gzip", "flipped", "decompress"), ("zlib", "flipped", "decompress"),
    ("gzip", "bad-check", "decompress"), ("bzip2", "bad-check", "decompress"),
    ("bzip2", "bad-check", "decompress_many"),
    *((f, s, "DecodeStream") for f in FORMATS
      for s in ("header-cut", "trailing")),
    ("gzip", "bad-check", "DecodeStream"),
    ("bzip2", "bad-check", "DecodeStream"),
}
CASES = [(f, s, e) for f in FORMATS for s in STREAMS for e in ENTRIES
         if not (f == "deflate" and s == "bad-check")
         and (f, s, e) not in HELD]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw_deflate(data: bytes) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    return c.compress(data) + c.flush()


def _bad_check(fmt: str, blob: bytes) -> bytes:
    """The stream with one bit of its trailer check flipped: gzip's CRC-32
    (the trailer's first four bytes), zlib's Adler-32 (its last four),
    bzip2's combined CRC (the 32 bits before the last byte's pad bits
    hold the second-to-last byte whole)."""
    b = bytearray(blob)
    b[{"gzip": -8, "zlib": -1, "bzip2": -2}[fmt]] ^= 0x40
    return bytes(b)


@pytest.fixture(scope="module")
def streams():
    """{(format, stream): blob} and the sound payload."""
    data = corpus.mixed(1024, seed=20)
    sound = {"gzip": gzip.compress(data, 6), "zlib": zlib.compress(data, 6),
             "deflate": _raw_deflate(data), "bzip2": bz2.compress(data, 1)}
    out = {}
    for fmt, blob in sound.items():
        mid = len(blob) // 2
        flipped = bytearray(blob)
        flipped[mid] ^= 0x5A
        out.update({(fmt, "sound"): blob, (fmt, "half"): blob[:mid],
                    (fmt, "header-cut"): blob[:3],
                    (fmt, "flipped"): bytes(flipped),
                    (fmt, "trailing"): blob + GARBAGE})
        if fmt != "deflate":
            out[(fmt, "bad-check")] = _bad_check(fmt, blob)
    return out, data


def _outcome(fn):
    try:
        return ("bytes", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is the class
        return ("error", type(e).__name__)


def _stream_decode(package, fmt: str, blob: bytes) -> bytes:
    s = package.DecodeStream(fmt)
    out = [s.write(blob[i:i + PIECE]) for i in range(0, len(blob), PIECE)]
    return b"".join(out) + s.finish()


@pytest.mark.parametrize("fmt,stream,entry", CASES)
def test_outcome_equals_the_reference(streams, fmt, stream, entry):
    blobs, data = streams
    blob = blobs[(fmt, stream)]
    if entry == "DecodeStream":
        want = _outcome(lambda: _stream_decode(japi, fmt, blob))
        got = _outcome(lambda: _stream_decode(api, fmt, blob))
    elif entry == "decompress":
        want = _outcome(lambda: japi.decompress(blob, fmt, backend="oracle"))
        got = _outcome(lambda: api.decompress(blob, fmt, device="cpu"))
    else:
        want = _outcome(lambda: japi.decompress(blob, fmt, backend="oracle"))
        if want[0] == "bytes":
            want = ("bytes", [data, want[1]])
        got = _outcome(lambda: api.decompress_many(
            [blobs[(fmt, "sound")], blob], fmt, device="cpu"))
    assert got == want
