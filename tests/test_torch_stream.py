"""The port's streaming shapes (tpz_torch.api.CodecStream, DecodeStream)
held against the JAX package's (tpz.api), byte for byte: the reference
runs with backend="oracle", the port on device="cpu", both on the same
C++ oracle (the reference's binding loads the library the repo's root
conftest.py points it at).

Every finish() of a deflate, zlib or gzip stream runs the port's plain
encoder (about a second a call on this CPU), so the port's encodes are
made once in a module fixture and the inputs are a few KiB. One
difference is by design: a gzip stream finished without a flush is
api.compress's member, which carries the 'TZ' block index as the
reference's device route writes it (its oracle route writes none); the
test rebuilds the reference's device-route header from the oracle
member and the index."""

import bz2
import gzip
import io
import struct
import zlib

import pytest
import torch

import tpz.api as japi
from tpz.codecs import gzip_codec as jgzip
from tpz_torch import api
from tpz_torch.action import Action
from tpz_torch.codecs import gzip_codec
from tpz_torch.errors import DataError
from tpz_torch.utils import corpus

# The formats the reference has (the port's "bgzf" is held to its own
# reference in test_torch_bgzf.py).
FORMATS = japi.formats()
NO_FLUSH = ("lh4", "lh5", "lh6", "lh7", "lzss")
DATA = corpus.mixed(3000, seed=21)
PARTS = (DATA[:1000], DATA[1000:2200], DATA[2200:])
LEVEL = 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain encoder runs many small torch ops, for which intra-op
    threads only add overhead (and contend with the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the class and message compared
        return (type(e).__name__, str(e))


def _encode(s, action, scenario):
    """The outputs of each call of a stream scenario on CodecStream `s`
    (`action`: its package's Action enum), as (call, outcome) pairs; a
    call that raises ends the scenario."""
    steps = {
        "finish": [("write", DATA[i:i + 1]) for i in range(len(DATA))]
        + [("finish", None)],
        "flush": [("flush", None), ("write", PARTS[0]), ("flush", None),
                  ("write", PARTS[1]), ("flush", None), ("write", PARTS[2]),
                  ("finish", None)],
        "drive": [("drive", (PARTS[0], "RUN")),
                  ("drive", (PARTS[1], "FLUSH")),
                  ("drive", (PARTS[2], "FINISH"))],
        "empty": [("finish", None), ("finish", None)],
    }[scenario]
    out = []
    for call, arg in steps:
        if call == "write":
            res = _outcome(lambda: s.write(arg))
        elif call == "drive":
            res = _outcome(lambda: s.drive(arg[0], action[arg[1]]))
        else:
            res = _outcome(getattr(s, call))
        out.append((call, res))
        if res[0] != "ok":
            break
    return out


def _joined(steps) -> bytes:
    """The stream a scenario wrote: its flush, drive and finish outputs."""
    return b"".join(r[1] for c, r in steps if c != "write")


SCENARIOS = [(f, sc) for f in FORMATS for sc in ("finish", "flush", "empty")]
SCENARIOS += [("gzip", "drive"), ("bzip2", "drive")]


@pytest.fixture(scope="module")
def port_encodes():
    return {(f, sc): _encode(api.CodecStream(f, LEVEL, device="cpu"), Action,
                             sc)
            for f, sc in SCENARIOS}


def _tz_route(ref_member: bytes, port_member: bytes) -> bytes:
    """The reference's device-route member for the oracle route's
    `ref_member`: the same body and trailer, the header with the port's
    TZ index (checked against the body) in FEXTRA."""
    pos, extra = jgzip.parse_header_extra(port_member, 0)
    ends, lens = jgzip.parse_tz_extra(extra)
    body = ref_member[10:-8]
    assert int(lens.sum()) == struct.unpack("<I", ref_member[-4:])[0]
    assert (int(ends[-1]) + 7) // 8 == len(body)
    assert ref_member[:10] == jgzip.header_bytes(LEVEL)
    return jgzip.header_bytes(LEVEL, 0, jgzip._tz_extra(ends, lens)) + \
        ref_member[10:]


@pytest.mark.parametrize("fmt,scenario", SCENARIOS)
def test_codec_stream_equals_the_reference(port_encodes, fmt, scenario):
    mine = port_encodes[(fmt, scenario)]
    ref = _encode(japi.CodecStream(fmt, LEVEL, backend="oracle"),
                  japi.Action, scenario)
    if fmt == "gzip" and scenario in ("finish", "empty"):
        # Finished without a flush: api.compress's member.
        ref = [(c, ("ok", _tz_route(r[1], m[1][1])))
               if c == "finish" and r[0] == "ok" else (c, r)
               for (c, r), m in zip(ref, mine)]
    assert mine == ref
    if fmt in NO_FLUSH and scenario in ("flush", "drive"):
        assert mine[-1][1][0] == "DataError"
    if scenario == "empty":
        assert mine[-1][1] == ("DataError", "stream already finished")
        s = api.CodecStream(fmt, device="cpu")
        s.finish()
        with pytest.raises(DataError, match="stream already finished"):
            s.write(b"x")


@pytest.mark.parametrize("fmt", ["gzip", "zlib", "deflate", "bzip2"])
def test_flushed_stream_decodes_with_stdlib(port_encodes, fmt):
    """A flushed deflate-family stream is one stream (one header, a
    trailer over all the data); a flushed bzip2 stream is a concatenation
    of streams, which bz2 reads."""
    blob = _joined(port_encodes[(fmt, "flush")])
    plain = {"gzip": gzip.decompress, "bzip2": bz2.decompress,
             "zlib": zlib.decompress,
             "deflate": lambda b: zlib.decompress(b, -15)}[fmt](blob)
    assert plain == DATA
    if fmt == "gzip":
        assert blob.count(gzip_codec.header_bytes(LEVEL)) == 1
    assert api.decompress(blob, fmt, device="cpu") == DATA


def test_codec_stream_rejects_bad_use():
    for mod in (api, japi):
        with pytest.raises(ValueError, match="unknown format 'lz77'"):
            mod.CodecStream("lz77")
        with pytest.raises(ValueError, match="unknown format 'lz77'"):
            mod.DecodeStream("lz77")
    s = api.CodecStream("lzss", device="cpu")
    s.write(b"abc")
    with pytest.raises(DataError, match="no concatenable stream form"):
        s.flush()
    assert api.decompress(s.finish(), "lzss", device="cpu") == b"abc"
    with pytest.raises(DataError, match="already finished"):
        s.flush()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            api.CodecStream("gzip")


# ---------------------------------------------------------------- decode


def _decode(make, blob, piece):
    """Each write's plaintext and finish's, or the (class, message) of the
    first call that raises."""
    s = make()
    out = []
    for i in range(0, len(blob), piece):
        res = _outcome(lambda: s.write(blob[i:i + piece]))
        out.append(res)
        if res[0] != "ok":
            return out
    out.append(_outcome(s.finish))
    return out


def _fname_member(data: bytes) -> bytes:
    buf = io.BytesIO()
    with gzip.GzipFile(filename="tpz.txt", mode="wb", fileobj=buf,
                       mtime=7) as f:
        f.write(data)
    return buf.getvalue()


@pytest.fixture(scope="module")
def blobs(port_encodes):
    """Valid streams of every format: the port's finished and flushed
    encodes, and stdlib or oracle streams beside them."""
    out = {}
    for f in FORMATS:
        out[(f, "port")] = port_encodes[(f, "finish")][-1][1][1]
        if f not in NO_FLUSH:
            out[(f, "flushed")] = _joined(port_encodes[(f, "flush")])
    member = _fname_member(PARTS[1])
    out[("gzip", "members")] = (out[("gzip", "port")] + member
                                + gzip.compress(b"") + gzip.compress(PARTS[2]))
    out[("gzip", "stdlib")] = member
    out[("zlib", "stdlib")] = zlib.compress(DATA, 9)
    out[("deflate", "stdlib")] = zlib.compress(DATA, 1)[2:-4]
    out[("bzip2", "stdlib")] = bz2.compress(DATA, 1) + bz2.compress(
        PARTS[0], 9)
    out[("deflate", "empty")] = b""
    return out


DECODE_CASES = [(f, k) for f in FORMATS for k in ("port", "flushed")
                if not (f in NO_FLUSH and k == "flushed")]
DECODE_CASES += [("gzip", "members"), ("gzip", "stdlib"), ("zlib", "stdlib"),
                 ("deflate", "stdlib"), ("bzip2", "stdlib"),
                 ("deflate", "empty")]


@pytest.mark.parametrize("piece", [1, 61, 1 << 16])
@pytest.mark.parametrize("fmt,kind", DECODE_CASES)
def test_decode_stream_equals_the_reference(blobs, fmt, kind, piece):
    blob = blobs[(fmt, kind)]
    mine = _decode(lambda: api.DecodeStream(fmt), blob, piece)
    assert mine == _decode(lambda: japi.DecodeStream(fmt), blob, piece)
    assert mine[-1][0] == "ok"
    want = {("gzip", "members"): DATA + PARTS[1] + PARTS[2],
            ("gzip", "stdlib"): PARTS[1], ("deflate", "empty"): b"",
            ("bzip2", "stdlib"): DATA + PARTS[0]}.get((fmt, kind), DATA)
    assert b"".join(r[1] for r in mine) == want


def _bad_combined_crc(blob: bytes) -> bytes:
    """The stream's last 32 bits before the byte padding are its combined
    CRC; find them by the end-of-stream magic and flip one."""
    from tpz_torch.codecs.bzip2 import _find_magics

    eos = _find_magics(blob, 0, 8 * len(blob))[-1]
    b = bytearray(blob)
    bit = eos + 48 + 5
    b[bit // 8] ^= 0x80 >> (bit % 8)
    return bytes(b)


def _corrupt(blobs, fmt, how):
    blob = blobs[(fmt, "port")]
    return {"truncated": blob[:-3], "cut-header": blob[:5],
            "trailing": blob + b"xyz",
            "bad-crc": _bad_combined_crc(blob) if fmt == "bzip2" else
            blob[:-8] + bytes([blob[-8] ^ 1]) + blob[-7:]}[how]


CORRUPT = [(f, h) for f in FORMATS for h in ("truncated", "cut-header",
                                             "trailing")]
CORRUPT += [("gzip", "bad-crc"), ("bzip2", "bad-crc")]


@pytest.mark.parametrize("piece", [1, 1 << 16])
@pytest.mark.parametrize("fmt,how", CORRUPT)
def test_decode_stream_errors_equal_the_reference(blobs, fmt, how, piece):
    blob = _corrupt(blobs, fmt, how)
    mine = _decode(lambda: api.DecodeStream(fmt), blob, piece)
    assert mine == _decode(lambda: japi.DecodeStream(fmt), blob, piece)
    if how == "truncated" and fmt != "lzss":
        assert mine[-1][0] == "UnexpectedEof"
    if how == "bad-crc":
        assert mine[-1][0] == "DataError"


def test_decode_stream_rejects_writes_after_finish(blobs):
    s = api.DecodeStream("gzip")
    assert s.write(blobs[("gzip", "port")]) == DATA
    assert s.finish() == b""
    with pytest.raises(DataError, match="already finished"):
        s.write(b"")
    with pytest.raises(DataError, match="already finished"):
        s.finish()
