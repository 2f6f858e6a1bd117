"""The port's raw LZSS codec (tpz_torch/codecs/lzss.py) and its api
surface (`formats()`, `register_format`, "lzss") held against the JAX
package's (tpz/codecs/lzss.py, tpz/api.py), on the same C++ oracle (the
reference's binding loads the library the repo's root conftest.py points
it at). Bytes and error outcomes are compared exactly."""

import pytest

import tpz.api as japi
from tpz.codecs import lzss as jlzss
from tpz_torch import api
from tpz_torch.codecs import lzss
from tpz_torch.errors import DataError, UnexpectedEof
from tpz_torch.utils import corpus

CONFIGS = {
    "default": None,
    # tests/test_lzss_codec.py's LzssEncoder::new(...) analog.
    "crate": dict(window=4096, min_match=3, max_match=64, lazy=True),
    "short-window": dict(window=256, min_match=4, max_match=18,
                         max_chain=4),
}
INPUTS = {
    **corpus.edge_cases(),
    "text": corpus.text(20_000, seed=3),
    "repetitive": corpus.repetitive(20_000, seed=4),
    "incompressible": corpus.random_bytes(8_000, seed=5),
}


def _configs(name):
    kw = CONFIGS[name]
    if kw is None:
        return None, None
    return lzss.LzssConfig(**kw), jlzss.LzssConfig(**kw)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_bytes_equal_the_reference(name, cfg):
    data = INPUTS[name]
    mine_cfg, ref_cfg = _configs(cfg)
    blob = lzss.compress(data, device="cpu", config=mine_cfg)
    assert blob == jlzss.compress(data, config=ref_cfg)
    assert lzss.decompress(blob, device="cpu", config=mine_cfg) == data
    assert (lzss.tokenize(data, mine_cfg)
            == jlzss.tokenize(data, ref_cfg)).all()


def test_api_lzss_round_trip_and_batches():
    datas = [INPUTS["text"], b"", INPUTS["repetitive"][:999]]
    blobs = api.compress_many(datas, "lzss", device="cpu")
    assert blobs == [japi.compress(d, "lzss") for d in datas]
    assert blobs[0] == api.compress(datas[0], "lzss", device="cpu")
    assert api.decompress_many(blobs, "lzss", device="cpu") == datas
    assert api.decompress(blobs[2], "lzss", device="cpu") == datas[2]


def _outcome(fn, blob):
    try:
        return ("ok", fn(blob))
    except Exception as e:  # noqa: BLE001 — the class and message compared
        return (type(e).__name__, str(e))


def _corrupt_cases():
    blob = lzss.compress(INPUTS["text"], device="cpu")
    n = len(INPUTS["text"])
    return {
        "empty": b"",
        "seven-bytes": blob[:7],
        "header-only": blob[:8],
        "truncated-body": blob[: len(blob) // 2],
        "size-above-real": (n + 100).to_bytes(8, "little") + blob[8:],
        "trailing-byte": blob + b"\x00",
        "size-below-real": (n - 100).to_bytes(8, "little") + blob[8:],
        # A final reference that would run past the declared size
        # (tests/test_lzss_codec.py::test_final_ref_crossing_size_raises).
        "ref-crosses-size": (4).to_bytes(8, "little")
        + bytes([0b10, ord("a"), 2, 1, 0]),
        "ref-before-start": (4).to_bytes(8, "little")
        + bytes([0b1, 0, 5, 0]),
    }


@pytest.mark.parametrize("case", sorted(_corrupt_cases()))
def test_error_outcomes_equal_the_reference(case):
    blob = _corrupt_cases()[case]
    mine = _outcome(lambda b: lzss.decompress(b, device="cpu"), blob)
    assert mine == _outcome(jlzss.decompress, blob)
    want = {"empty": UnexpectedEof, "seven-bytes": UnexpectedEof,
            "truncated-body": UnexpectedEof,
            "size-above-real": UnexpectedEof,
            "ref-crosses-size": DataError, "ref-before-start": DataError}
    if case in want:
        assert mine[0] == want[case].__name__
    if case in ("seven-bytes", "empty"):
        assert mine[1] == "lzss stream too short"
    if case in ("truncated-body", "size-above-real"):
        assert mine[1] == "lzss_unpack"
    if case == "trailing-byte":
        assert mine == ("ok", INPUTS["text"])


@pytest.mark.parametrize("size", [1 << 62, (1 << 64) - 1])
def test_huge_declared_size_raises_a_compression_error(size):
    """R10: the reference sizes its output buffer from the untrusted
    header and raises numpy's MemoryError (not a CompressionError); the
    port caps the buffer at what the body can yield and raises the error
    the stream runs into."""
    blob = size.to_bytes(8, "little") + lzss.compress(
        INPUTS["text"], device="cpu")[8:]
    with pytest.raises(UnexpectedEof, match="lzss_unpack"):
        lzss.decompress(blob, device="cpu")
    if size < 1 << 63:
        with pytest.raises(MemoryError):
            jlzss.decompress(blob)


def test_formats_equal_the_reference():
    """The reference's formats, and BGZF, which only the port has."""
    assert sorted(japi.formats() + ["bgzf"]) == api.formats()
    assert api.formats() == ["bgzf", "bzip2", "deflate", "gzip", "lh4",
                             "lh5", "lh6", "lh7", "lzss", "zlib"]


@pytest.fixture
def tables(monkeypatch):
    """The api's format tables, restored after the test."""
    for name in ("_COMPRESS", "_COMPRESS_MANY", "_DECOMPRESS",
                 "_DECOMPRESS_MANY"):
        monkeypatch.setattr(api, name, dict(getattr(api, name)))


def test_register_format_round_trip(tables):
    def enc(data, level, *, device):
        return b"R" + bytes(reversed(data))

    def dec(data, *, device):
        assert data[:1] == b"R"
        return bytes(reversed(data[1:]))

    api.register_format("rev", enc, dec)
    assert "rev" in api.formats()
    datas = [b"abc", b"", b"tpz"]
    blobs = api.compress_many(datas, "rev", device="cpu")
    assert blobs == [b"Rcba", b"R", b"Rzpt"]
    assert api.decompress_many(blobs, "rev", device="cpu") == datas
    assert api.decompress(api.compress(b"xy", "rev", device="cpu"), "rev",
                          device="cpu") == b"xy"
    # The built-in formats keep their batched entries.
    assert api._COMPRESS_MANY["gzip"] is not None
    assert "gzip" in api._DECOMPRESS_MANY and "lh5" in api._COMPRESS_MANY
    # Replacing a built-in name routes its *_many through the new pair.
    api.register_format("bzip2", enc, dec)
    assert api.compress_many([b"ab"], "bzip2", device="cpu") == [b"Rba"]
    assert api.decompress_many([b"Rba"], "bzip2", device="cpu") == [b"ab"]


def test_unknown_format_message_is_the_reference():
    """The reference's message, its list of formats with the port's
    "bgzf" first."""
    for call in (lambda: api.compress(b"abc", "lz77", device="cpu"),
                 lambda: api.decompress_many([b"abc"], "lz77",
                                             device="cpu")):
        with pytest.raises(ValueError) as mine:
            call()
        with pytest.raises(ValueError) as ref:
            japi.compress(b"abc", "lz77")
        assert str(mine.value) == str(ref.value).replace(
            "have ['bzip2'", "have ['bgzf', 'bzip2'")


def test_lzss_validates_the_device():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        api.compress(b"abc", "lzss")
    with pytest.raises(RuntimeError, match="cuda"):
        api.decompress(b"\0" * 8, "lzss")
