"""The port's bzip2 decode slice (tpz_torch.api "bzip2" on device="cpu")
end to end: stdlib and oracle streams at levels 1 and 9, concatenated
streams and a batch of two level buckets give their inputs back, the
reference's declines go to the host decoder and are counted in
bzip2_pipeline.host_declines, the second route of decompress (host symbol
decode, device iBWT) is counted in bzip2_pipeline.host_symbol_decodes, and
a clean stream takes neither.
Outputs are bytes: the tolerance is exact equality.

The plain symbol walk costs about 0.5 ms of CPU per symbol of the longest
block, so every stream here keeps its blocks to a few thousand symbols."""

import bz2

import pytest
import torch

from tpz_torch import api, errors, oracle
from tpz_torch.codecs import bzip2
from tpz_torch.kernels import bzip2_pipeline as bp
from tpz_torch.kernels import bzip2_walk as bw
from tpz_torch.utils import corpus

TEXT = corpus.text(5000, seed=71)
MIXED = corpus.mixed(4000, seed=72)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain walk runs many tiny torch ops, for which intra-op threads
    only add overhead (and contend with the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_declines():
    """Fails the test if the device walk declined a stream."""
    before = bp.host_declines, bp.host_symbol_decodes
    yield
    assert (bp.host_declines, bp.host_symbol_decodes) == before


@pytest.mark.parametrize("level", [1, 9])
def test_stdlib_stream_round_trips(level, no_declines):
    assert api.decompress(bz2.compress(TEXT, level), "bzip2",
                          device="cpu") == TEXT


@pytest.mark.parametrize("level", [1, 9])
def test_oracle_stream_round_trips(level, no_declines):
    assert api.decompress(oracle.bzip2_encode(MIXED, level), "bzip2",
                          device="cpu") == MIXED


def test_two_stream_concatenation_round_trips(no_declines):
    """Two streams back to back (the second at another level): the
    per-stream EOS and combined-CRC checks pass, the outputs join."""
    blob = bz2.compress(TEXT, 1) + oracle.bzip2_encode(MIXED, 9)
    assert bp._max_level(blob) == 9
    assert api.decompress(blob, "bzip2", device="cpu") == TEXT + MIXED


def test_mixed_level_batch_makes_two_groups(monkeypatch, no_declines):
    """Two level-1 streams and a level-9 stream in one decompress_many:
    two bucket groups (2^17 and 2^20), one dispatch each, every output its
    input."""
    rep = corpus.repetitive(150_000, seed=73)
    datas = [TEXT, MIXED, rep]
    blobs = [bz2.compress(TEXT, 1), oracle.bzip2_encode(MIXED, 9),
             bz2.compress(rep, 1)]
    calls = []
    real = bw.decode_blocks_device

    def spy(scan, slices, N, *a, **kw):
        calls.append((N, len(scan["sym_bits"])))
        return real(scan, slices, N, *a, **kw)

    monkeypatch.setattr(bw, "decode_blocks_device", spy)
    assert api.decompress_many(blobs, "bzip2", device="cpu") == datas
    assert sorted(calls) == [(1 << 17, 2), (1 << 20, 1)]


def test_dispatches_split_at_the_block_limit(monkeypatch, no_declines):
    """A group above MAX_DISPATCH_BLOCKS runs in several dispatches with
    the same result."""
    monkeypatch.setattr(bp, "MAX_DISPATCH_BLOCKS", 1)
    blobs = [bz2.compress(TEXT, 1),
             bz2.compress(corpus.repetitive(120_000, seed=74), 1)]
    want = [TEXT, corpus.repetitive(120_000, seed=74)]
    assert bzip2.decompress_many(blobs, device="cpu") == want


def test_corrupt_combined_crc_declines_to_the_host():
    """A wrong combined CRC fails the EOS check on both device routes; the
    host decoder raises DataError, and the stream counts one decline."""
    enc = bytearray(bz2.compress(TEXT, 1))
    enc[-2] ^= 0x40
    before = bp.host_declines
    second = bp.host_symbol_decodes
    assert bp.decompress_walk(bytes(enc), "cpu") is None
    with pytest.raises(errors.DataError):
        api.decompress(bytes(enc), "bzip2", device="cpu")
    assert bp.host_declines == before + 1
    assert bp.host_symbol_decodes == second + 1
    with pytest.raises(errors.DataError):
        api.decompress_many([bytes(enc)], "bzip2", device="cpu")
    assert bp.host_declines == before + 2
    assert bp.host_symbol_decodes == second + 1


def test_second_route_decodes_what_the_walk_declines(monkeypatch):
    """Where the device walk declines a stream, decompress tries the
    reference's second route (the host decodes the symbols, the device
    runs the iBWT) before the host decoder, and counts it."""
    monkeypatch.setattr(bp, "decompress_walk", lambda data, device: None)
    blob = oracle.bzip2_encode(MIXED, 9)
    before = bp.host_declines, bp.host_symbol_decodes
    assert api.decompress(blob, "bzip2", device="cpu") == MIXED
    assert (bp.host_declines, bp.host_symbol_decodes) == (before[0],
                                                          before[1] + 1)


def test_periodic_block_declines_to_the_host():
    """b"abc" * 4000 is periodic after RLE1: its LF map has three cycles,
    the iBWT flags it on both routes, the host decodes it."""
    data = b"abc" * 4000
    blob = oracle.bzip2_encode(data, 1)
    before = bp.host_declines
    assert bp.decompress_walk(blob, "cpu") is None
    assert api.decompress(blob, "bzip2", device="cpu") == data
    assert api.decompress_many([blob, bz2.compress(TEXT, 1)], "bzip2",
                               device="cpu") == [data, TEXT]
    assert bp.host_declines == before + 2


@pytest.mark.parametrize("make", [
    lambda: b"", lambda: b"BZ", lambda: b"not bzip2 at all",
    lambda: oracle.bzip2_encode(b"", 9)],
    ids=["empty", "short", "garbage", "empty-stream"])
def test_unscannable_input_goes_to_the_host(make):
    """What the header scan refuses (or a stream too short to scan) is the
    host decoder's: its result or its error, counted once."""
    blob = make()
    before = bp.host_declines
    try:
        want = oracle.bzip2_decode(blob)
    except errors.CompressionError as e:
        want = type(e)
    try:
        got = api.decompress(blob, "bzip2", device="cpu")
    except errors.CompressionError as e:
        got = type(e)
    assert got == want
    assert bp.host_declines == before + 1


def test_bzip2_encode_is_not_ported():
    """bzip2 encode, once an unsupported format of the api, is ported: both
    entry points give the oracle's stream, which this decode reads back."""
    want = oracle.bzip2_encode(b"abc", 6)
    assert api.compress(b"abc", "bzip2", device="cpu") == want
    assert api.compress_many([b"abc"], "bzip2", device="cpu") == [want]
    assert api.decompress(want, "bzip2", device="cpu") == b"abc"
