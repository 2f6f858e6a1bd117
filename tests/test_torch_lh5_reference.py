"""The port against the benchmark's plain LHA -lh5- reference
(benchmark/reference/lzhuf_ref.py), on the CPU at small sizes with
seeded inputs: the reference reads every stream the port writes, the
port reads every stream the reference writes (on its device path, none
handed to the host decoder), the reference's reader is strict, and the
reference loads nothing of the port."""

import ast
import functools
import inspect
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import lzhuf_ref as ref
from tpz_torch import api
from tpz_torch.kernels import lzhuf_walk
from tpz_torch.utils import corpus

CLASSES = {"text": corpus.text, "source": corpus.source_code,
           "repetitive": corpus.repetitive, "random": corpus.random_bytes,
           "skewed": corpus.skewed_bytes}
LENGTHS = (0, 1, 2, 3, 8191, 8192, 8193, 32767, 32768, 32769)


def _inputs() -> dict:
    out = {f"class-{k}": fn(4096, seed=11 + i)
           for i, (k, fn) in enumerate(CLASSES.items())}
    out.update({f"len-{n}": corpus.mixed(n, seed=n) for n in LENGTHS})
    # No three bytes repeat: one block of literals, its P table the
    # one-symbol (count 0) form.
    out["literal-only"] = bytes(range(0, 250, 3))
    # 256 literals of one count: every C code 8 bits, so the T table is
    # the one-symbol form.
    out["one-t-symbol"] = bytes(np.random.default_rng(7).permutation(256)
                                .astype(np.uint8))
    out["one-c-symbol"] = b"Q"
    return out


def full_block() -> bytes:
    """Units of two literals and a 64-byte chunk seen in the unit before:
    66 literals, then a literal, a literal and a match a unit, 65,700
    tokens. The literals (below 128, each the same only every 128 units,
    more than the window holds) never start a match; the chunk (bytes
    from 128 up) always matches whole. Its tokens spread over 22
    segments of 64 KiB, so the port's plain walk on the CPU stays
    short."""
    chunk = np.random.default_rng(5).integers(128, 256, 64, dtype=np.uint8)
    k = np.arange(21_900)
    units = np.zeros((k.size, 2 + chunk.size), np.uint8)
    units[:, 0] = k & 0x7F
    units[:, 1] = (37 * k + 11) & 0x7F
    units[:, 2:] = chunk
    return units.tobytes()


def full_block_kinds() -> np.ndarray:
    """Whether each token of full_block's parse is a match."""
    unit = np.array([False, False, True])
    return np.concatenate([np.zeros(66, bool), np.tile(unit, 21_899)])


def by_count(is_match) -> list:
    """Blocks of the count field's largest, 65,535 tokens: a cut no LHA
    writer makes (its buffer sends ~29,100 tokens at most), built by
    hand to reach the reader's limit."""
    n = is_match.size
    return [(t, min(t + ref.MAX_COUNT, n))
            for t in range(0, n, ref.MAX_COUNT)]


def output_st1_blocks(is_match) -> list:
    """(first token, end token) of each block as LHa for UNIX's huf.c
    output_st1 sends them, token by token: a 32 KiB buffer, a flag byte
    before every eight tokens, a literal one byte, a match three, and
    the block sent at a flag byte once output_pos >= bufsiz - 24."""
    bufsiz, cuts, start, pos, mask = 16 * 1024 * 2, [], 0, 0, 0
    for t, m in enumerate(is_match.tolist()):
        mask >>= 1
        if mask == 0:
            mask = 0x80
            if pos >= bufsiz - 3 * 8:
                cuts.append((start, t))
                start, pos = t, 0
            pos += 1
        pos += 3 if m else 1
    if start < is_match.size:
        cuts.append((start, is_match.size))
    return cuts


INPUTS = _inputs()
DECODE_ONLY = {"full-block": full_block}
# Streams cut by hand rather than by the writer's LHA rule.
HAND_CUT = {"full-block": by_count}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain walk runs many tiny torch ops, for which intra-op threads
    only add overhead (and contend with the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def data(name: str) -> bytes:
    return DECODE_ONLY[name]() if name in DECODE_ONLY else INPUTS[name]


@functools.lru_cache(maxsize=None)
def ref_stream(name: str) -> bytes:
    if name not in HAND_CUT:
        return ref.encode(data(name), 5)
    d = data(name)
    return (ref.MAGIC + ref.METHOD + struct.pack("<Q", len(d))
            + ref.encode_body(d, blocks=HAND_CUT[name]))


@functools.lru_cache(maxsize=None)
def port_streams() -> dict:
    """Every input through the port's encode in one batch."""
    names = sorted(INPUTS)
    out = api.compress_many([INPUTS[n] for n in names], "lh5", 5,
                            device="cpu")
    return dict(zip(names, out))


@functools.lru_cache(maxsize=None)
def port_reads() -> tuple:
    """Every reference stream through the port's decode in one batch, and
    the streams the port handed to its host decoder meanwhile."""
    names = sorted(INPUTS) + sorted(DECODE_ONLY)
    before = lzhuf_walk.host_declines
    out = api.decompress_many([ref_stream(n) for n in names], "lh5",
                              device="cpu")
    return dict(zip(names, out)), lzhuf_walk.host_declines - before


def first_header(stream: bytes):
    """(token count, T table, C table, P table) of the body's first
    block, each table (lengths, None) or (None, its one symbol)."""
    return ref.read_header(ref._Reader(stream[ref.HEADER:]))


@pytest.mark.parametrize("name", sorted(INPUTS) + sorted(DECODE_ONLY))
def test_the_reference_reads_back_what_it_writes(name):
    assert ref.decode(ref_stream(name)) == data(name)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_the_reference_reads_the_ports_streams(name):
    s = port_streams()[name]
    assert s[:ref.HEADER] == (b"TPZL" + b"lh5"
                              + struct.pack("<Q", len(INPUTS[name])))
    assert ref.decode(s) == INPUTS[name]


@pytest.mark.parametrize("name", sorted(INPUTS) + sorted(DECODE_ONLY))
def test_the_port_reads_the_references_streams(name):
    out, _ = port_reads()
    assert out[name] == data(name)


def test_the_device_path_takes_every_reference_stream():
    """No stream of the batch, the one-symbol table forms and the block
    of 65,535 tokens among them, goes to the host decoder."""
    _, declined = port_reads()
    assert declined == 0


def test_the_reference_writes_the_one_symbol_forms_and_a_full_block():
    _, _, c, p = first_header(ref_stream("literal-only"))
    assert c[0] is not None and p == (None, 0)
    _, t, c, _ = first_header(ref_stream("one-t-symbol"))
    assert t == (None, 8 + 2) and set(c[0][c[0] > 0]) == {8}
    assert first_header(ref_stream("one-c-symbol"))[2] == (None, ord("Q"))
    assert first_header(ref_stream("full-block"))[0] == ref.MAX_COUNT
    # The port's blocks are cut at 32 KiB of input: this one is not.
    assert len(data("full-block")) > 10 * 32768


def test_the_writer_cuts_blocks_as_lhas_buffer_does():
    """Unless cut by hand, a block ends where LHA's 32 KiB token buffer
    sends it, far below the count field's largest."""
    s = ref.encode(data("full-block"), 5)
    want = output_st1_blocks(full_block_kinds())
    assert first_header(s)[0] == want[0][1] < 29_200
    assert ref.decode(s) == data("full-block")


@pytest.mark.parametrize("kinds", ["literals", "matches", "mixed-1",
                                   "mixed-2", "short"])
def test_lha_blocks_are_output_st1s(kinds):
    rng = np.random.default_rng(len(kinds))
    is_match = {"literals": np.zeros(100_000, bool),
                "matches": np.ones(70_001, bool),
                "mixed-1": rng.random(150_003) < 0.3,
                "mixed-2": rng.random(99_999) < 0.8,
                "short": np.array([True, False, True])}[kinds]
    assert ref.lha_blocks(is_match) == output_st1_blocks(is_match)


def test_the_parse_is_lhas_one_step_lazy():
    """A match is sent unless the match one byte on is longer; a byte
    with no match of 3 or more is a literal."""
    best = np.array([3, 5, 4, 3, 2, 1, 0, 4, 4, 3, 2, 0, 2, 0])
    starts, mlen = ref._lazy(best)
    assert starts.tolist() == [0, 1, 6, 7, 11, 12, 13]
    assert mlen.tolist() == [0, 5, 0, 4, 0, 0, 0]


def test_the_port_writes_the_one_symbol_forms_the_reference_reads():
    assert first_header(port_streams()["literal-only"])[3] == (None, 0)
    assert first_header(port_streams()["one-c-symbol"])[2] == (
        None, ord("Q"))


def _body_parts(name):
    s = ref_stream(name)
    return s[:ref.HEADER], s[ref.HEADER:]


@pytest.mark.parametrize("name", ["class-text", "len-8193", "full-block"])
def test_the_reader_raises_on_a_truncated_body(name):
    head, body = _body_parts(name)
    for cut in (1, len(body) // 2, len(body) - 1):
        with pytest.raises(ValueError):
            ref.decode(head + body[:cut])


@pytest.mark.parametrize("name", ["class-text", "len-0", "len-8193"])
def test_the_reader_raises_on_trailing_bytes(name):
    for extra in (b"\0", b"\x80\0\0"):
        with pytest.raises(ValueError):
            ref.decode(ref_stream(name) + extra)


@pytest.mark.parametrize("name", ["class-text", "len-1", "len-8193"])
def test_the_reader_raises_on_a_wrong_size(name):
    head, body = _body_parts(name)
    n = len(data(name))
    with pytest.raises(ValueError):
        ref.decode(ref.break_integrity(ref_stream(name)))
    with pytest.raises(ValueError):
        ref.decode(head[:7] + struct.pack("<Q", n + 1) + body)


def test_the_reader_raises_on_a_foreign_container_or_set_pad_bits():
    s = ref_stream("class-text")
    with pytest.raises(ValueError):
        ref.decode(b"TPZX" + s[4:])
    with pytest.raises(ValueError):
        ref.decode(s[:4] + b"lh6" + s[7:])
    # One C symbol, no T or P lengths: a 52-bit header and tokens of
    # no bits, so the body's last 4 bits are padding.
    s = ref_stream("one-c-symbol")
    assert len(s) == ref.HEADER + 7
    with pytest.raises(ValueError):
        ref.decode(s[:-1] + bytes([s[-1] | 1]))


def test_the_reference_imports_nothing_of_the_port():
    tree = ast.parse(inspect.getsource(ref))
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "heapq", "struct", "numpy"}
    code = ("import sys; import benchmark.reference.lzhuf_ref as r; "
            "s = r.encode(b'abcabcabc' * 50, 5); assert r.decode(s); "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = set(subprocess.run([sys.executable, "-c", code], check=True,
                                capture_output=True, text=True,
                                cwd=ref.__file__.rsplit("/benchmark/", 1)[0]
                                ).stdout.split())
    assert not loaded & {"tpz", "tpz_torch", "torch", "cpp", "jax"}


def test_lh5_api_calls_emit_the_frame_span_under_the_api_span():
    a, b = INPUTS["class-source"], INPUTS["class-text"]
    for fn in (lambda: api.compress_many([a, b], "lh5", 5, device="cpu"),
               lambda: api.decompress_many([ref_stream("class-source"),
                                            ref_stream("class-text")],
                                           "lh5", device="cpu")):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
        spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name()) for e in prof.profiler.kineto_results
                       .events() if e.name().startswith("tpz_torch."))
        names = [s[2] for s in spans]
        assert names[0].startswith("tpz_torch.api.")
        assert names.count("tpz_torch.lzhuf.frame") == 1
        t0, t1 = spans[0][:2]
        assert all(t0 <= x <= y <= t1 for x, y, _ in spans[1:])
        got = out if isinstance(out[0], bytes) and out[0][:4] != b"TPZL" \
            else [ref.decode(s) for s in out]
        assert got == [a, b]
