"""The segmented decomposition of the port's copy machine
(tpz_torch/kernels/resolve_walk.py, csrc/resolve_walk.cu), held against
the plain version and the JAX package on the CPU.

`resolve_segments_plain` is the kernel's torch twin: boundary carries at
every segment cut, phase 1 per segment (token starts, sources, pointer
jumping inside the segment, pointers out of it), then phase 2's rounds.
At segments of 128, 512 and 2,048 positions, with dist_bias 0 and 1, its
packed state equals `resolve_doubling_state`'s and its bytes JAX's
`_resolve_doubling`, on random streams, self-overlapping runs, a run
stream whose chains cross every segment, and spans that are not a
multiple of the segment. The wrapper's span routing and its shared-memory
bound are checked without a card. Corrupt gzip and lh5 streams raise the
same error (class and message) through `tpz_torch.api` on the CPU as
through `tpz.api`. Everything compared is an integer or a string, so the
tolerance is exact equality."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_resolve import make_markers, overlap_runs
from tpz import api as japi
from tpz import oracle as joracle
from tpz.kernels.inflate_pipeline import _resolve_doubling
from tpz_torch import api, oracle
from tpz_torch.kernels import _build
from tpz_torch.kernels import resolve_walk as rw
from tpz_torch.utils import corpus

_LIT, _MATCH = 1, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The twin runs many small torch ops, for which intra-op threads only
    add overhead (and contend with the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_stream(n, seed, dist_bias=0, far=4096):
    """chip_smoke.synthetic_markers at a small size: a literal, then a
    258-byte match, over and over; 70% of the matches are dist 1-4 runs,
    the rest copy from up to `far` bytes back."""
    rng = np.random.default_rng(seed)
    g = n // 259
    m = np.full(n, _LIT << 28, np.int64)
    lit = np.arange(g) * 259
    m[lit] = (_LIT << 28) | rng.integers(0, 256, g)
    pos = lit + 1
    dist = np.where(rng.random(g) < 0.3,
                    1 + (rng.random(g) * np.minimum(pos, far)).astype(np.int64),
                    rng.integers(1, 5, g))
    m[pos] = (_MATCH << 28) | ((dist - dist_bias) << 9) | 258
    m[(pos[:, None] + np.arange(1, 258)).reshape(-1)] = 0
    return m.astype(np.int32)


def dist1_chain(n, dist_bias=0):
    """A literal, then 258-byte matches at dist 1 to the end: every match
    copies the byte before it, so the last byte's chain runs back through
    every segment of the span."""
    m = np.zeros(n, np.int32)
    m[0] = (_LIT << 28) | 0x5A
    starts = np.arange(1, n, 258)
    m[starts] = ((_MATCH << 28) | ((1 - dist_bias) << 9)
                 | np.minimum(258, n - starts))
    return m


def _case(name, bias):
    if name == "random":
        return make_markers(np.random.default_rng(21 + bias), 1 << 14, bias,
                            4096, p_lit=0.45)
    if name == "random-ragged":  # 43 rows: no segment length divides it
        return make_markers(np.random.default_rng(5 + bias), 43 * 128, bias,
                            3000, p_lit=0.3)
    if name == "overlap-runs":
        m = overlap_runs()
        if bias:  # the same runs with dist - 1 stored in the field
            mk = (m >> 28) == _MATCH
            m = np.where(mk, m - (1 << 9), m).astype(np.int32)
        return m
    if name == "runs":
        return run_stream(1 << 15, 7 + bias, bias)
    if name == "dist1-chain":
        return dist1_chain(1 << 15, bias)
    if name == "dist1-ragged":
        return dist1_chain(101 * 128, bias)
    raise KeyError(name)


CASES = ["random", "random-ragged", "overlap-runs", "runs", "dist1-chain",
         "dist1-ragged"]


@pytest.mark.parametrize("seg", [128, 512, 2048])
@pytest.mark.parametrize("bias", [0, 1])
@pytest.mark.parametrize("name", CASES)
def test_twin_equals_doubling_and_jax(name, bias, seg):
    m = _case(name, bias)
    t = torch.from_numpy(m)
    got = rw.resolve_segments_plain(t, bias, seg // 128)
    want = rw.resolve_doubling_state(t, bias)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy() >> 8, np.arange(len(m)))
    jax_bytes = np.asarray(_resolve_doubling(jnp.asarray(m), dist_bias=bias))
    np.testing.assert_array_equal((got & 0xFF).numpy(), jax_bytes)


@pytest.mark.parametrize("seg", [128, 512, 2048])
@pytest.mark.parametrize("name", ["runs", "dist1-chain", "random-ragged"])
def test_phase1_leaves_only_pointers_before_the_segment(name, seg):
    """After phase 1 every position is resolved at its own index or points
    strictly before its own segment; the dist-1 chain leaves pointers in
    every segment but the first, which phase 2 must follow."""
    m = torch.from_numpy(_case(name, 0))
    arr, n_seg, seg_len = rw._segments(m, seg // 128)
    st = rw._phase1_plain(arr, n_seg, seg_len, 0)
    idx = torch.arange(st.shape[0])
    target = st >> 8
    seg_start = idx - idx % seg_len
    assert bool(((target == idx) | (target < seg_start)).all())
    pointing = (target != idx).reshape(n_seg, seg_len).any(dim=1)
    if name == "dist1-chain":
        assert bool(pointing[1:].all())
    else:
        assert bool(pointing.any())


def test_dist1_chain_needs_every_phase2_round():
    """At 128-position segments a 2^20-position dist-1 chain is 8,192
    segments deep, past the 64 + 64 * 64 hops of the two bounded rounds
    (synchronous here): each leaves pointers, and the last round resolves
    them."""
    m = torch.from_numpy(dist1_chain(1 << 20))
    arr, n_seg, seg_len = rw._segments(m, 1)
    st = rw._phase1_plain(arr, n_seg, seg_len, 0)
    idx = torch.arange(st.shape[0])
    for hops in rw.PHASE2_HOPS[:-1]:
        st = rw._phase2_round_plain(st, hops)
        assert bool(((st >> 8) != idx).any())
    st = rw._phase2_round_plain(st, rw.PHASE2_HOPS[-1])
    np.testing.assert_array_equal((st >> 8).numpy(), idx.numpy())


def test_twin_runs_the_kernels_phase2_rounds():
    """The twin's PHASE2_HOPS are the hop limits the kernel's launcher
    gives its phase-2 rounds."""
    path = os.path.join(_build.CSRC, "resolve_walk.cu")
    with open(path) as f:
        src = f.read()
    hops = re.search(r"kPhase2Hops\[kPhase2Rounds\] = \{([^}]*)\}", src)
    rounds = re.search(r"kPhase2Rounds = (\d+);", src)
    assert tuple(int(h) for h in hops.group(1).split(",")) == rw.PHASE2_HOPS
    assert int(rounds.group(1)) == len(rw.PHASE2_HOPS)


def test_segments_pad_ragged_spans_with_literals():
    m = torch.from_numpy(_case("random-ragged", 0))
    arr, n_seg, seg_len = rw._segments(m, 16)
    assert (n_seg, seg_len) == (3, 2048)
    assert arr.shape[0] == 3 * 2048
    assert bool((arr[m.shape[0]:] == rw._LIT0).all())
    arr, n_seg, seg_len = rw._segments(m, 64)  # one segment: the span
    assert (n_seg, seg_len) == (1, m.shape[0])
    assert torch.equal(arr, m)


def test_segment_bound_and_span_routing():
    """The default segment fits one CUDA block's shared memory and a
    segment that does not is refused; a card resolves up to 2^24
    positions in one call and longer spans in chunks that, with their
    halo, still fit the packed state; the CPU keeps PHASE2_CAP."""
    rw._check_segment(rw.SEGMENT_ROWS)
    rw._check_segment(rw.SHARED_LIMIT // (8 * 128))
    for rows in (0, rw.SHARED_LIMIT // (8 * 128) + 1):
        with pytest.raises(ValueError, match="shared memory"):
            rw._check_segment(rows)
    assert rw.span_chunks("cpu") == (rw.PHASE2_CAP, rw.PHASE2_CAP)
    cap, step = rw.span_chunks("cuda")
    assert cap == rw.MAX_PACKED_SPAN
    assert step + rw.HALO <= rw.MAX_PACKED_SPAN and step % 128 == 0


# ------------------------------------------- corrupt streams, both packages

@pytest.fixture(scope="module")
def corrupt_blobs():
    """The port's gzip and lh5 encodings of a small buffer (the one
    chip_smoke.py corrupts), each with bit 4 of one byte flipped."""
    data = corpus.mixed(6000, seed=3)

    def flip(blob, off):
        b = bytearray(blob)
        b[off] ^= 0x10
        return bytes(b)

    g = api.compress(data, "gzip", 6, device="cpu")
    lh5 = api.compress(data, "lh5", device="cpu")
    return data, {"gzip-body": ("gzip", flip(g, len(g) // 2)),
                  "lh5-tables": ("lh5", flip(lh5, 40)),
                  "lh5-body": ("lh5", flip(lh5, len(lh5) // 2))}


def _outcome(fn):
    try:
        return ("bytes", fn())
    except Exception as e:  # the error is what is compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("case", ["gzip-body", "lh5-tables", "lh5-body"])
def test_corrupt_streams_fail_as_in_the_reference(corrupt_blobs, case,
                                                  monkeypatch):
    """gzip's CRC rejects a flipped body byte and LZHUF's decoder a flipped
    table byte, with the reference's error class and message; LZHUF has no
    checksum, so a flipped body byte decodes to the reference's bytes."""
    monkeypatch.setattr(joracle, "_LIB", None)
    monkeypatch.setattr(joracle, "_find_lib", lambda: oracle.build())
    data, blobs = corrupt_blobs
    fmt, blob = blobs[case]
    got = _outcome(lambda: api.decompress(blob, fmt, device="cpu"))
    want = _outcome(lambda: japi.decompress(blob, fmt))
    assert got == want
    if case == "lh5-body":
        assert got[0] == "bytes" and got[1] != data
    else:
        assert got[0] == "DataError"
