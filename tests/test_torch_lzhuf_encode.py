"""The port's LZHUF encode (tpz_torch/kernels/lzhuf_pipeline.py and the
stages it calls) held against the JAX package: the spec-v1 screen against
JAX's screen_candidates, the plain v1 parse walk against JAX's
parse_extend_pallas (interpret mode) and against find_matches +
greedy_parse, the MSB packer against assemble_stream_msb, the two stages
against JAX's _stage1 / _stage2 on the same blocks, and the slice's bytes
against the C++ oracle. Inputs are numpy arrays from fixed seeds handed to
both packages; everything compared is an integer, so the tolerance is
exact equality."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpz.kernels import bitpack as jbitpack
from tpz.kernels import lzhuf_pipeline as jlp
from tpz.kernels import matchfinder as jmf
from tpz.kernels.parse import greedy_parse, parse_extend_pallas
from tpz_torch import api, oracle
from tpz_torch import constants as C
from tpz_torch.codecs import lzhuf
from tpz_torch.kernels import bitpack
from tpz_torch.kernels import lzhuf_pipeline as lp
from tpz_torch.kernels import matchfinder as mf
from tpz_torch.kernels import parse
from tpz_torch.utils import corpus

LH5_BITS, LH5_NP = C.LZHUF_METHODS["lh5"]
LH5_WINDOW = 1 << LH5_BITS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers run side by side, and more
    threads per worker only contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ref_blocks(datas, window):
    """The reference compress_many's block layout (tpz/kernels/
    lzhuf_pipeline.py), built the same way: [NB, window + 32768 + 512]
    bytes with span_off, span_len, block_len [NB] int32."""
    nbs = [(len(d) + jlp.BLOCK - 1) // jlp.BLOCK for d in datas]
    M = window + jlp.BLOCK + jlp.FWD
    blocks = np.zeros((sum(nbs), M), np.uint8)
    span_off = np.zeros(sum(nbs), np.int32)
    span_len = np.zeros(sum(nbs), np.int32)
    block_len = np.zeros(sum(nbs), np.int32)
    r0 = 0
    for d, nb in zip(datas, nbs):
        span = np.zeros(window + nb * jlp.BLOCK + jlp.FWD, np.uint8)
        span[window:window + len(d)] = np.frombuffer(d, np.uint8)
        for b in range(nb):
            blocks[r0 + b] = span[b * jlp.BLOCK:b * jlp.BLOCK + M]
        span_off[r0:r0 + nb] = np.arange(nb) * jlp.BLOCK
        span_len[r0:r0 + nb] = len(d)
        block_len[r0:r0 + nb] = np.minimum(len(d) - np.arange(nb)
                                           * jlp.BLOCK, jlp.BLOCK)
        r0 += nb
    return blocks, span_off, span_len, block_len


def _small_blocks(n, seed):
    """test_kernels.py's geometry: window 512, block 1024, 3 blocks, the
    last one short when n < 3072."""
    window, block = 512, 1024
    data = np.frombuffer(corpus.mixed(n, seed=seed), np.uint8)
    span = np.zeros(window + 3 * block + 512, np.uint8)
    span[window:window + n] = data
    m = window + block + 512
    idx = np.arange(3)[:, None] * block + np.arange(m)[None, :]
    span_off = (np.arange(3) * block).astype(np.int32)
    block_len = np.minimum(n - span_off, block).astype(np.int32)
    return span[idx], span_off, block_len, window, block


@pytest.fixture(scope="module")
def lh5_batch():
    """Two buffers of different lengths in one lh5 batch: 2 + 1 blocks,
    both last blocks short."""
    datas = [corpus.mixed(50_000, seed=21), corpus.text(20_000, seed=22)]
    return datas, _ref_blocks(datas, LH5_WINDOW)


def test_make_blocks_equals_the_reference_layout(lh5_batch):
    datas, (blocks, span_off, span_len, block_len) = lh5_batch
    got = lp.make_blocks(datas, LH5_WINDOW, "cpu")
    np.testing.assert_array_equal(got[0].numpy(), blocks)
    for g, w in zip(got[1:4], (span_off, span_len, block_len)):
        np.testing.assert_array_equal(g, w)
    assert got[4] == [2, 1]


def _screen_both(blocks, span_off, span_len, k, window, block):
    want = jmf.screen_candidates(jnp.asarray(blocks.astype(np.int32)),
                                 jnp.asarray(span_off), jnp.asarray(span_len),
                                 k, window, block, C.LZHUF_MAX_MATCH)
    got = mf.screen_candidates(_t(blocks), _t(span_off), _t(span_len), k,
                               window, block, C.LZHUF_MAX_MATCH)
    return got, [np.asarray(w) for w in want]


def test_screen_matches_jax_small_geometry():
    blocks, span_off, block_len, window, block = _small_blocks(3072, 77)
    got, want = _screen_both(blocks, span_off, np.int32(3072), 8, window,
                             block)
    for name, g, w in zip(("best_j", "best_screen", "words", "cap_at"),
                          got, want):
        np.testing.assert_array_equal(g.numpy().view(w.dtype), w,
                                      err_msg=name)
    assert (want[0] >= 0).any() and (want[1] == 8).any()


def test_screen_matches_jax_lh5_two_buffers(lh5_batch):
    _, (blocks, span_off, span_len, _) = lh5_batch
    got, want = _screen_both(blocks, span_off, span_len, lp.MAX_CHAIN,
                             LH5_WINDOW, jlp.BLOCK)
    for name, g, w in zip(("best_j", "best_screen", "words", "cap_at"),
                          got, want):
        np.testing.assert_array_equal(g.numpy().view(w.dtype), w,
                                      err_msg=name)


def test_screen_rejects_rows_too_wide_for_the_sort_key():
    w = torch.zeros((1, 1 << 17), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^17"):
        mf.screen_candidates_w(w, torch.zeros(1, dtype=torch.int32), 10, 1,
                               16, 16, 256)


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("n", [3072, 2700], ids=["full", "short-last"])
def test_parse_v1_matches_jax_pallas_interpret(lazy, n):
    blocks, span_off, block_len, window, block = _small_blocks(n, 123)
    bj, bs, words, _ = jmf.screen_candidates(
        jnp.asarray(blocks.astype(np.int32)), jnp.asarray(span_off),
        jnp.int32(n), 8, window, block, 258)
    sl = slice(window, window + block)
    bs, bj = np.asarray(bs)[:, sl], np.asarray(bj)[:, sl]
    words = np.asarray(words).view(np.int32)
    reach_w, mlen_w = map(np.asarray, parse_extend_pallas(
        bs, bj, jnp.asarray(words), jnp.asarray(block_len[:, None]), window,
        lazy=lazy, interpret=True))
    reach, mlen = parse.parse_extend_v1(_t(bs), _t(bj), _t(words),
                                        _t(block_len), window, lazy=lazy)
    reach, mlen = reach.numpy(), mlen.numpy()
    np.testing.assert_array_equal(mlen, mlen_w)
    np.testing.assert_array_equal(reach > 0, reach_w > 0)
    live = np.arange(block)[None, :] < block_len[:, None]
    np.testing.assert_array_equal(np.where(live, reach, 0),
                                  np.where(live, reach_w, 0))
    assert (mlen >= 3).any()


def _parse_v1_both(blocks, span_off, block_len, window, block, n,
                   max_match, lazy):
    """(the port's plain v1 walk, JAX's parse_extend_pallas in interpret
    mode) on the same screened blocks: each (reach, mlen) as numpy."""
    bj, bs, words, _ = jmf.screen_candidates(
        jnp.asarray(blocks.astype(np.int32)), jnp.asarray(span_off),
        jnp.int32(n), 8, window, block, max_match)
    sl = slice(window, window + block)
    bs, bj = np.asarray(bs)[:, sl], np.asarray(bj)[:, sl]
    words = np.asarray(words).view(np.int32)
    want = tuple(map(np.asarray, parse_extend_pallas(
        bs, bj, jnp.asarray(words), jnp.asarray(block_len[:, None]), window,
        max_match=max_match, lazy=lazy, interpret=True)))
    got = parse.parse_extend_v1_plain(_t(bs), _t(bj), _t(words),
                                      _t(block_len), window,
                                      max_match=max_match, lazy=lazy)
    return tuple(g.numpy() for g in got), want


@pytest.mark.parametrize("lazy", [False, True])
def test_parse_v1_plain_extends_to_cap_on_a_256_byte_repeat(lazy):
    """Blocks of nothing but one 256-byte pattern repeated: past the first
    period every screen saturates and the extension runs to the cap
    (LZHUF_MAX_MATCH = 256, or the block's end)."""
    window, block = 512, 1024
    pattern = np.frombuffer(corpus.random_bytes(256, seed=31), np.uint8)
    n = 3 * block
    span = np.zeros(window + 3 * block + 512, np.uint8)
    span[window:window + n] = np.tile(pattern, n // 256)
    idx = np.arange(3)[:, None] * block + np.arange(window + block + 512)
    span_off = (np.arange(3) * block).astype(np.int32)
    block_len = np.full(3, block, np.int32)
    (reach, mlen), (reach_w, mlen_w) = _parse_v1_both(
        span[idx], span_off, block_len, window, block, n,
        C.LZHUF_MAX_MATCH, lazy)
    np.testing.assert_array_equal(reach, reach_w)
    np.testing.assert_array_equal(mlen, mlen_w)
    assert (mlen == C.LZHUF_MAX_MATCH).sum() >= 3 * (block // 256 - 1)


@pytest.mark.parametrize("lazy", [False, True])
def test_parse_v1_plain_walks_past_block_len(lazy):
    """A last block of 100 bytes: the walk goes on past block_len to N as
    the reference's does, and both agree at every position."""
    n = 2 * 1024 + 100
    blocks, span_off, block_len, window, block = _small_blocks(n, 77)
    assert block_len[-1] == 100
    (reach, mlen), (reach_w, mlen_w) = _parse_v1_both(
        blocks, span_off, block_len, window, block, n, 258, lazy)
    np.testing.assert_array_equal(reach, reach_w)
    np.testing.assert_array_equal(mlen, mlen_w)
    assert (reach[-1, 100:] > 0).sum() > 0


def test_parse_v1_block_size_limit_needs_no_card():
    """The CUDA kernel holds a 16-bit length and a visited bit a position
    in one block's shared memory; the wrapper checks N before any launch,
    from N alone."""
    parse.check_parse_v1_n(lp.BLOCK)
    assert parse.parse_v1_shared_bytes(lp.BLOCK) == 2 * 32768 + 4096
    largest = 32 * (parse.SHARED_LIMIT // 68)  # 68 bytes a 32 positions
    parse.check_parse_v1_n(largest)
    for n in (largest + 32, 1 << 17, 0):
        with pytest.raises(ValueError, match=str(parse.SHARED_LIMIT)):
            parse.check_parse_v1_n(n)


def test_parse_v1_matches_jax_find_matches_at_lh5(lh5_batch):
    """At lh5's geometry the plain walk's tokens and lengths equal the
    reference's CPU route (find_matches, then greedy_parse)."""
    _, (blocks, span_off, span_len, block_len) = lh5_batch
    bj, bs, words, _ = mf.screen_candidates(
        _t(blocks), _t(span_off), _t(span_len), lp.MAX_CHAIN, LH5_WINDOW,
        jlp.BLOCK, C.LZHUF_MAX_MATCH)
    sl = slice(LH5_WINDOW, LH5_WINDOW + jlp.BLOCK)
    reach, mlen = parse.parse_extend_v1(
        bs[:, sl].contiguous(), bj[:, sl].contiguous(), words, _t(block_len),
        LH5_WINDOW, max_match=C.LZHUF_MAX_MATCH)
    mlen_w, mdist_w = jmf.find_matches(
        jnp.asarray(blocks.astype(np.int32)), jnp.asarray(span_off),
        jnp.asarray(span_len), k=lp.MAX_CHAIN, window=LH5_WINDOW,
        block=jlp.BLOCK, max_match=C.LZHUF_MAX_MATCH)
    tok_w, _, _ = greedy_parse(mlen_w, mdist_w, jnp.asarray(block_len))
    tok_w, mlen_w, mdist_w = map(np.asarray, (tok_w, mlen_w, mdist_w))
    live = np.arange(jlp.BLOCK)[None, :] < block_len[:, None]
    tok = (reach.numpy() > 0) & live
    np.testing.assert_array_equal(tok, tok_w)
    np.testing.assert_array_equal(mlen.numpy()[tok], mlen_w[tok])
    mdist = np.arange(jlp.BLOCK)[None, :] + LH5_WINDOW - bj[:, sl].numpy()
    m = tok & (mlen.numpy() > 0)
    np.testing.assert_array_equal(mdist[m], mdist_w[m])


def test_parse_v1_rejects_unsupported_device():
    z = torch.zeros((1, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        parse.parse_extend_v1(z, z, z, z[:, 0], 16)


@pytest.mark.parametrize("seed", [0, 1])
def test_msb_packer_matches_jax(seed):
    """Random slots with widths 0..31, three rows whose bit ranges meet
    inside a word (a word shared across a row boundary)."""
    rng = np.random.default_rng(seed)
    NB, S = 3, 700
    nbits = rng.integers(0, 32, size=(NB, S)).astype(np.int32)
    nbits[:, ::7] = 31
    nbits[rng.random((NB, S)) < 0.2] = 0
    vals = (rng.integers(0, 1 << 32, size=(NB, S), dtype=np.uint64)
            & ((np.uint64(1) << nbits.astype(np.uint64)) - np.uint64(1)))
    row_bits = nbits.sum(axis=1).astype(np.int64)
    body_off = np.concatenate([[5], 5 + np.cumsum(row_bits)[:-1]])
    total_words = int(-(-(5 + row_bits.sum()) // 32))
    want = np.asarray(jbitpack.assemble_stream_msb(
        jnp.asarray(vals.astype(np.uint32)), jnp.asarray(nbits),
        jnp.asarray(body_off.astype(np.int32)), total_words))
    got = bitpack.assemble_stream_msb(_t(vals.astype(np.int64)), _t(nbits),
                                      _t(body_off), total_words)
    assert (body_off % 32 != 0).all()
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_stages_match_jax(lh5_batch):
    """_stage1's tokens, histograms and counts equal JAX's _stage1 (its
    CPU route) on the same blocks; _stage2's words equal JAX's _stage2
    on the same stage-1 output and host plans."""
    _, (blocks, span_off, span_len, block_len) = lh5_batch
    mlen, mdist, is_token, c_hist, p_hist, ntokens = lp._stage1(
        _t(blocks), _t(span_off), _t(span_len), _t(block_len), lp.MAX_CHAIN,
        LH5_WINDOW, LH5_NP)
    jb = jnp.asarray(blocks.astype(np.int32))
    want = [np.asarray(a) for a in jlp._stage1(
        jb, jnp.asarray(span_off), jnp.asarray(span_len),
        jnp.asarray(block_len), lp.MAX_CHAIN, LH5_WINDOW, False, LH5_NP)]
    tok = is_token.numpy()
    np.testing.assert_array_equal(tok, want[2])
    np.testing.assert_array_equal(mlen.numpy()[tok], want[0][tok])
    np.testing.assert_array_equal(mdist.numpy()[tok], want[1][tok])
    for name, g, w in (("c_hist", c_hist, want[3]), ("p_hist", p_hist,
                                                     want[4]),
                       ("ntokens", ntokens, want[5])):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)

    # One host plan per buffer (2 blocks, then 1), regions word-aligned.
    plans, body_off, pos_bits = [], [], 0
    for sl in (slice(0, 2), slice(2, 3)):
        plan = oracle.lzhuf_plan(c_hist.numpy()[sl].astype(np.uint32),
                                 p_hist.numpy()[sl].astype(np.uint32),
                                 ntokens.numpy()[sl].astype(np.uint32),
                                 LH5_BITS)
        body_off.append(plan["body_off"] + pos_bits)
        pos_bits += (plan["total_bits"] + 31) // 32 * 32
        plans.append(plan)
    body_off = np.concatenate(body_off)
    total_words = pos_bits // 32
    tabs = {k: np.concatenate([p[k] for p in plans]).astype(np.int32)
            for k in ("c_len", "c_code", "p_len", "p_code")}
    got = lp._stage2(
        _t(blocks[:, LH5_WINDOW:LH5_WINDOW + jlp.BLOCK].astype(np.int32)),
        is_token, mlen, mdist, *(_t(tabs[k]) for k in tabs), _t(body_off),
        total_words)
    want_w = np.asarray(jlp._stage2(
        jb, jnp.asarray(tok), jnp.asarray(mlen.numpy()),
        jnp.asarray(mdist.numpy()), *(jnp.asarray(tabs[k]) for k in tabs),
        jnp.asarray(body_off.astype(np.int32)), total_words, LH5_WINDOW))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want_w)


CASES = {
    "empty": b"",
    "one": b"x",
    "tiny": b"hello hello hello hello",
    "boundary": corpus.text(32768, seed=1),
    "boundary+1": corpus.text(32769, seed=2),
    "random": corpus.random_bytes(20_000, seed=3),
    "mixed": corpus.mixed(70_000, seed=4),
    "repetitive": corpus.repetitive(40_000, seed=5),
}


@pytest.mark.parametrize("method", ["lh4", "lh5", "lh6", "lh7"])
def test_encode_slice_equals_the_oracle(method):
    bits = C.LZHUF_METHODS[method][0]
    datas = list(CASES.values())
    blobs = api.compress_many(datas, method, device="cpu")
    for name, d, blob in zip(CASES, datas, blobs):
        body = oracle.lzhuf_encode(d, bits, 16)
        assert blob == (b"TPZL" + method.encode() + struct.pack("<Q", len(d))
                        + body), name
        assert oracle.lzhuf_decode(blob[15:], len(d), bits) == d, name
    assert blobs == [api.compress(d, method, device="cpu") for d in datas]


def test_raw_compress_equals_the_oracle_and_checks_the_method():
    d = CASES["mixed"]
    assert lzhuf.raw_compress(d, "lh6", device="cpu") == oracle.lzhuf_encode(
        d, C.LZHUF_METHODS["lh6"][0], 16)
    with pytest.raises(ValueError, match="lzhuf method"):
        lzhuf.compress(d, "lh9", device="cpu")


@pytest.mark.parametrize("method", ["lh4", "lh5", "lh6", "lh7"])
def test_encode_plans_on_the_device(method, monkeypatch):
    """No host plan on the encode path: with oracle.lzhuf_plan raising,
    the bodies still equal the oracle's, and each group of buffers
    (MAX_DEVICE_SPAN lowered so that these make three) is planned once on
    the device."""
    def host_plan(*args, **kwargs):
        raise AssertionError("the encode called the host planner")

    monkeypatch.setattr(oracle, "lzhuf_plan", host_plan)
    monkeypatch.setattr(lp, "MAX_DEVICE_SPAN", 80_000)
    bits = C.LZHUF_METHODS[method][0]
    datas = [CASES[k] for k in ("mixed", "boundary+1", "repetitive",
                                "random", "tiny", "empty")]
    before = lp.device_plans
    bodies = lp.compress_many(datas, method, device="cpu")
    assert lp.device_plans == before + 3
    for d, body in zip(datas, bodies):
        assert body == oracle.lzhuf_encode(d, bits, 16)
