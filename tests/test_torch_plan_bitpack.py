"""tpz_torch symbols, histograms, device planner and bit packer against
the JAX reference, on CPU. Integer outputs: the tolerance is exact
equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpz.kernels import bitpack as jbp
from tpz.kernels import deflate_pipeline as jdp
from tpz.kernels import deflate_plan_device as jplan
from tpz.utils import corpus
from tpz_torch.kernels import bitpack as tbp
from tpz_torch.kernels import deflate_pipeline as tdp
from tpz_torch.kernels import deflate_plan_device as tplan

B = 65536


def _t(x, dtype=None):
    a = np.array(x)
    return torch.from_numpy(a if dtype is None else a.astype(dtype))


def _np64(x):
    return np.asarray(x).astype(np.int64)


def test_length_and_dist_symbols():
    ml = np.arange(0, 260, dtype=np.int32)
    for a, b in zip(jbp.length_symbol(jnp.asarray(ml)),
                    tbp.length_symbol(_t(ml))):
        np.testing.assert_array_equal(b.numpy(), _np64(a))
    md = np.arange(0, 32769, dtype=np.int32)
    for a, b in zip(jbp.dist_symbol(jnp.asarray(md)),
                    tbp.dist_symbol(_t(md))):
        np.testing.assert_array_equal(b.numpy(), _np64(a))


@pytest.mark.parametrize("nbins", [288, 30])
def test_histograms(nbins):
    rng = np.random.default_rng(nbins)
    sym = rng.integers(0, nbins + 1, (4, 5000), dtype=np.int32)
    sym[1, :] = nbins               # an all-masked row
    sym[2, :4000] = 7               # a skewed row
    ref = jdp._hist_by_sort(jnp.asarray(sym), nbins)
    np.testing.assert_array_equal(tdp._hist(_t(sym), nbins).numpy(),
                                  np.asarray(ref))


def test_plan_tables_match():
    ref = jplan.plan_tables()
    got = tplan.plan_tables()
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _token_stream(rng, n, match_frac):
    """A random valid token stream over n positions: (is_token, mlen,
    mdist) [n] with matches of length 3..258 at distances <= 32768."""
    is_token = np.zeros(n, bool)
    mlen = np.zeros(n, np.int32)
    mdist = np.zeros(n, np.int32)
    p = 0
    while p < n:
        is_token[p] = True
        if rng.random() < match_frac and n - p >= 3:
            ln = int(min(rng.choice([3, 4, 5, 8, 17, 40, 258]), n - p))
            mlen[p] = ln
            mdist[p] = int(rng.integers(1, 32769))
            p += ln
        else:
            p += 1
    return is_token, mlen, mdist


def _cases():
    """Five blocks in three buffers: dynamic (text + matches), stored
    (random, two chunks), fixed (tiny), dynamic, stored (one chunk)."""
    rng = np.random.default_rng(0)
    lens = [B, B, 11, 40_000, 1000]
    data = [corpus.text(B, seed=1), corpus.random_bytes(B, seed=2),
            b"hello world", corpus.source_code(40_000, seed=3),
            corpus.random_bytes(1000, seed=4)]
    frac = [0.3, 0.0, 0.0, 0.5, 0.0]
    NB = len(lens)
    data_block = np.zeros((NB, B), np.int32)
    is_token = np.zeros((NB, B), bool)
    mlen = np.zeros((NB, B), np.int32)
    mdist = np.zeros((NB, B), np.int32)
    for b in range(NB):
        data_block[b, :lens[b]] = np.frombuffer(data[b], np.uint8)
        t, m, d = _token_stream(rng, lens[b], frac[b])
        is_token[b, :lens[b]], mlen[b, :lens[b]], mdist[b, :lens[b]] = t, m, d
    block_len = np.array(lens, np.int32)
    buf_start = np.array([True, False, True, False, True])
    bfinal = np.array([False, True, False, True, True])
    return data_block, is_token, mlen, mdist, block_len, buf_start, bfinal


def _hists(data_block, is_token, mlen, mdist):
    is_match = is_token & (mlen > 0)
    lsym, _, _ = jbp.length_symbol(jnp.clip(jnp.asarray(mlen), 0, 258))
    lit_sym = np.where(is_match, np.asarray(lsym), data_block)
    dsym, _, _ = jbp.dist_symbol(jnp.maximum(jnp.asarray(mdist), 1))
    lit = jdp._hist_by_sort(jnp.asarray(
        np.where(is_token, np.clip(lit_sym, 0, 287), 288)), 288)
    dist = jdp._hist_by_sort(jnp.asarray(
        np.where(is_match, np.clip(np.asarray(dsym), 0, 29), 30)), 30)
    return np.array(lit), np.array(dist)


def _both_plans(lit, dist, block_len, buf_start, bfinal, live=None):
    ref = jplan.plan_device(lit, dist, block_len, buf_start, bfinal,
                            live=None if live is None else jnp.asarray(live))
    tables = {k: torch.from_numpy(v) for k, v in tplan.plan_tables().items()}
    got = tplan.plan_device(_t(lit), _t(dist), _t(block_len), _t(buf_start),
                            _t(bfinal), tables,
                            live=None if live is None else _t(live))
    return ref, got


def test_plan_device_matches_reference():
    data_block, is_token, mlen, mdist, block_len, buf_start, bfinal = _cases()
    lit, dist = _hists(data_block, is_token, mlen, mdist)
    ref, got = _both_plans(lit, dist, block_len, buf_start, bfinal)
    # dynamic, stored, fixed, dynamic, stored
    np.testing.assert_array_equal(got["btype"].numpy(), [2, 0, 1, 2, 0])
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      _np64(ref[k]), err_msg=k)


def test_plan_device_padding_blocks():
    """live=False blocks (zero length) emit no bits and no header."""
    data_block, is_token, mlen, mdist, block_len, buf_start, bfinal = _cases()
    lit, dist = _hists(data_block, is_token, mlen, mdist)
    lit[2] = 0
    dist[2] = 0
    block_len[2] = 0
    live = block_len > 0
    ref, got = _both_plans(lit, dist, block_len, buf_start, bfinal, live)
    assert int(got["hdr_nbits"][2].sum()) == 0
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64),
                                      _np64(ref[k]), err_msg=k)


def test_assemble_stream_v2_matches_reference():
    data_block, is_token, mlen, mdist, block_len, buf_start, bfinal = _cases()
    lit, dist = _hists(data_block, is_token, mlen, mdist)
    plan = jplan.plan_device(lit, dist, block_len, buf_start, bfinal)
    NB = len(block_len)
    table320 = jnp.concatenate([plan["lit_cl"], plan["dist_cl"],
                                jnp.zeros((NB, 2), jnp.int32)], axis=1)
    cap = (9 * int(block_len.sum()) + 31) // 32 + 3 * NB + 16
    header = (plan["hdr_vals"], plan["hdr_nbits"], plan["hdr_offs"])
    ref = np.asarray(jbp.assemble_stream_v2(
        jnp.asarray(data_block), jnp.asarray(is_token), jnp.asarray(mlen),
        jnp.asarray(mdist), table320, plan["body_off"], plan["btype"],
        jnp.asarray(block_len), plan["chunk1_off"], header,
        jnp.zeros((cap + 2,), jnp.uint32)))
    total_words = (int(plan["end_pos"][-1]) + 31) // 32
    got = tbp.assemble_stream_v2(
        _t(data_block), _t(is_token), _t(mlen), _t(mdist), _t(table320),
        _t(plan["body_off"]), _t(plan["btype"]), _t(block_len),
        _t(plan["chunk1_off"]),
        tuple(_t(h, np.int64) for h in header), total_words)
    assert got.shape == (total_words,)
    np.testing.assert_array_equal(got.numpy(), ref[:total_words].astype(
        np.int64))
    assert not ref[total_words:].any()
