"""The rank-array extension of the spec-v1 matcher in the port
(`matchfinder.build_ranks`, `lcp_from_ranks`, `find_matches`) held exactly
equal to JAX's on the same inputs made from a numpy seed, at the sharded
encode step's test geometry (window 512, block 1024): a span of
corpus.mixed with one repetitive block (whose matches saturate at
max_match) that ends mid-block."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpz.kernels import matchfinder as jmf
from tpz_torch.kernels import matchfinder as mf
from tpz_torch.utils import corpus

WINDOW, BLOCK, FWD = 512, 1024, 512


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain CPU encoders run many small torch ops, for which
    intra-op threads only add overhead (and contend with the other test
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout(nb: int, seed: int):
    """(data [nb, WINDOW + BLOCK + FWD] int32 halo'd rows, span_off [nb]
    int32, span_len): the span ends 300 bytes before its last block's
    end, and block 1 repeats a 7-byte pattern."""
    n = nb * BLOCK - 300
    span = np.zeros(WINDOW + nb * BLOCK + FWD, np.uint8)
    span[WINDOW:WINDOW + n] = np.frombuffer(corpus.mixed(n, seed=seed),
                                            np.uint8)
    span[WINDOW + BLOCK:WINDOW + 2 * BLOCK] = np.frombuffer(
        b"tpzrank" * (BLOCK // 7 + 1), np.uint8)[:BLOCK]
    m = WINDOW + BLOCK + FWD
    rows = np.arange(nb)[:, None] * BLOCK + np.arange(m)[None, :]
    return (span[rows].astype(np.int32),
            (np.arange(nb) * BLOCK).astype(np.int32), n)


CASES = [(4, 4, 0), (16, 8, 1)]


@pytest.mark.parametrize("nb,k,seed", CASES)
def test_find_matches_equals_jax(nb, k, seed):
    data, span_off, n = _layout(nb, seed)
    mlen, mdist = mf.find_matches(torch.from_numpy(data),
                                  torch.from_numpy(span_off),
                                  torch.tensor(n, dtype=torch.int32), k=k,
                                  window=WINDOW, block=BLOCK)
    jlen, jdist = jmf.find_matches(jnp.asarray(data), jnp.asarray(span_off),
                                   jnp.int32(n), k=k, window=WINDOW,
                                   block=BLOCK)
    np.testing.assert_array_equal(mlen.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(mdist.numpy(), np.asarray(jdist))
    # The repetitive block saturates, and the span's tail is empty.
    assert int(mlen[1].max()) == jmf.MAX_MATCH
    assert not mlen[-1, BLOCK - 300:].any()


@pytest.mark.parametrize("nb,k,seed", CASES)
def test_build_ranks_equals_jax(nb, k, seed):
    data, _, _ = _layout(nb, seed)
    ranks = mf.build_ranks(mf.words_at(torch.from_numpy(data)))
    jranks = jmf.build_ranks(jmf.words_at(jnp.asarray(data)))
    assert sorted(ranks) == sorted(jranks) == list(mf.RANK_LEVELS)
    for lvl in mf.RANK_LEVELS:
        assert ranks[lvl].dtype == torch.int32
        np.testing.assert_array_equal(ranks[lvl].numpy(),
                                      np.asarray(jranks[lvl]), err_msg=lvl)


@pytest.mark.parametrize("nb,k,seed", CASES)
def test_lcp_from_ranks_equals_jax(nb, k, seed):
    """Random suffix pairs and caps, pairs on the repetitive block (its
    LCPs run to the cap) and pairs past the row's end (clamped)."""
    data, _, _ = _layout(nb, seed)
    m = data.shape[1]
    rng = np.random.default_rng(seed + 10)
    p = rng.integers(0, m, size=(nb, BLOCK)).astype(np.int32)
    q = rng.integers(0, m, size=(nb, BLOCK)).astype(np.int32)
    p[1] = rng.integers(WINDOW + 210, WINDOW + BLOCK - 260, size=BLOCK)
    q[1] = p[1] - 7 * rng.integers(1, 30, size=BLOCK)
    p[0, :8] = m + 5
    cap = rng.integers(0, 259, size=(nb, BLOCK)).astype(np.int32)
    words = mf.words_at(torch.from_numpy(data))
    got = mf.lcp_from_ranks(mf.build_ranks(words), torch.from_numpy(p),
                            torch.from_numpy(q), words,
                            torch.from_numpy(data), torch.from_numpy(cap))
    jwords = jmf.words_at(jnp.asarray(data))
    want = jmf.lcp_from_ranks(jmf.build_ranks(jwords), jnp.asarray(p),
                              jnp.asarray(q), jwords, jnp.asarray(data),
                              jnp.asarray(cap))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == cap)[1].all()


def test_build_ranks_rejects_rows_past_its_key():
    with pytest.raises(ValueError, match="2\\^17"):
        mf.build_ranks(torch.zeros((1, 1 << 17), dtype=torch.int32))
