"""tpz_torch parse walk (plain torch version) against the JAX reference,
on CPU. Integer outputs: the tolerance is exact equality at live
positions (positions below each block's length).

- With n_extend=1 the port must equal `parse_extend_v3z` itself: the
  reference walk never loads the second candidate, which is the oracle's
  n_extend=1 behaviour.
- With n_extend=2 (what DeflateConfig uses) the tokens must equal the
  reference's oracle-identical CPU path, `find_matches_v3` +
  `greedy_parse`.

The reference's CPU pipeline never runs v3z, so it is called directly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpz.kernels import matchfinder as jmf
from tpz.kernels import parse as jparse
from tpz.utils import corpus
from tpz_torch.kernels import parse as tparse

WINDOW, BLOCK, NB, RESTART = 512, 1024, 3, 256


def _inputs(kind: str, r: int = 8, screen_bytes: int = 16):
    n = NB * BLOCK - 100
    raw = {"mixed": lambda: corpus.mixed(n, seed=654),
           "repetitive": lambda: corpus.repetitive(n, seed=77),
           # long source-code matches where candidate 2 extends further
           "source": lambda: corpus.source_code(n, seed=18)}[kind]()
    span = np.zeros(WINDOW + NB * BLOCK + 512, np.uint8)
    span[WINDOW:WINDOW + n] = np.frombuffer(raw, np.uint8)
    m = WINDOW + BLOCK + 512
    idx = np.arange(NB)[:, None] * BLOCK + np.arange(m)[None, :]
    words = jmf.words_at(jnp.asarray(span[idx].astype(np.int32)))
    span_off = jnp.asarray((np.arange(NB) * BLOCK).astype(np.int32))
    block_len = np.minimum(n - np.arange(NB) * BLOCK, BLOCK).astype(np.int32)
    pk1, pk2, cap_at = jmf.suffix_screen_w(
        words, span_off, jnp.int32(n), r, WINDOW, BLOCK, 258, screen_bytes,
        RESTART)
    sl = slice(WINDOW, WINDOW + BLOCK)
    jargs = (pk1[:, sl], pk2[:, sl], cap_at[:, sl],
             jax.lax.bitcast_convert_type(words, jnp.int32),
             jnp.asarray(block_len)[:, None])
    targs = tuple(torch.from_numpy(np.array(x)) for x in jargs[:4]) + (
        torch.from_numpy(block_len),)
    return words, span_off, n, block_len, jargs, targs


def _assert_live_equal(ref, got, block_len, what):
    live = np.arange(BLOCK)[None, :] < block_len[:, None]
    for name, x, y in zip(("visited", "mlen", "mdist"), ref, got):
        np.testing.assert_array_equal(np.asarray(y)[live], np.asarray(x)[live],
                                      err_msg=f"{what}: {name}")


@pytest.mark.parametrize("lazy", [False, True])
def test_v3_marks_match_reference(lazy):
    _, _, _, block_len, jargs, targs = _inputs("mixed")
    ref = jparse._v3_marks(*jargs[:3], jargs[4], WINDOW, 258, 16, 4096,
                           lazy, 258)
    got = tparse._v3_marks(*targs[:3], targs[4], WINDOW, 258, 16, 4096,
                           lazy, 258)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["mixed", "repetitive", "source"])
@pytest.mark.parametrize("lazy", [False, True])
def test_plain_walk_matches_v3z(kind, lazy):
    """n_extend=1 equals the reference walk, ungrouped and grouped (the
    group of 2 also leaves a ragged last group)."""
    _, _, _, block_len, jargs, targs = _inputs(kind)
    ref = jparse.parse_extend_v3z(*jargs, WINDOW, 258, 16, lazy=lazy,
                                  restart=RESTART)
    for group in (16, 2):
        got = tparse.parse_extend_v3z(*targs, WINDOW, 258, 16, 4096, lazy,
                                      258, RESTART, n_extend=1, group=group)
        _assert_live_equal(ref, got, block_len, f"group {group}")
    # The wrapper takes the plain version for CPU tensors.
    got = tparse.parse_extend_v3(*targs, WINDOW, 258, 16, 4096, lazy, 258,
                                 RESTART, n_extend=1)
    _assert_live_equal(ref, got, block_len, "wrapper")


@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("kind", ["mixed", "repetitive", "source"])
def test_plain_walk_n_extend2_matches_oracle_path(kind, level):
    """n_extend=2 tokens equal find_matches_v3 + greedy_parse, the
    reference path that is token-identical to the C++ oracle."""
    r = 4 if level <= 3 else (8 if level <= 6 else 32)
    sb = 32 if level >= 7 else 16
    lazy = level >= 4
    words, span_off, n, block_len, _, targs = _inputs(kind, r, sb)
    mlen, mdist = jmf.find_matches_v3(
        words, span_off, jnp.int32(n), r, WINDOW, BLOCK, 258, sb, lazy=lazy,
        restart=RESTART)
    is_token, _, _ = jparse.greedy_parse(mlen, mdist,
                                         jnp.asarray(block_len))
    is_token = np.asarray(is_token)
    mlen = np.where(is_token, np.asarray(mlen), 0)
    mdist = np.where(is_token & (mlen > 0), np.asarray(mdist), 0)
    ref = (np.where(is_token, mlen + 1, 0), mlen, mdist)
    got = tparse.parse_extend_v3(*targs, WINDOW, 258, sb, 4096, lazy, 258,
                                 RESTART, n_extend=2)
    _assert_live_equal(ref, got, block_len, f"level {level}")
    if kind != "mixed":
        # Saturated tokens went through extension past the screen.
        assert int(got[1].max()) > sb


def test_n_extend2_uses_second_candidate():
    """On this source-code input some tokens take the second candidate,
    so the two settings differ; the oracle-path test above holds the
    n_extend=2 result on the same input."""
    _, _, _, block_len, _, targs = _inputs("source")
    one = tparse.parse_extend_v3z(*targs, WINDOW, 258, 16, 4096, False, 258,
                                  RESTART, n_extend=1)
    two = tparse.parse_extend_v3z(*targs, WINDOW, 258, 16, 4096, False, 258,
                                  RESTART, n_extend=2)
    assert any(not torch.equal(a, b) for a, b in zip(one, two))
