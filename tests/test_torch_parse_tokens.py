"""The v3 parse walk's kernel design (tpz_torch/csrc/parse_walk.cu) held
against the plain walk and the JAX package on the CPU.

`parse_extend_v3_tokens_plain` is the kernel's torch twin: the token the
walk would emit at every position (`v3_tokens`: the mark, the extension
of candidates 1 and 2, the lazy probe at p + 1), then each restart
sub-walk's chunk walks from guessed starts put in order (`chunk_walks`,
the twin of csrc/chunk_walk.cuh). Its outputs must equal
`parse_extend_v3z`'s at every position, and JAX's `parse_extend_v3z` (the
reference walk, which never loads candidate 2: n_extend=1), on mixed,
repetitive and source inputs, levels 1, 6 and 9, restart 256 and 0
(one walk a block), chunk counts 1, 4 and 32 (32 alone at n_extend=1),
and block lengths of 0, 1
and lengths that are not a multiple of the restart. The outputs are
integers: the tolerance is exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parse import BLOCK, RESTART, WINDOW, _inputs
from tpz.kernels import parse as jparse
from tpz_torch.kernels import _build
from tpz_torch.kernels import parse as tparse

CHUNKS = (1, 4, 32)


def _level(level):
    """(max_chain, screen_bytes, lazy) of a gzip level (DeflateConfig)."""
    return (4 if level <= 3 else (8 if level <= 6 else 32),
            32 if level >= 7 else 16, level >= 4)


def _check(jargs, targs, sb, lazy, restart, what):
    want1 = jparse.parse_extend_v3z(*jargs, WINDOW, 258, sb, lazy=lazy,
                                    restart=restart)
    for n_extend in (1, 2):
        plain = tparse.parse_extend_v3z(*targs, WINDOW, 258, sb, 4096, lazy,
                                        258, restart, n_extend)
        if n_extend == 1:
            for name, x, y in zip(("visited", "mlen", "mdist"), plain,
                                  want1):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                              err_msg=f"{what}: plain {name}")
        for chunks in CHUNKS if n_extend == 2 else CHUNKS[-1:]:
            got = tparse.parse_extend_v3_tokens_plain(
                *targs, WINDOW, 258, sb, 4096, lazy, 258, restart, n_extend,
                chunks)
            for name, x, y in zip(("visited", "mlen", "mdist"), got, plain):
                np.testing.assert_array_equal(
                    x.numpy(), y.numpy(),
                    err_msg=f"{what}: n_extend {n_extend}, {chunks} chunks, "
                            f"{name}")


@pytest.mark.parametrize("restart", [RESTART, 0])
@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("kind", ["mixed", "repetitive", "source"])
def test_twin_equals_plain_and_jax(kind, level, restart):
    r, sb, lazy = _level(level)
    _, _, _, block_len, jargs, targs = _inputs(kind, r, sb)
    assert block_len[-1] % RESTART  # the last block ends mid sub-walk
    _check(jargs, targs, sb, lazy, restart, f"{kind} level {level}")


@pytest.mark.parametrize("restart", [RESTART, 0])
@pytest.mark.parametrize("lens", [(0, 1, 924), (1, 0, 301)])
def test_twin_on_short_blocks(lens, restart):
    """Blocks of 0 and 1 positions and ragged ones: no walk reaches past
    its block's length, so those outputs are 0, and the lazy probe is
    gated by p + 1 < block_len."""
    _, sb, lazy = _level(6)
    _, _, _, _, jargs, targs = _inputs("repetitive", 8, sb)
    bl = np.asarray(lens, np.int32)
    jargs = jargs[:4] + (jnp.asarray(bl)[:, None],)
    targs = targs[:4] + (torch.from_numpy(bl),)
    _check(jargs, targs, sb, lazy, restart, f"lengths {lens}")
    got = tparse.parse_extend_v3_tokens_plain(*targs, WINDOW, 258, sb, 4096,
                                              lazy, 258, restart)
    live = np.arange(BLOCK)[None, :] < bl[:, None]
    assert not got[0].numpy()[~live].any()
    assert (got[0].numpy()[bl > 0, 0] > 0).all()


def test_tokens_are_the_walks_marks_where_visited():
    """v3_tokens gives at every visited position the token the serial walk
    emitted there (positions it skips hold tokens no walk emits)."""
    _, sb, lazy = _level(9)
    _, _, _, block_len, _, targs = _inputs("source", 32, sb)
    mark, step = tparse.v3_tokens(*targs, WINDOW, 258, sb, 4096, lazy, 258,
                                  RESTART)
    visited, mlen, mdist = tparse.parse_extend_v3z(
        *targs, WINDOW, 258, sb, 4096, lazy, 258, RESTART)
    at = visited > 0
    np.testing.assert_array_equal((mark & 1023)[at].numpy(),
                                  visited[at].numpy())
    np.testing.assert_array_equal(
        step[at].numpy(), torch.clamp(mlen, min=1)[at].numpy())
    live = torch.arange(BLOCK)[None, :] < torch.from_numpy(block_len)[:, None]
    assert int((step >= 1).all()) and int((step[~live] == 1).all())
    assert int((~at & live).sum()) > 0


def test_chunk_walks_from_wrong_guesses():
    """Chunk walks that start off the true walk: in row 0 they meet it a
    token later (steps of 3 from the multiples of 3, 1 elsewhere); in
    row 1 never (the true walk steps 1 then 2 over the odd positions,
    every guess from an even chunk start 2 over the even ones)."""
    R = 96
    step = torch.ones((2, R), dtype=torch.int32)
    step[0, ::3] = 3
    step[1, 1:] = 2
    n = torch.tensor([R, 90])
    for chunks in CHUNKS:
        vis = tparse.chunk_walks(step, n, chunks)
        for w in range(2):
            want = np.zeros(R, bool)
            p = 0
            while p < int(n[w]):
                want[p] = True
                p += int(step[w, p])
            np.testing.assert_array_equal(vis[w].numpy(), want,
                                          err_msg=f"row {w}, {chunks}")


def test_shared_memory_bound():
    """The kernel holds a sub-walk's 16-bit steps and visited bits in one
    CUDA block: restart 16,384 (the codecs') and 65,536 (restart 0 at
    the gzip block size) fit, 131,072 does not."""
    assert tparse.parse_v3_shared_bytes(16384) == 2 * 16384 + 4 * 512 + 128
    assert tparse.parse_v3_shared_bytes(65536) <= _build.SHARED_LIMIT
    assert tparse.parse_v3_shared_bytes(1 << 17) > _build.SHARED_LIMIT
