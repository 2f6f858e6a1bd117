"""The segmented decomposition of the port's two MTF kernels, held
against the plain versions and the JAX package on the CPU.

bzip2 decode (tpz_torch/kernels/bzip2_walk.py): the records pass's torch
twin (the walk without the MTF list, records count << 8 | rank) followed
by the twin of the segmented MTF^-1 (B1 labels, B2 lists, B3 bytes) gives
the records and meta of bzip2_walk_plain and of JAX's Pallas walk
_walk_call in interpret mode, on every stream of test_torch_bzip2_walk's
WALK_CASES, at segments of 1, 3, 64 and S records, and with a record cap
S that stops the walk on a literal's trip and on the held trip after a
run flush. MTF encode (tpz_torch/kernels/mtf.py): the twin of E1-E3
gives mtf_ranks_plain's ranks and JAX's mtf_ranks at alpha 256 and 6, at
segments of 1, 5, 2048 and n + 1 symbols. Everything compared is an
integer, so the tolerance is exact equality."""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bzip2_walk import WALK_CASES, _walked
from tpz.kernels import bzip2_walk as jbw
from tpz.kernels import mtf as jmtf
from tpz_torch.kernels import _build, bzip2_walk as bw, ibwt_walk
from tpz_torch.kernels import inflate_pipeline, lzhuf_walk, mtf, parse
from tpz_torch.kernels import resolve_walk


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The walks run many tiny torch ops, for which intra-op threads only
    add overhead (and contend with the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(L):
    return [torch.from_numpy(L[k]) for k in bw.WALK_ARGS]


def _jax_walk(L, S):
    recs, meta = jbw._walk_call(
        *(jnp.asarray(L[k].astype(np.int32)) for k in bw.WALK_ARGS), S=S,
        interpret=True)
    return np.asarray(recs).reshape(len(L["nsel"]), S), np.asarray(meta)


@functools.lru_cache(maxsize=None)
def _twin_and_jax(name):
    """(the records twin's (recs, meta), JAX's (recs, meta)) of a case at
    its own S, each walked once per test process."""
    _, _, L, _, S, _ = _walked(name)
    return bw.bzip2_records_plain(*_args(L)[:6], S), _jax_walk(L, S)


def _assert_walk_equal(recs, meta, want, jwant):
    """recs and meta equal the plain walk's everywhere, and JAX's up to
    each block's record count."""
    np.testing.assert_array_equal(recs.numpy(), want[0].numpy())
    np.testing.assert_array_equal(meta.numpy(), want[1].numpy())
    jrecs, jmeta = jwant
    np.testing.assert_array_equal(meta.numpy(), jmeta[:, :bw.META_WIDTH])
    for b, n in enumerate(meta[:, 0].tolist()):
        np.testing.assert_array_equal(recs[b, :n].numpy(), jrecs[b, :n])


@pytest.mark.parametrize("seg", [1, 3, 64, "S"])
@pytest.mark.parametrize("name", list(WALK_CASES))
def test_records_then_segmented_mtf_inverse_equal_the_walk(name, seg):
    """The records pass, then the MTF^-1 in segments, gives the records
    and meta of the plain walk and of JAX's walk, corrupt bits included
    (corrupt-symbols: err 8, with its records before the error)."""
    _, _, L, _, S, want = _walked(name)
    (rrecs, rmeta), jwant = _twin_and_jax(name)
    recs = bw.mtf_decode_segments_plain(rrecs, rmeta, _args(L)[6],
                                        S if seg == "S" else seg)
    _assert_walk_equal(recs, rmeta, want, jwant)


def test_records_pass_writes_ranks():
    """The records pass keeps the walk's counts; a run (every record of
    count above 1, and some of count 1) has rank 0, a literal (count 1)
    its rank s - 1 >= 1."""
    _, _, L, _, S, (recs, meta) = _walked("stdlib-l1-repetitive")
    (rrecs, rmeta), _ = _twin_and_jax("stdlib-l1-repetitive")
    live = torch.arange(S)[None, :] < rmeta[:, :1]
    np.testing.assert_array_equal((rrecs >> 8).numpy(), (recs >> 8).numpy())
    count, rank = rrecs >> 8, rrecs & 255
    assert bool((rank[live & (count > 1)] == 0).all())
    assert bool((count[live & (rank > 0)] == 1).all())
    assert 0 < int((live & (rank == 0)).sum()) < int(live.sum())
    assert not bool(rrecs[~live].any())


@pytest.mark.parametrize("trip", ["literal", "held"])
def test_record_cap_on_a_literal_and_on_the_held_trip(trip):
    """A record cap S (a multiple of 128, as JAX's walk takes) whose
    record S - 3 is a literal stops the walk on the next symbol's trip; one
    whose record S - 3 is a flushed run stops it on the held trip, with
    the bit position already past the symbol that flushed the run. Both
    stamp err 16 with (bitpos + 1) << 10 and keep S - 2 records, and the
    twins equal the plain walk and JAX's there."""
    _, _, L, _, S, _ = _walked("stdlib-l1-text")
    (rrecs, rmeta), _ = _twin_and_jax("stdlib-l1-text")
    n = int(rmeta[0, 0])
    rank = (rrecs[0, :n] & 255).numpy()
    at = [i for i in range(125, n - 1, 128)
          if (rank[i] == 0) == (trip == "held")]
    assert at, "no record of that kind at a cap the JAX walk takes"
    cap = at[0] + 3
    args = _args(L)
    want = bw.bzip2_walk_plain(*args, cap)
    assert int(want[1][0, 0]) == cap - 2
    assert int(want[1][0, 1]) & 1023 == 16
    assert int(want[1][0, 1]) >> 10 == int(want[1][0, 2]) + 1
    # The walk at its own S had gone on past this point.
    assert int(want[1][0, 2]) < int(rmeta[0, 2])
    recs, meta = bw.bzip2_records_plain(*args[:6], cap)
    assert (int(recs[0, cap - 3]) & 255 == 0) == (trip == "held")
    for seg in (1, 64):
        _assert_walk_equal(bw.mtf_decode_segments_plain(recs, meta, args[6],
                                                        seg),
                           meta, want, _jax_walk(L, cap))


def test_walk_wrapper_takes_the_plain_walk_on_the_cpu():
    """On CPU tensors the wrapper returns the plain walk whatever the
    segment length, and launches nothing."""
    _, _, L, _, S, (recs, meta) = _walked("two-streams-l1")
    before = bw.bzip2_walk.launches
    got, gmeta = bw.bzip2_walk(*_args(L), S, mtf_seg=7)
    assert torch.equal(got, recs) and torch.equal(gmeta, meta)
    assert bw.bzip2_walk.launches == before


# ------------------------------------------------------------ MTF encode

N_ENC = 10240


def _encode_inputs(alpha):
    """Rows of unequal length (one of length 0), symbols first seen late,
    and range(alpha) repeated (for alpha 256, bytes(range(256)) * 40)."""
    rng = np.random.default_rng(71 + alpha)
    v = np.zeros((4, N_ENC), np.int32)
    v[0] = np.arange(N_ENC) % alpha
    v[1] = rng.integers(0, alpha, N_ENC)
    # Two symbols for 6,000 positions, then a new symbol every 16.
    v[2, :6000] = rng.integers(0, 2, 6000)
    late = np.minimum(2 + (np.arange(N_ENC - 6000) // 16), alpha - 1)
    v[2, 6000:] = np.where(rng.random(N_ENC - 6000) < 0.5, late,
                           rng.integers(0, 2, N_ENC - 6000))
    v[3] = np.repeat(rng.integers(0, alpha, N_ENC // 40 + 1), 40)[:N_ENC]
    length = np.array([N_ENC, 0, 8191, 4097], np.int32)
    return v, length


@functools.lru_cache(maxsize=None)
def _encode_wants(alpha):
    v, length = _encode_inputs(alpha)
    plain = mtf.mtf_ranks_plain(torch.from_numpy(v), torch.from_numpy(length),
                                alpha).numpy()
    jax_ranks = np.asarray(jmtf.mtf_ranks(jnp.asarray(v), jnp.asarray(length),
                                          alpha=alpha))
    return plain, jax_ranks


@pytest.mark.parametrize("seg", [1, 5, 2048, "n+1"])
@pytest.mark.parametrize("alpha", [256, 6])
def test_segmented_mtf_encode_equals_plain_and_jax(alpha, seg):
    v, length = _encode_inputs(alpha)
    plain, jax_ranks = _encode_wants(alpha)
    got = mtf.mtf_ranks_segments_plain(
        torch.from_numpy(v), torch.from_numpy(length), alpha,
        N_ENC + 1 if seg == "n+1" else seg).numpy()
    np.testing.assert_array_equal(got, plain)
    live = np.arange(N_ENC)[None, :] < length[:, None]
    np.testing.assert_array_equal(got[live], jax_ranks[live])
    assert not got[~live].any()
    if alpha == 256:
        # bytes(range(256)) * 40: every symbol at rank 255 after the first
        # 256, which see each one first.
        assert (got[0, 256:] == 255).all()
        assert (got[0, :256] == np.arange(256)).all()


# ------------------------------------------------- the kernels' sources


def test_each_wrappers_kernels_are_kernels_of_its_sources():
    """Every name a wrapper lists in `.kernels` (which chip_smoke.py
    looks for in a profiler trace) is a __global__ function of csrc/, and
    the build key covers the headers the sources include."""
    sources, headers = _build.build_inputs()
    declared = set()
    for path in sources:
        with open(path) as f:
            declared |= set(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                r"(\w+)\s*\(", f.read()))
    wrappers = (bw.bzip2_walk, mtf.mtf_ranks, ibwt_walk.ibwt,
                inflate_pipeline.symbol_walk, lzhuf_walk.lzhuf_walk,
                resolve_walk.resolve_copy_machine, parse.parse_extend_v3,
                parse.parse_extend_v1, parse.parse_extend_v3w,
                parse.reach_walk)
    listed = [k for w in wrappers for k in w.kernels]
    assert sorted(listed) == sorted(declared)
    assert any(h.endswith("mtf_list.cuh") for h in headers)
    for path in sources:
        with open(path) as f:
            for inc in re.findall(r'#include "([^"]+)"', f.read()):
                assert any(h.endswith("/" + inc) for h in headers), inc
