"""bzip2's RLE1 encode in the port (`rle.rle1_encode`) held exactly equal
to JAX's `rle1_encode` on the same rows, and its units to the C++
oracle's `bzip2_rle1`; and the run-report port (`utils.metrics`) against
the reference's. Every row of a case family shares one batch (padded past
its length with garbage, which must be ignored), so JAX compiles once a
family."""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpz.kernels.rle import rle1_encode as jrle1_encode
from tpz.utils import metrics as jmetrics
from tpz_torch import oracle
from tpz_torch.kernels.rle import rle1_encode
from tpz_torch.utils import corpus, metrics

RUNS = (0, 1, 3, 4, 5, 259, 260, 263, 600)


def _rows():
    """name -> bytes: the inputs of tests/test_mtf_rle.py (every
    corpus.edge_cases() entry and the 1,000-byte run), a lone run and a
    run between other bytes at each length of RUNS."""
    rows = dict(corpus.edge_cases())
    rows["z_1000"] = b"z" * 1000
    for n in RUNS:
        rows[f"run_{n}"] = b"a" * n
        rows[f"inner_run_{n}"] = b"xy" + b"a" * n + b"bc"
    rows["two_runs"] = b"q" * 263 + b"r" * 4 + b"q" * 5
    return rows


ROWS = _rows()


@pytest.fixture(scope="module")
def encoded():
    """(port, JAX) results per row name: [(bytes, out_len)]."""
    names = list(ROWS)
    n = max(len(ROWS[k]) for k in names) + 7
    rng = np.random.default_rng(3)
    d = rng.integers(0, 256, size=(len(names), n)).astype(np.int32)
    for i, k in enumerate(names):
        d[i, :len(ROWS[k])] = np.frombuffer(ROWS[k], np.uint8)
    length = np.array([len(ROWS[k]) for k in names], np.int32)
    out, out_len = rle1_encode(torch.from_numpy(d), torch.from_numpy(length))
    jout, jlen = jrle1_encode(jnp.asarray(d), jnp.asarray(length))
    return {k: ((out[i].numpy(), int(out_len[i])),
                (np.asarray(jout)[i], int(jlen[i])))
            for i, k in enumerate(names)}


@pytest.mark.parametrize("name", list(ROWS))
def test_rle1_equals_jax_and_the_oracle(encoded, name):
    (out, n), (jout, jn) = encoded[name]
    assert out.shape == jout.shape
    assert n == jn
    np.testing.assert_array_equal(out, jout)
    got = out[:n].astype(np.uint8).tobytes()
    data = ROWS[name]
    if data:
        rle, off, ln, _ = oracle.bzip2_rle1(data, 9)
        assert off.size == 1
        assert got == rle[:ln[0]].tobytes()
    else:
        assert got == b""


def test_rle1_shape_and_padding_rows():
    """Rows of length 0 and rows cut short inside a run: the output is
    [NB, n + n // 4 + 8], zero past each row's count, equal to JAX's."""
    d = np.full((3, 40), 7, np.int32)
    length = np.array([0, 21, 40], np.int32)
    out, out_len = rle1_encode(torch.from_numpy(d), torch.from_numpy(length))
    jout, jlen = jrle1_encode(jnp.asarray(d), jnp.asarray(length))
    assert tuple(out.shape) == (3, 40 + 10 + 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(jlen))
    assert out_len.tolist() == [0, 5, 5]
    assert not out[0].any() and not out[1, 5:].any()


def test_metrics_equal_the_reference():
    data = corpus.text(10_000)
    r = metrics.measure("gzip", gzip.compress, data, device="cpu")
    jr = jmetrics.measure("gzip", gzip.compress, data, backend="cpu")
    assert r.backend == "cpu" and r.ratio == jr.ratio < 1.0
    assert r.bytes_out == jr.bytes_out and r.gbps > 0
    for rep in (r, jr):
        rep.seconds, rep.stages = 0.5, {"encode": 0.25}
    assert r.to_json() == jr.to_json()
    with metrics.timed_stage(r, "frame"):
        pass
    assert set(r.stages) == {"encode", "frame"}
    assert metrics.scaling_efficiency(10.0, 5.5, 2) == \
        jmetrics.scaling_efficiency(10.0, 5.5, 2) == pytest.approx(0.909, 0.01)
    assert metrics.scaling_efficiency(1.0, 0.0, 2) == 0.0
