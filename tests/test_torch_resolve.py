"""The port's match resolution (tpz_torch/kernels/resolve_walk.py) held
against the JAX package: the plain torch resolve against JAX's
pointer-doubling resolve and its Pallas copy machine (interpret mode),
and the boundary-carry prepass against JAX's. Bytes and markers are
integers: the tolerance is exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpz.kernels import resolve_walk as jrw
from tpz.kernels.inflate_pipeline import _resolve_doubling
from tpz_torch.kernels import resolve_walk as rw

_LIT, _MATCH = 1, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain decode stages run many tiny torch ops, for which intra-op
    threads only add overhead (and contend with the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_markers(rng, n, dist_bias=0, max_dist=4096, max_len=258,
                 p_lit=0.5):
    """Random valid marker stream: every match reaches backward by
    1..max_dist and bytes inside matches are blank (0), exactly as the
    symbol walks emit them (copied from tests/test_resolve_walk.py)."""
    m = np.zeros(n, np.int32)
    pos = 0
    while pos < n:
        if pos == 0 or rng.random() < p_lit:
            m[pos] = (_LIT << 28) | int(rng.integers(0, 256))
            pos += 1
        else:
            ln = min(int(rng.integers(3, max_len + 1)), n - pos)
            d = int(rng.integers(1, min(pos, max_dist) + 1))
            m[pos] = (_MATCH << 28) | ((d - dist_bias) << 9) | ln
            pos += ln
    return m


def overlap_runs(dists=(1, 2, 3, 4, 5, 6, 7), seed=0):
    """Self-overlapping matches (dist < len) of every dist in `dists`,
    each a full 258-byte run, padded to a multiple of 128."""
    rng = np.random.default_rng(seed)
    parts = [np.asarray([(_LIT << 28) | int(rng.integers(0, 256))
                         for _ in range(8)], np.int32)]
    for d in dists:
        run = np.zeros(258, np.int32)
        run[0] = (_MATCH << 28) | (d << 9) | 258
        parts.append(run)
        parts.append(np.asarray([(_LIT << 28) | int(rng.integers(0, 256))
                                 for _ in range(5)], np.int32))
    m = np.concatenate(parts)
    pad = (-len(m)) % 128
    return np.concatenate([m, np.full(pad, _LIT << 28, np.int32)])


def _jax_bytes(m, bias=0):
    return np.asarray(_resolve_doubling(jnp.asarray(m), dist_bias=bias))


@pytest.mark.parametrize("n,bias,max_dist,p_lit", [
    (128 * 2, 0, 100, 0.5),
    (128 * 6, 0, 300, 0.6),
    (1 << 16, 0, 4096, 0.5),
    (3 << 16, 0, 32768, 0.45),
    (1 << 17, 1, 65536, 0.5),      # lzhuf: dist-1 fields, 64 KiB window
    (1 << 17, 0, 32768, 0.15),     # match-heavy: deep overlap chains
])
def test_plain_resolve_matches_jax_doubling(n, bias, max_dist, p_lit):
    m = make_markers(np.random.default_rng(n ^ max_dist), n, bias, max_dist,
                     p_lit=p_lit)
    got = rw.resolve_dense(torch.from_numpy(m), dist_bias=bias)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), _jax_bytes(m, bias))


@pytest.mark.parametrize("bias", [0, 1])
def test_overlap_runs_dist_1_to_7(bias):
    m = overlap_runs()
    if bias:  # the same runs with dist - 1 stored in the field
        mk = (m >> 28) == _MATCH
        m = np.where(mk, m - (1 << 9), m).astype(np.int32)
    got = rw.resolve_dense(torch.from_numpy(m), dist_bias=bias).numpy()
    np.testing.assert_array_equal(got, _jax_bytes(m, bias))
    # A dist-d run repeats the d bytes before it.
    pos = 8
    for d in range(1, 8):
        run = got[pos:pos + 258]
        src = got[pos - d:pos]
        np.testing.assert_array_equal(run, np.resize(src, 258))
        pos += 258 + 5


def test_plain_state_is_fully_resolved_packed_state():
    m = make_markers(np.random.default_rng(3), 1 << 14, max_dist=2000)
    st = rw.resolve_copy_machine(torch.from_numpy(m))
    assert st.dtype == torch.int32
    st = st.numpy().view(np.uint32)
    np.testing.assert_array_equal(st >> 8, np.arange(1 << 14))
    np.testing.assert_array_equal(st & 0xFF, _jax_bytes(m))


@pytest.mark.parametrize("n,bias,max_dist", [
    (5 * (1 << 14) + 384, 0, 4096),
    (4 * (1 << 14), 1, 4096),
])
def test_halo_chain_matches_jax_doubling(monkeypatch, n, bias, max_dist):
    """Spans above PHASE2_CAP resolve chunk by chunk through the halo;
    with the cap shrunk, a few chunks run on this CPU."""
    monkeypatch.setattr(rw, "PHASE2_CAP", 1 << 14)
    monkeypatch.setattr(rw, "HALO", 4096)
    m = make_markers(np.random.default_rng(n), n, bias, max_dist, p_lit=0.3)
    got = rw.resolve_dense(torch.from_numpy(m), dist_bias=bias)
    np.testing.assert_array_equal(got.numpy(), _jax_bytes(m, bias))


@pytest.mark.parametrize("step", [128, 512, 1 << 12, 1 << 20])
def test_inject_boundary_carries_matches_jax(step):
    m = make_markers(np.random.default_rng(step), 1 << 15, max_dist=1000,
                     p_lit=0.2)
    want = np.asarray(jrw._inject_boundary_carries(jnp.asarray(m), step))
    got = rw._inject_boundary_carries(torch.from_numpy(m), step)
    np.testing.assert_array_equal(got.numpy(), want)
    if step < len(m):
        assert (got.numpy() != m).any()  # some match crossed a cut


@pytest.mark.parametrize("kind", ["len-511", "garbage"])
def test_inject_boundary_carries_window_matches_jax(kind):
    """The port looks only at the 512 positions before each cut; JAX
    takes a cummax over the whole span. Matches as long as the len field
    allows, and arbitrary words, give the same markers."""
    rng = np.random.default_rng(17)
    if kind == "len-511":
        m = make_markers(rng, 1 << 14, max_dist=1000, max_len=511, p_lit=0.1)
    else:
        m = rng.integers(-(1 << 31), 1 << 31, 1 << 14).astype(np.int32)
        m[rng.random(m.shape[0]) < 0.3] = 0
    for step in (200, 511, 512, 4096):
        want = np.asarray(jrw._inject_boundary_carries(jnp.asarray(m), step))
        got = rw._inject_boundary_carries(torch.from_numpy(m), step)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(step))


@pytest.mark.parametrize("n", [256, 768])
def test_plain_resolve_matches_jax_copy_machine(n):
    m = make_markers(np.random.default_rng(n + 1), n, 0, 200, p_lit=0.4)
    want = np.asarray(jrw.resolve_dense(jnp.asarray(m), interpret=True))
    got = rw.resolve_dense(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, want)


def test_copy_machine_rejects_unsupported_device():
    with pytest.raises(ValueError, match="device"):
        rw.resolve_copy_machine(torch.zeros(128, dtype=torch.int32,
                                            device="meta"))
