"""The sharded shape in the port (`tpz_torch.parallel.mesh`,
`tpz_torch.parallel.distributed`) held against the reference's
(`tpz.parallel`) on the CPU: the port's `make_mesh(n, device="cpu")`
against JAX's mesh of n of the 8 virtual CPU devices that
tests/conftest.py gives it, on the same inputs from a numpy seed or
corpus. Everything compared is integers or bytes, so the tolerance is
exact equality. JAX's sharded encodes are the dear part: each runs once,
at level 1, in a module fixture. The real two-process job (two spawned
ranks joined by torch.distributed over gloo on 127.0.0.1) is the one
chip_smoke.py's phase 29 runs on the card, here with device "cpu"."""

import bz2
import gzip
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpz.codecs import gzip_codec as jgzip_codec
from tpz.parallel import distributed as jdist
from tpz.parallel import mesh as jmesh
from tpz_torch.kernels.matchfinder import BLOCK
from tpz_torch.parallel import distributed as pdist
from tpz_torch.parallel import mesh as pmesh
from tpz_torch.utils import corpus

SPAN = 64 * 1024
DATA = corpus.mixed(300_000, seed=41)      # 5 spans, the last ragged
SMALL = corpus.mixed(3 * 16 * 1024 - 999, seed=43)   # 3 spans of 16 KiB
SMALL_SPAN = 16 * 1024


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain CPU encoders run many small torch ops, for which
    intra-op threads only add overhead (and contend with the other test
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n):
    return pmesh.make_mesh(n, device="cpu")


# ------------------------------------------------------------------ mesh

def test_make_mesh_on_the_cpu():
    m = cpu_mesh(4)
    assert m.size == 4 and m.axis == "dp"
    assert all(d == torch.device("cpu") for d in m.devices)
    assert pmesh.make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError):
        pmesh.make_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pmesh.make_mesh(4)


@pytest.mark.parametrize("first", [False, True], ids=["zeros", "first_halo"])
def test_halo_rows_equals_jax(first):
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, size=(5, 64)).astype(np.uint8)
    halo = rng.integers(0, 256, size=(1, 16)).astype(np.uint8)
    got = pmesh.halo_rows(torch.from_numpy(base), 16, 8,
                          torch.from_numpy(halo) if first else None)
    want = jmesh.halo_rows(jnp.asarray(base), 16, 8,
                           jnp.asarray(halo) if first else None)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (5, 88)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gather", ["ragged_all_gather", "ring_all_gather"])
@pytest.mark.parametrize("seed", [0, 5])
def test_gathers_equal_jax(gather, seed):
    """Payloads of 0 to CAP bytes (zero sizes included) on 8 shards."""
    rng = np.random.default_rng(seed)
    cap = 192
    sizes = rng.integers(0, cap + 1, size=8).astype(np.int32)
    sizes[[1, 6]] = 0
    sizes[3] = cap
    pay = np.zeros((8, cap), np.uint8)
    for d in range(8):
        pay[d, :sizes[d]] = rng.integers(1, 256, sizes[d], dtype=np.uint8)
    out, total = getattr(pmesh, gather)(cpu_mesh(8), torch.from_numpy(pay),
                                        torch.from_numpy(sizes))
    jout, jtotal = getattr(jmesh, gather)(jmesh.make_mesh(8),
                                          jnp.asarray(pay),
                                          jnp.asarray(sizes))
    assert int(total) == int(jtotal) == int(sizes.sum())
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    expect = b"".join(pay[d, :sizes[d]].tobytes() for d in range(8))
    assert out.numpy()[:len(expect)].tobytes() == expect


def test_sharded_encode_step_equals_jax():
    """The reference's shape (tests/test_parallel.py): 16 blocks of 1,024
    bytes of corpus.mixed on 8 shards, window 512, k 4."""
    nb = 16
    data = np.frombuffer(corpus.mixed(nb * 1024), np.uint8).reshape(nb, 1024)
    span_off = (np.arange(nb) * 1024).astype(np.int32)
    got = pmesh.sharded_encode_step(cpu_mesh(8), k=4, window=512,
                                    block=1024)(
        torch.from_numpy(data.copy()), torch.from_numpy(span_off),
        nb * 1024)
    want = jmesh.sharded_encode_step(jmesh.make_mesh(8), k=4, window=512,
                                     block=1024)(
        jnp.asarray(data), jnp.asarray(span_off), jnp.int32(nb * 1024))
    for g, w, name in zip(got, want, ("mlen", "mdist", "is_token",
                                      "counts")):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy().astype(w.dtype), w,
                                      err_msg=name)
    assert (got[3] > 0).all()


# -------------------------------------------------------- sharded encodes

GZ_N = 2 * BLOCK + 23_456   # 3 blocks on 4 shards: one shard empty


@pytest.fixture(scope="module")
def gzip_pair():
    data = corpus.mixed(GZ_N, seed=7)
    return (data, pmesh.sharded_compress(data, cpu_mesh(4), level=1),
            jmesh.sharded_compress(data, jmesh.make_mesh(4), level=1))


def test_sharded_compress_equals_jax(gzip_pair):
    data, got, want = gzip_pair
    assert got == want
    assert gzip.decompress(got) == data
    # The reference's identity: one member per nonempty shard's span.
    spans = [data[i * BLOCK:(i + 1) * BLOCK] for i in range(4)]
    assert got == b"".join(jgzip_codec.compress(s, level=1, backend="oracle")
                           for s in spans if s)


def test_sharded_compress_one_shard_and_empty():
    data = corpus.text(5000)
    out = pmesh.sharded_compress(data, cpu_mesh(4), level=1)
    assert out == jgzip_codec.compress(data, level=1, backend="oracle")
    assert gzip.decompress(out) == data
    empty = pmesh.sharded_compress(b"", cpu_mesh(4), level=1)
    assert empty == jmesh.sharded_compress(b"", jmesh.make_mesh(4), level=1)
    assert gzip.decompress(empty) == b""


def test_sharded_compress_bzip2_is_mesh_size_invariant():
    """Level 1 (100 k blocks): 3 blocks on 4 shards, and on 1."""
    data = bytes(corpus.mixed(250_000, seed=17))
    four = pmesh.sharded_compress_bzip2(data, cpu_mesh(4), level=1)
    one = pmesh.sharded_compress_bzip2(data, cpu_mesh(1), level=1)
    want = jmesh.sharded_compress_bzip2(data, jmesh.make_mesh(4), level=1)
    assert four == one == want
    assert bz2.decompress(four) == data
    assert four.count(b"BZh1") >= 3
    assert pmesh.sharded_compress_bzip2(b"", cpu_mesh(4), 1) == \
        bz2.compress(b"", 1)


# ------------------------------------------------------------ distributed

def _reference(data, fmt, span_bytes, tmp_path, level=1):
    wd = tmp_path / f"ref-{fmt}"
    wd.mkdir(exist_ok=True)
    return jdist.compress_sharded(data, fmt, level, span_bytes=span_bytes,
                                  work_dir=str(wd), backend="oracle")


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The port's one-process runs of DATA (gzip and bzip2 at the default
    level, as the two-process job's, 64 KiB spans, each in its own work
    dir) and the reference's."""
    out = {}
    for fmt in ("gzip", "bzip2"):
        tmp = tmp_path_factory.mktemp(fmt)
        (tmp / "port").mkdir()
        got = pdist.compress_sharded(DATA, fmt, device="cpu",
                                     span_bytes=SPAN,
                                     work_dir=str(tmp / "port"))
        want = _reference(DATA, fmt, SPAN, tmp, level=6)
        out[fmt] = (got, want, tmp)
    return out


@pytest.mark.parametrize("fmt", ["gzip", "bzip2"])
def test_compress_sharded_equals_the_reference(one_process, fmt):
    got, want, tmp = one_process[fmt]
    assert got == want
    assert (gzip.decompress if fmt == "gzip" else bz2.decompress)(got) == DATA
    with open(tmp / "port" / "manifest.json") as f:
        manifest = json.load(f)
    with open(tmp / f"ref-{fmt}" / "manifest.json") as f:
        assert manifest == json.load(f)
    assert sorted(manifest) == [str(i) for i in range(5)]
    for i, off, ln in pdist.spans_for(len(DATA), SPAN):
        meta = manifest[str(i)]
        assert (meta["index"], meta["offset"], meta["length"]) == (i, off, ln)
        blob = (tmp / "port" / f"span_{i}.bin").read_bytes()
        assert blob == (tmp / f"ref-{fmt}" / f"span_{i}.bin").read_bytes()
        assert meta["out_size"] == len(blob)


@pytest.fixture
def spy(monkeypatch):
    """The span lengths of every compress_many call the port makes."""
    calls = []
    real = pdist.api.compress_many

    def record(datas, *a, **kw):
        calls.append([len(d) for d in datas])
        return real(datas, *a, **kw)

    monkeypatch.setattr(pdist.api, "compress_many", record)
    return calls


def test_fail_spans_and_resume(tmp_path, spy):
    """The reference's test_fault_injection_and_resume, on bzip2 too."""
    want = _reference(SMALL, "bzip2", SMALL_SPAN, tmp_path)
    kw = dict(level=1, device="cpu", span_bytes=SMALL_SPAN,
              work_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="span 1 incomplete"):
        pdist.compress_sharded(SMALL, "bzip2", fail_spans={1}, **kw)
    assert pdist.compress_sharded(SMALL, "bzip2", **kw) == want
    assert spy == [[SMALL_SPAN, len(SMALL) - 2 * SMALL_SPAN], [SMALL_SPAN]]


def test_resume_from_the_references_work_dir(tmp_path, spy):
    """The reference half-fills a work dir (span 1 fails); the port
    resumes from its manifest and span files, encoding span 1 alone."""
    want = _reference(SMALL, "gzip", SMALL_SPAN, tmp_path)
    with pytest.raises(RuntimeError, match="span 1 incomplete"):
        jdist.compress_sharded(SMALL, "gzip", level=1,
                               span_bytes=SMALL_SPAN, work_dir=str(tmp_path),
                               backend="oracle", fail_spans={1})
    assert pdist.compress_sharded(SMALL, "gzip", level=1, device="cpu",
                                  span_bytes=SMALL_SPAN,
                                  work_dir=str(tmp_path)) == want
    assert spy == [[SMALL_SPAN]]


def test_two_hosts_in_one_process(tmp_path):
    """Process 1 writes its spans, then process 0 encodes its own and
    assembles (the reference's test_multi_process_simulation)."""
    kw = dict(level=1, device="cpu", span_bytes=SMALL_SPAN,
              work_dir=str(tmp_path), process_count=2)
    assert pdist.compress_sharded(SMALL, "bzip2", process_index=1,
                                  **kw) is None
    got = pdist.compress_sharded(SMALL, "bzip2", process_index=0, **kw)
    assert got == _reference(SMALL, "bzip2", SMALL_SPAN, tmp_path)
    assert bz2.decompress(got) == SMALL


def test_rejections_and_no_group():
    with pytest.raises(ValueError, match="concatenable"):
        pdist.compress_sharded(b"x" * 100, "zlib", device="cpu")
    with pytest.raises(ValueError, match="work_dir"):
        pdist.compress_sharded(b"x" * 100, "gzip", device="cpu",
                               process_index=1, process_count=2)
    assert pdist.init_distributed() == (0, 1)
    assert pdist.spans_for(0) == jdist.spans_for(0) == [(0, 0, 0)]
    assert pdist.spans_for(5, 2) == jdist.spans_for(5, 2)


def test_two_process_gloo_job(one_process, tmp_path):
    """Two spawned ranks joined by torch.distributed (gloo, 127.0.0.1):
    rank 1 writes spans 1 and 3, both meet at a barrier, rank 0 encodes
    spans 0, 2 and 4 and assembles; the bytes equal the one-process
    run's."""
    out, _ = chip_smoke.two_process_job(DATA, str(tmp_path), SPAN, "cpu",
                                        ("gzip", "bzip2"), timeout=120)
    for fmt in ("gzip", "bzip2"):
        assert out[fmt] == one_process[fmt][0]
        with open(tmp_path / fmt / "manifest.json") as f:
            assert sorted(json.load(f)) == [str(i) for i in range(5)]
        assert sorted(os.listdir(tmp_path / fmt)) == sorted(
            ["manifest.json"] + [f"span_{i}.bin" for i in range(5)])
