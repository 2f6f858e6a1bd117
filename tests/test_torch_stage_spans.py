"""The stage spans of the port's pipelines on the CPU: every stage hook
is called at the points, with the names and in the order it was before
the stages became spans (the lists below were written down from the
pipelines before that change); under torch.profiler the api entries
emit their codec's spans nested under the api span; a request of stock
gzip streams decodes in one device batch for all its streams."""

import bz2
import functools
import gzip

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpz_torch import api, oracle
from tpz_torch.codecs import gzip_codec
from tpz_torch.codecs.deflate import DeflateConfig
from tpz_torch.kernels import (bzip2_pipeline, deflate_pipeline,
                               lzhuf_pipeline, lzhuf_walk)
from tpz_torch.utils import corpus

A = corpus.source_code(3000, seed=1)
B = corpus.text(2000, seed=2)
INFLATE = ["scan", "h2d", "walk", "materialize", "resolve", "fetch", "crc"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain stages run many tiny torch ops, for which intra-op
    threads only add overhead (and contend with the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def tz_member():
    """A's gzip member with the TZ index, from the port's encoder."""
    body, bits, lens = deflate_pipeline.compress_indexed(A, DeflateConfig(6),
                                                         "cpu")
    return (gzip_codec.header_bytes(6, 0, gzip_codec._tz_extra(bits, lens))
            + body + gzip_codec._trailer(A))


PIPELINES = {
    "deflate encode": (
        lambda hook: deflate_pipeline.compress_many(
            [A, B], DeflateConfig(6), "cpu", stage_hook=hook),
        ["words", "screen", "parse", "plan", "bitpack", "fetch"]),
    "inflate indexed": (
        lambda hook: gzip_codec.decompress_many(
            [tz_member()], device="cpu", stage_hook=hook),
        INFLATE),
    "inflate segmented": (
        lambda hook: gzip_codec.decompress_many(
            [gzip.compress(A), gzip.compress(B)], device="cpu",
            stage_hook=hook),
        INFLATE),
    "bzip2 encode": (
        lambda hook: bzip2_pipeline.compress_many([A, B], 9, "cpu",
                                                  stage_hook=hook),
        ["rle1", "words", "bwt", "mtf", "rle2", "plan", "pack", "fetch",
         "frame"]),
    "bzip2 decode": (
        lambda hook: bzip2_pipeline.decompress_many(
            [bz2.compress(A[:300], 1), bz2.compress(B[:200], 1)], "cpu",
            stage_hook=hook),
        ["scan", "slices", "h2d", "walk", "expand", "sort", "ibwt", "fetch",
         "eos", "rle1-inverse", "eos", "rle1-inverse"]),
    "lzhuf encode": (
        lambda hook: lzhuf_pipeline.compress_many([A, B], "lh5", "cpu",
                                                  stage_hook=hook),
        ["blocks", "screen", "parse", "hist", "plan", "pack", "fetch",
         "merge"]),
    "lzhuf decode": (
        lambda hook: lzhuf_walk.decompress_many(
            [(oracle.lzhuf_encode(A[:1500]), 1500),
             (oracle.lzhuf_encode(B[:1000]), 1000)], 13, "cpu",
            stage_hook=hook),
        ["index", "tables", "layout", "h2d", "walk", "materialize",
         "resolve", "fetch"]),
}


@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_the_stage_hooks_see_the_same_sequence(pipeline):
    run, want = PIPELINES[pipeline]
    names = []
    run(names.append)
    assert names == want


def _spans(fn):
    """(result, [(name less tpz_torch., start ns, end ns)] by start, the
    outer of two spans that start together first)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name()[len("tpz_torch."):], e.start_ns(),
                     e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("tpz_torch.")),
                   key=lambda s: (s[1], s[1] - s[2]))
    return out, spans


API_SPANS = {
    "gzip encode": (
        lambda: api.compress_many([A, B], "gzip", 6, device="cpu"),
        ["api.compress_many", "deflate.words", "deflate.layout",
         "deflate.h2d", "deflate.words", "deflate.screen", "deflate.parse",
         "deflate.plan", "deflate.bitpack", "deflate.fetch", "gzip.frame"]),
    "gzip decode": (
        lambda: api.decompress_many([gzip.compress(A), gzip.compress(B)],
                                    "gzip", device="cpu"),
        ["api.decompress_many", "inflate.index", "inflate.scan",
         "inflate.batch", "inflate.scan", "inflate.h2d", "inflate.walk",
         "inflate.materialize", "inflate.resolve", "inflate.fetch",
         "gzip.crc"]),
    "bzip2 encode": (
        lambda: api.compress_many([A, B], "bzip2", 9, device="cpu"),
        ["api.compress_many", "bzip2.rle1", "bzip2.words", "bzip2.words",
         "bzip2.words", "bzip2.bwt", "bzip2.mtf", "bzip2.rle2", "bzip2.plan",
         "bzip2.pack", "bzip2.fetch", "bzip2.frame", "bzip2.frame"]),
    "bzip2 decode": (
        lambda: api.decompress_many([bz2.compress(A[:300], 1),
                                     bz2.compress(B[:200], 1)], "bzip2",
                                    device="cpu"),
        ["api.decompress_many", "bzip2.scan", "bzip2.slices", "bzip2.slices",
         "bzip2.h2d", "bzip2.walk", "bzip2.expand", "bzip2.sort",
         "bzip2.ibwt", "bzip2.fetch", "bzip2.eos", "bzip2.eos",
         "bzip2.rle1-inverse", "bzip2.eos", "bzip2.rle1-inverse"]),
}


@pytest.mark.parametrize("call", sorted(API_SPANS))
def test_api_calls_emit_their_codecs_spans_under_the_api_span(call):
    """gzip and bzip2 through api.compress_many / decompress_many (the
    decodes of streams the stdlib wrote): the documented spans, in order,
    each inside the api span; the outputs are right."""
    fn, want = API_SPANS[call]
    out, spans = _spans(fn)
    assert [s[0] for s in spans] == want
    _, t0, t1 = spans[0]
    assert all(t0 <= a <= b <= t1 for _, a, b in spans[1:])
    if "decode" in call:
        n = 300 if "bzip2" in call else len(A)
        assert out[0] == A[:n] and out[1] == B[:len(out[1])]
    else:
        read = bz2.decompress if "bzip2" in call else gzip.decompress
        assert [read(s) for s in out] == [A, B]


def test_stock_gzip_streams_of_a_call_decode_in_one_batch():
    """Four stock streams of a call: walked under one inflate.index span
    and decoded in one device batch for the call, where a stream at a
    time took a batch each."""
    blobs = [gzip.compress(corpus.text(500, seed=s)) for s in range(4)]
    out, spans = _spans(lambda: gzip_codec.decompress_many(blobs,
                                                           device="cpu"))
    assert out == [corpus.text(500, seed=s) for s in range(4)]
    names = [s[0] for s in spans]
    assert names.count("inflate.batch") == 1
    assert names.count("inflate.index") == 1
