"""The LZHUF device plan (tpz_torch/kernels/lzhuf_plan_device.py) held to
the C++ oracle's host planner (oracle.lzhuf_plan, cpp LzhufPlan) field
for field: c and p code lengths and codes, each block's body offset, each
buffer's total bits and its header bits, for lh4-lh7.

Histograms come from the oracle's LZSS tokens of each content class of
corpus.mixed (one block a 32 KiB parse block) and from tables built to
reach every form of the header: a lone literal, no matches, one distance
class, C lengths that leave zero runs of every kind of the run-length
form, a T table of one symbol, a short last block, and three buffers in
one group whose streams start word-aligned. The file imports no JAX, so
that the card test (test_torch_lzhuf_plan_card.py) reuses its checks
without tests/conftest.py."""

import numpy as np
import pytest
import torch

from tpz_torch import constants as C
from tpz_torch import oracle
from tpz_torch.kernels import bitpack
from tpz_torch.kernels import lzhuf_plan_device as lpd
from tpz_torch.utils import corpus

BLOCK = 32768
NC = C.LZHUF_NC
METHODS = ["lh4", "lh5", "lh6", "lh7"]


def token_hists(data: bytes, method: str):
    """(c_hist [nb, 510], p_hist [nb, np]) int32 of the oracle's LZSS
    tokens of data at the method's window, a block per 32 KiB."""
    dict_bits, np_ = C.LZHUF_METHODS[method]
    params = oracle.params_array(window=1 << dict_bits, max_match=256,
                                 max_chain=16, block_size=BLOCK)
    pos, ln, lit, dist = oracle.lzss_tokenize(data, params).T
    nb = -(-len(data) // BLOCK)
    blk = pos // BLOCK
    c = np.zeros((nb, NC), np.int32)
    np.add.at(c, (blk, np.where(ln == 0, lit, 256 + ln - 3)), 1)
    m = ln > 0
    v = dist[m] - 1
    psym = (v[:, None] >= (1 << np.arange(17))).sum(axis=1)
    p = np.zeros((nb, np_), np.int32)
    np.add.at(p, (blk[m], psym), 1)
    return c, p


def plan_on(c_hist, p_hist, nbs, np_, device):
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for a in (c_hist, p_hist, c_hist.sum(axis=1).astype(np.int32))]
    return lpd.plan(*t, nbs, np_)


def check_plan(bufs, method: str, device="cpu"):
    """bufs: one (c_hist, p_hist) pair of numpy arrays a buffer. Plans
    them as one group on `device` and holds every field to the oracle's
    plan of each buffer alone."""
    dict_bits, np_ = C.LZHUF_METHODS[method]
    nbs = [c.shape[0] for c, _ in bufs]
    c_all = np.concatenate([c for c, _ in bufs])
    p_all = np.concatenate([p for _, p in bufs])
    plan = plan_on(c_all, p_all, nbs, np_, device)
    total_words = int(plan.region_bits[-1] + plan.total_bits[-1] + 31) // 32
    head = bitpack.assemble_stream_msb(plan.head_vals, plan.head_bits,
                                       plan.head_off, total_words)
    head = head.cpu().numpy().astype(">u4").view(np.uint8)
    got = {k: getattr(plan, k).cpu().numpy()
           for k in ("c_len", "c_code", "p_len", "p_code", "body_off")}
    assert (plan.region_bits % 32 == 0).all()
    assert (plan.region_bits[1:] >= plan.region_bits[:-1]
            + plan.total_bits[:-1]).all()
    r0 = 0
    for k, ((c, p), nb) in enumerate(zip(bufs, nbs)):
        sl = slice(r0, r0 + nb)
        want = oracle.lzhuf_plan(c.astype(np.uint32), p.astype(np.uint32),
                                 c.sum(axis=1).astype(np.uint32), dict_bits)
        rb, tb = int(plan.region_bits[k]), int(plan.total_bits[k])
        for name in ("c_len", "c_code", "p_len", "p_code"):
            np.testing.assert_array_equal(got[name][sl], want[name],
                                          err_msg=f"buffer {k}: {name}")
        np.testing.assert_array_equal(got["body_off"][sl] - rb,
                                      want["body_off"],
                                      err_msg=f"buffer {k}: body_off")
        assert tb == want["total_bits"], f"buffer {k}: total bits"
        nbytes = (tb + 7) // 8
        np.testing.assert_array_equal(head[rb // 8:rb // 8 + nbytes],
                                      want["header"][:nbytes],
                                      err_msg=f"buffer {k}: header bits")
        r0 += nb
    return plan


def _one_block(c_counts: dict, p_counts: dict, np_: int):
    c = np.zeros((1, NC), np.int32)
    p = np.zeros((1, np_), np.int32)
    for s, n in c_counts.items():
        c[0, s] = n
    for s, n in p_counts.items():
        p[0, s] = n
    return c, p


def _runs_table(end_used: bool):
    """C symbols with zero runs of 1, 2, 3, 18, 19 and 20 between them,
    then a run up to symbol 509 (end_used) or trailing zeros to 510."""
    used, s = [], 0
    for run in (1, 2, 3, 18, 19, 20):
        used.append(s)
        s += run + 1
    used.append(s)
    if end_used:
        used.append(NC - 1)
    rng = np.random.default_rng(len(used))
    return {u: int(n) for u, n in zip(used, rng.integers(5, 400,
                                                         len(used)))}


def _fibonacci(n: int) -> list[int]:
    f = [1, 1]
    while len(f) < n:
        f.append(f[-1] + f[-2])
    return f[:n]


def hist_case(name: str, method: str):
    """The case's buffers as (c_hist, p_hist) pairs."""
    np_ = C.LZHUF_METHODS[method][1]
    if name in ("text", "source_code", "repetitive", "random_bytes",
                "skewed_bytes"):
        return [token_hists(getattr(corpus, name)(2 * BLOCK, seed=41),
                            method)]
    if name == "one_literal":
        return [_one_block({ord("a"): 3000}, {}, np_)]
    if name == "literals_only":
        rng = np.random.default_rng(7)
        return [_one_block({s: int(n) for s, n in
                            enumerate(rng.integers(0, 120, 256))}, {}, np_)]
    if name == "one_distance_class":
        return [_one_block({ord("a"): 40, ord("b"): 9, 256 + 5: 31},
                           {np_ - 2: 31}, np_)]
    if name == "zero_runs":
        c = [_one_block(_runs_table(e), {1: 3, 4: 9}, np_)
             for e in (True, False)]
        return [(np.concatenate([a for a, _ in c]),
                 np.concatenate([b for _, b in c]))]
    if name == "one_t_symbol":
        # Every length equal and no zero run: the T table has one symbol.
        c = [_one_block({s: 100 for s in range(256)}, {}, np_),
             _one_block({0: 7, 1: 7}, {}, np_)]
        return [(np.concatenate([a for a, _ in c]),
                 np.concatenate([b for _, b in c]))]
    if name == "long_codes":
        # Fibonacci counts: C and P codes at the 16-bit limit, long T and
        # P entries with their unary tails.
        fc = _fibonacci(21)
        fp = _fibonacci(np_)
        return [_one_block({3 * i: n for i, n in enumerate(fc)},
                           dict(enumerate(fp)), np_)]
    if name == "short_last_block":
        return [token_hists(corpus.mixed(BLOCK + 2_000, seed=43), method)]
    if name == "three_buffers":
        return [token_hists(corpus.mixed(n, seed=44 + n % 7), method)
                for n in (2 * BLOCK - 100, 5_000, 3 * BLOCK)]
    raise KeyError(name)


CASES = ["text", "source_code", "repetitive", "random_bytes",
         "skewed_bytes", "one_literal", "literals_only",
         "one_distance_class", "zero_runs", "one_t_symbol", "long_codes",
         "short_last_block", "three_buffers"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("method", METHODS)
def test_device_plan_equals_the_oracle(method, case):
    bufs = hist_case(case, method)
    plan = check_plan(bufs, method)
    if case == "three_buffers":
        assert [c.shape[0] for c, _ in bufs] == [2, 1, 3]
        assert len(plan.region_bits) == 3


def test_cases_reach_every_header_form():
    """The cases above reach the single-symbol forms of the C, T and P
    tables and both sides of each run-length branch."""
    np_ = C.LZHUF_METHODS["lh5"][1]
    seen = set()
    for case in CASES:
        for c, p in hist_case(case, "lh5"):
            plan = plan_on(c, p, [c.shape[0]], np_, "cpu")
            cused = (c > 0).sum(axis=1)
            pused = (p > 0).sum(axis=1)
            seen |= {f"cused{min(int(u), 2)}" for u in cused}
            seen |= {f"pused{min(int(u), 2)}" for u in pused}
            c_len = plan.c_len.numpy()
            for row in c_len[cused > 1]:
                n = np.flatnonzero(row).max() + 1
                z = np.concatenate([[0], (row[:n] == 0).astype(int), [0]])
                edges = np.flatnonzero(np.diff(z))
                for a, b in zip(edges[::2], edges[1::2]):
                    r = b - a
                    seen.add("run" + ("<=2" if r <= 2 else "3-18" if r <= 18
                                      else "19" if r == 19 else ">=20"))
                if len(set(row[:n])) == 1:
                    seen.add("tused1")
    assert seen >= {"cused1", "cused2", "pused0", "pused1", "pused2",
                    "run<=2", "run3-18", "run19", "run>=20", "tused1"}
