"""The DEFLATE bit packer's CUDA kernel (csrc/deflate_pack.cu, launched by
bitpack.pack_deflate) against the plain version, assemble_stream_v2, on
the card: every word, on hand-made rows (all literals; all 258-byte
matches at distance 32,768; matches of every length and distance; a
stored row of 65,536 bytes, whose second chunk sits past its own header;
a short stored row; a fixed-Huffman row; a padding row; rows whose first
word shares bits with the row before or its header) laid out by the
encode's own plan stage, and at the gzip6.archive cell's layout (2 x 16
MiB of corpus.mixed through the real screen, parse and plan) at levels 1,
6 and 9, where the encode's bytes must also equal the C++ oracle's. The
CPU tests hold the wrapper's routing: a CPU tensor takes the plain
version and launches nothing; a device other than the CPU and CUDA, rows
of another width, a table of another shape or a tensor of another dtype
raises. The file imports no JAX, and needs none of tests/conftest.py
(which imports JAX), so that the card runs it without that file:

    python3 -m pytest --noconftest tests/test_torch_bitpack_kernel.py -q
"""

import numpy as np
import pytest
import torch

from tpz_torch.kernels import bitpack
from tpz_torch.kernels import deflate_pipeline as dp
from tpz_torch.kernels.deflate_plan_device import plan_device, plan_tables
from tpz_torch.utils import corpus

B = dp.BLOCK


def literals(data):
    n = len(data)
    return np.ones(n, bool), np.zeros(n, np.int32), np.zeros(n, np.int32)


def longest_matches(n):
    """A token every 258 positions, each a 258-byte match at distance
    32,768; literals for the positions past the last whole match."""
    tok, ml, md = literals(bytes(n))
    tok[:] = False
    starts = np.arange(0, n - 257, 258)
    tok[starts], ml[starts], md[starts] = True, 258, 32768
    tok[starts[-1] + 258:] = True
    return tok, ml, md


def random_matches(n, seed):
    """Matches of every length 3..258 at distances 1..32,768, between
    literals."""
    rng = np.random.default_rng(seed)
    tok, ml, md = literals(bytes(n))
    tok[:] = False
    p = 0
    while p < n:
        tok[p] = True
        if rng.random() < 0.6 and n - p >= 3:
            ml[p] = min(int(rng.integers(3, 259)), n - p)
            md[p] = int(rng.integers(1, 32769))
            p += int(ml[p])
        else:
            p += 1
    return tok, ml, md


def rows():
    """name -> (bytes, (is_token, mlen, mdist)) of the hand-made rows."""
    text = corpus.text(B, seed=1)
    src = corpus.source_code(40_000, seed=3)
    return {
        "literals": (text, literals(text)),
        "longest_matches": (text, longest_matches(B)),
        "padding": (b"", literals(b"")),
        "stored_two_chunks": (corpus.random_bytes(B, seed=2),
                              literals(bytes(B))),
        "fixed": (b"hello world", literals(b"hello world")),
        "every_match": (src, random_matches(len(src), seed=4)),
        "stored_short": (corpus.random_bytes(1000, seed=5),
                         literals(bytes(1000))),
    }


# Two buffers: each row's first word shares bits with the row before (or
# with its own header); a padding row between two rows of the first.
BATCH = (("literals", "longest_matches", "padding", "stored_two_chunks"),
         ("fixed", "every_match", "stored_short"))
CASES = ["batch", *rows()]


def pack_args(case):
    """pack_deflate's arguments on the CPU for a case (the batch, or one
    row as a buffer of its own), made as _fused_encode's plan stage makes
    them; and the plan."""
    table = rows()
    buffers = BATCH if case == "batch" else ((case,),)
    names = [n for buf in buffers for n in buf]
    NB = len(names)
    data_block = np.zeros((NB, B), np.int32)
    is_token = np.zeros((NB, B), bool)
    mlen = np.zeros((NB, B), np.int32)
    mdist = np.zeros((NB, B), np.int32)
    block_len = np.zeros(NB, np.int32)
    for r, name in enumerate(names):
        data, (tok, ml, md) = table[name]
        n = len(data)
        data_block[r, :n] = np.frombuffer(data, np.uint8)
        is_token[r, :n], mlen[r, :n], mdist[r, :n] = tok, ml, md
        block_len[r] = n
    buf_start = np.zeros(NB, bool)
    bfinal = np.zeros(NB, bool)
    r = 0
    for buf in buffers:
        buf_start[r] = True
        r += len(buf)
        bfinal[r - 1] = True
    db, tok, ml, md, bl = (torch.from_numpy(a) for a in
                           (data_block, is_token, mlen, mdist, block_len))
    is_match = tok & (ml > 0)
    lsym, _, _ = bitpack.length_symbol(torch.clamp(ml, 0, 258))
    dsym, _, _ = bitpack.dist_symbol(torch.clamp(md, min=1))
    lit_sym = torch.where(is_match, lsym, db)
    lit_hist = dp._hist(torch.where(tok, torch.clamp(lit_sym, 0, 287), 288),
                        288)
    dist_hist = dp._hist(torch.where(is_match, torch.clamp(dsym, 0, 29), 30),
                         30)
    tables = {k: torch.from_numpy(v) for k, v in plan_tables().items()}
    plan = plan_device(lit_hist, dist_hist, bl, torch.from_numpy(buf_start),
                       torch.from_numpy(bfinal), tables, live=bl > 0)
    table320 = torch.cat([plan["lit_cl"], plan["dist_cl"],
                          torch.zeros((NB, 2), dtype=torch.int32)], dim=1)
    total_words = (int(plan["end_pos"][-1]) + 31) // 32
    args = (db, tok, ml, md, table320, plan["body_off"], plan["btype"], bl,
            plan["chunk1_off"],
            (plan["hdr_vals"], plan["hdr_nbits"], plan["hdr_offs"]),
            total_words)
    return args, plan


def to(args, device):
    return tuple(to(a, device) if isinstance(a, tuple)
                 else a.to(device) if isinstance(a, torch.Tensor) else a
                 for a in args)


def plain_words(args):
    return bitpack.to_i32(bitpack.assemble_stream_v2(*args))


def assert_words_equal(got, want):
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want), (
        f"{int((got != want).sum())} of {want.numel()} words differ, the "
        f"first at {int(torch.nonzero(got != want)[0])}")


# ------------------------------------------------------------- the CPU


def test_the_batch_covers_every_row_kind():
    """The batch holds stored (one with a second chunk), fixed and dynamic
    rows and a padding row, and rows whose body starts inside a word."""
    (_, _, _, _, _, body_off, btype, bl, chunk1_off, _, _), _ = pack_args(
        "batch")
    assert set(btype.tolist()) == {0, 1, 2}
    assert int((chunk1_off > 0).sum()) == 1
    assert int((bl == 0).sum()) == 1
    assert int((body_off % 32 != 0).sum()) >= 4


@pytest.mark.parametrize("case", CASES)
def test_cpu_tensors_take_the_plain_packer(case):
    args, _ = pack_args(case)
    before = bitpack.pack_deflate.launches
    got = bitpack.pack_deflate(*args)
    assert bitpack.pack_deflate.launches == before
    assert_words_equal(got, plain_words(args))


def meta(args, **swap):
    """args on the meta device, with the named tensors replaced."""
    names = ("data_block", "is_token", "mlen", "mdist", "table320",
             "body_off", "btype", "block_len", "chunk1_off")
    out = [swap.get(n, a.to("meta")) for n, a in zip(names, args)]
    hv, hn, ho = (h.to("meta") for h in args[9])
    return (*out, (swap.get("hdr_vals", hv), hn, ho), args[10])


@pytest.fixture(scope="module")
def batch_args():
    return pack_args("batch")[0]


def test_the_encodes_own_inputs_pass_the_checks(monkeypatch):
    """The bitpack stage's real inputs (a CPU encode's, on the meta
    device) pass every check: only the device is refused."""
    from tpz_torch.codecs.deflate import DeflateConfig

    pack = bitpack.pack_deflate
    seen = []
    monkeypatch.setattr(bitpack, "pack_deflate",
                        lambda *a: seen.append(a) or pack(*a))
    dp.compress_many([corpus.mixed(3000, seed=8)], DeflateConfig(level=6),
                     "cpu")
    (args,) = seen
    before = pack.launches
    with pytest.raises(ValueError, match="unsupported device meta"):
        pack(*meta(args))
    assert pack.launches == before


@pytest.mark.parametrize("name,bad,match", [
    ("data_block", lambda t: torch.empty((t.shape[0], 32768),
                                         dtype=torch.int32, device="meta"),
     "rows of 32768"),
    ("table320", lambda t: torch.empty((t.shape[0], 318), dtype=torch.int32,
                                       device="meta"), "table320"),
    ("mlen", lambda t: torch.empty(t.shape, dtype=torch.int64,
                                   device="meta"), "mlen"),
    ("is_token", lambda t: torch.empty(t.shape, dtype=torch.uint8,
                                       device="meta"), "is_token"),
    ("hdr_vals", lambda t: torch.empty(t.shape, dtype=torch.int32,
                                       device="meta"), "hdr_vals"),
    ("mdist", lambda t: torch.empty(t.shape[::-1], dtype=torch.int32,
                                    device="meta").t(), "mdist"),
])
def test_a_wrong_input_raises(batch_args, name, bad, match):
    src = batch_args[9][0] if name == "hdr_vals" else dict(zip(
        ("data_block", "is_token", "mlen", "mdist", "table320"),
        batch_args))[name]
    with pytest.raises(ValueError, match=match):
        bitpack.pack_deflate(*meta(batch_args, **{name: bad(src)}))


# ------------------------------------------------------------ the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return "cuda"


@pytest.mark.card
@pytest.mark.parametrize("case", CASES)
def test_kernel_equals_plain_hand_made_rows(card, case):
    args, _ = pack_args(case)
    want = plain_words(args)
    dev_args = to(args, card)
    before = bitpack.pack_deflate.launches
    got = bitpack.pack_deflate(*dev_args)
    torch.cuda.synchronize()
    assert bitpack.pack_deflate.launches == before + 1
    assert_words_equal(got.cpu(), want)
    # Every word is stored or ORed: a second launch leaves them as they
    # were.
    bitpack._pack_launch(*dev_args[:10], got)
    assert_words_equal(got.cpu(), want)


@pytest.mark.card
def test_a_wrong_input_raises_on_the_card(card, batch_args):
    args = to(batch_args, card)
    before = bitpack.pack_deflate.launches
    with pytest.raises(ValueError, match="mdist"):
        bitpack.pack_deflate(*args[:3], args[3].t().contiguous().t(),
                             *args[4:])
    with pytest.raises(ValueError, match="rows of"):
        bitpack.pack_deflate(args[0][:, :4096].contiguous(), *args[1:])
    assert bitpack.pack_deflate.launches == before


@pytest.fixture(scope="module")
def headline(card):
    """The gzip6.archive cell's request: 2 x 16 MiB of corpus.mixed (the
    headline seeds of chip_smoke.py)."""
    from tpz_torch.utils.corpus import make_corpus

    return make_corpus([(16 << 20, 1000), (16 << 20, 1001)])


@pytest.mark.card
@pytest.mark.parametrize("level", [1, 6, 9])
def test_kernel_equals_plain_cell_layout(card, headline, level,
                                         monkeypatch):
    """Through the real screen, parse and plan: the kernel's words equal
    the plain packer's on the same inputs, one launch an encode, and the
    streams equal the C++ oracle's."""
    from tpz_torch import oracle
    from tpz_torch.codecs.deflate import DeflateConfig

    launch = bitpack._pack_launch
    seen = []

    def spy(*args):
        launch(*args)
        seen.append(args)

    monkeypatch.setattr(bitpack, "_pack_launch", spy)
    cfg = DeflateConfig(level=level)
    before = bitpack.pack_deflate.launches
    bodies = dp.compress_many(headline, cfg, card)
    assert bitpack.pack_deflate.launches == before + 1 and len(seen) == 1
    (*args, got), = seen
    assert args[0].shape == (512, B)
    assert_words_equal(got, plain_words((*args, got.numel())))
    del seen, args, got
    assert bodies == oracle.deflate_encode_many(headline,
                                                cfg.params_array())


@pytest.mark.card
@pytest.mark.parametrize("level", [1, 6, 9])
def test_the_encode_on_the_card_runs_the_kernel(card, level):
    """A DEFLATE encode on the card packs through the kernel, one launch
    an encode, and its streams equal the C++ oracle's."""
    from tpz_torch import oracle
    from tpz_torch.codecs.deflate import DeflateConfig

    datas = [corpus.mixed(300_000, seed=5), corpus.text(70_000, seed=6),
             corpus.random_bytes(100_000, seed=7)]
    cfg = DeflateConfig(level=level)
    before = bitpack.pack_deflate.launches
    bodies = dp.compress_many(datas, cfg, card)
    assert bitpack.pack_deflate.launches == before + 1
    assert bodies == oracle.deflate_encode_many(datas, cfg.params_array())
