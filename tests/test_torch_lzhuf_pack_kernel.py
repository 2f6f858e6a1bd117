"""The LZHUF bit packer's CUDA kernel (csrc/lzhuf_pack.cu, launched by
lzhuf_pipeline.pack_words) against the plain version, pack_words_plain,
on the card: every word, for lh4-lh7, on hand-made rows (all literals;
all 256-byte matches at the method's largest distance, whose C and P
tables have one symbol each, the header's single-symbol forms; a run of
one literal; matches of every length and distance; a short last block;
rows whose first word shares bits with the row before) laid out by the
encode's own plan, on the lh5.archive cell's layout (2 x 16 MiB of
corpus.mixed through the real screen, parse and plan, 1,024 blocks), and
through lh4-lh7 encodes, whose bodies must equal the C++ oracle's, with
one launch a group. The CPU tests hold the wrapper's routing: a CPU
tensor takes the plain version, which equals the pack stage as it was
before the kernel (_stage2's words plus the header's assemble_stream_msb
words), and launches nothing; the encode's own inputs pass every check;
another device, dtype, shape, stride or row width raises. The file
imports no JAX, and needs none of tests/conftest.py (which imports JAX),
so that the card runs it without that file:

    python3 -m pytest --noconftest tests/test_torch_lzhuf_pack_kernel.py -q
"""

import numpy as np
import pytest
import torch

from tpz_torch import constants as C
from tpz_torch.kernels import bitpack
from tpz_torch.kernels import lzhuf_pipeline as lp
from tpz_torch.kernels import lzhuf_plan_device
from tpz_torch.utils import corpus
from tpz_torch.utils.bits import to_i32

B = lp.BLOCK
NC = lp.NC
METHODS = ["lh4", "lh5", "lh6", "lh7"]


def literals(n):
    return np.ones(n, bool), np.zeros(n, np.int32), np.zeros(n, np.int32)


def longest_matches(n, window):
    """A 256-byte match at distance `window` every 256 positions, none
    left over at n = BLOCK: one C symbol (509) and one P symbol."""
    tok, ml, md = literals(n)
    tok[:] = False
    starts = np.arange(0, n - 255, 256)
    tok[starts], ml[starts], md[starts] = True, 256, window
    tok[starts[-1] + 256:] = True
    return tok, ml, md


def random_matches(n, window, seed):
    """Matches of every length 3..256 at distances 1..window, between
    literals."""
    rng = np.random.default_rng(seed)
    tok, ml, md = literals(n)
    tok[:] = False
    p = 0
    while p < n:
        tok[p] = True
        if rng.random() < 0.6 and n - p >= 3:
            ml[p] = min(int(rng.integers(3, 257)), n - p)
            md[p] = int(rng.integers(1, window + 1))
            p += int(ml[p])
        else:
            p += 1
    return tok, ml, md


def rows(window):
    """name -> (bytes, (is_token, mlen, mdist)) of the hand-made rows."""
    text = corpus.text(B, seed=1)
    src = corpus.source_code(B, seed=3)
    short = corpus.mixed(7232, seed=5)
    return {
        "literals": (text, literals(B)),
        "longest_matches": (text, longest_matches(B, window)),
        "one_literal": (b"a" * 5000, literals(5000)),
        "every_match": (src, random_matches(B, window, seed=4)),
        "short_last": (short, random_matches(len(short), window, seed=6)),
    }


# Two buffers of rows in one group: each row's first word shares bits
# with the row before; the first buffer's last row is short.
BATCH = (("literals", "longest_matches", "every_match", "short_last"),
         ("one_literal", "every_match"))
CASES = ["batch", "literals", "longest_matches", "one_literal",
         "every_match", "short_last"]


def pack_args(case, method):
    """pack_words's arguments on the CPU for a case (the batch, or one row
    as a buffer of its own) at `method`, the plan made from the rows'
    histograms as the encode's hist and plan stages make it."""
    dict_bits, np_ = C.LZHUF_METHODS[method]
    window = 1 << dict_bits
    table = rows(window)
    buffers = BATCH if case == "batch" else ((case,),)
    names = [n for buf in buffers for n in buf]
    NB = len(names)
    blocks = np.zeros((NB, window + B + lp.FWD), np.uint8)
    tok = np.zeros((NB, B), bool)
    ml = np.zeros((NB, B), np.int32)
    md = np.zeros((NB, B), np.int32)
    for r, name in enumerate(names):
        data, (t, l, d) = table[name]
        n = len(data)
        blocks[r, window:window + n] = np.frombuffer(data, np.uint8)
        tok[r, :n], ml[r, :n], md[r, :n] = t, l, d
    blocks, tok, ml, md = (torch.from_numpy(a) for a in (blocks, tok, ml, md))
    # _stage1's hist stage.
    db = blocks[:, window:window + B].to(torch.int32)
    is_match = tok & (ml > 0)
    csym = torch.where(is_match, 256 + ml - 3, db)
    psym = lp._bitlen16(torch.clamp(md, min=1) - 1)
    c_hist = lp._hist(torch.where(tok, torch.clamp(csym, 0, NC - 1), NC), NC)
    p_hist = lp._hist(torch.where(is_match, torch.clamp(psym, 0, np_ - 1),
                                  np_), np_)
    ntokens = tok.sum(dim=1, dtype=torch.int32)
    plan = lzhuf_plan_device.plan(c_hist, p_hist, ntokens,
                                  [len(buf) for buf in buffers], np_)
    total_words = max(1, -(-int(plan.region_bits[-1] + plan.total_bits[-1])
                           // 32))
    return blocks, window, tok, ml, md, plan, total_words


def plan_to(plan, device):
    return plan._replace(**{k: v.to(device) for k, v in plan._asdict().items()
                            if isinstance(v, torch.Tensor)})


def to(args, device):
    return tuple(plan_to(a, device) if isinstance(a, lzhuf_plan_device.Plan)
                 else a.to(device) if isinstance(a, torch.Tensor) else a
                 for a in args)


def stage_words(args):
    """The pack stage's words as the encode made them before the kernel:
    _stage2's body words plus the header's assemble_stream_msb words."""
    blocks, window, tok, ml, md, plan, total_words = args
    words = lp._stage2(blocks[:, window:window + B].to(torch.int32), tok, ml,
                       md, plan.c_len, plan.c_code, plan.p_len, plan.p_code,
                       plan.body_off, total_words)
    words += bitpack.assemble_stream_msb(plan.head_vals, plan.head_bits,
                                         plan.head_off, total_words)
    return to_i32(words)


def assert_words_equal(got, want):
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want), (
        f"{int((got != want).sum())} of {want.numel()} words differ, the "
        f"first at {int(torch.nonzero(got != want)[0])}")


# ------------------------------------------------------------- the CPU


def test_the_batch_covers_every_row_kind():
    """One-symbol C and P tables, a P table with no symbol, a short row,
    and rows whose header starts inside a word."""
    blocks, window, tok, ml, md, plan, _ = pack_args("batch", "lh5")
    names = [n for buf in BATCH for n in buf]
    c_used = (plan.c_len > 0).sum(dim=1)
    p_used = (plan.p_len > 0).sum(dim=1)
    lm, one = names.index("longest_matches"), names.index("one_literal")
    assert int(c_used[lm]) == 0 and int(p_used[lm]) == 0
    assert int(c_used[one]) == 0 and int(p_used[one]) == 0
    assert int(tok[one].sum()) == 5000 and int((ml[one] > 0).sum()) == 0
    assert int(tok[names.index("short_last")].sum()) < 7232
    assert int((plan.head_off % 32 != 0).sum()) >= 3
    assert int(ml.max()) == 256 and int(md.max()) == window


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", CASES)
def test_cpu_tensors_take_the_plain_packer_hand_made_rows(case, method):
    args = pack_args(case, method)
    before = lp.pack_words.launches
    got = lp.pack_words(*args)
    assert lp.pack_words.launches == before
    assert_words_equal(got, stage_words(args))


def encode_args(datas, method, monkeypatch):
    """pack_words's arguments of one CPU encode of `datas`, and its
    bodies."""
    pack = lp.pack_words
    seen = []
    monkeypatch.setattr(lp, "pack_words",
                        lambda *a: seen.append(a) or pack(*a))
    bodies = lp.compress_many(datas, method, "cpu")
    monkeypatch.setattr(lp, "pack_words", pack)
    (args,) = seen
    return args, bodies


@pytest.mark.parametrize("method", METHODS)
def test_cpu_route_equals_the_pack_stage_in_an_encode(method, monkeypatch):
    """On small corpus.mixed buffers (a short last block, two buffers in
    one group) the CPU route's words equal the stage's words as they were
    before the kernel, and it launches nothing."""
    from tpz_torch import oracle

    datas = [corpus.mixed(40_000, seed=7), corpus.mixed(9_000, seed=8)]
    before = lp.pack_words.launches
    args, bodies = encode_args(datas, method, monkeypatch)
    assert lp.pack_words.launches == before
    assert args[2].shape == (3, B)
    assert_words_equal(lp.pack_words(*args), stage_words(args))
    dict_bits = C.LZHUF_METHODS[method][0]
    assert bodies == [oracle.lzhuf_encode(d, dict_bits, lp.MAX_CHAIN)
                      for d in datas]


def meta(args, **swap):
    """args on the meta device, with the named tensors (of the plan too)
    replaced."""
    blocks, window, tok, ml, md, plan, total_words = to(args, "meta")
    top = dict(blocks=blocks, is_token=tok, mlen=ml, mdist=md)
    top.update({k: v for k, v in swap.items() if k in top})
    plan = plan._replace(**{k: v for k, v in swap.items() if k not in top})
    return (top["blocks"], window, top["is_token"], top["mlen"],
            top["mdist"], plan, total_words)


@pytest.fixture(scope="module")
def batch_args():
    return pack_args("batch", "lh5")


def test_the_encodes_own_inputs_pass_the_checks(monkeypatch):
    """The pack stage's real inputs (a CPU encode's, on the meta device)
    pass every check: only the device is refused."""
    args, _ = encode_args([corpus.mixed(3000, seed=9)], "lh5", monkeypatch)
    before = lp.pack_words.launches
    with pytest.raises(ValueError, match="unsupported device meta"):
        lp.pack_words(*meta(args))
    assert lp.pack_words.launches == before


def empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("name,bad,match", [
    ("is_token", lambda nb: empty((nb, 4096), torch.bool), "rows of 4096"),
    ("blocks", lambda nb: empty((nb, 8192 + 4096), torch.uint8),
     "hold no 32768 positions"),
    ("blocks", lambda nb: empty((nb, 8192 + 32768 + 512), torch.int32),
     "blocks"),
    ("is_token", lambda nb: empty((nb, B), torch.uint8), "is_token"),
    ("mlen", lambda nb: empty((nb, B), torch.int64), "mlen"),
    ("mdist", lambda nb: empty((B, nb), torch.int32).t(), "mdist"),
    ("mdist", lambda nb: torch.empty((nb, B), dtype=torch.int32), "mdist"),
    ("head_vals", lambda nb: empty((nb, 1058), torch.int32), "head_vals"),
    ("head_bits", lambda nb: empty((nb, 1057), torch.int32), "head_bits"),
    ("body_off", lambda nb: empty((nb,), torch.int32), "body_off"),
    ("c_len", lambda nb: empty((nb, NC - 1), torch.int32), "c_len"),
    ("p_code", lambda nb: empty((nb, 20), torch.int64), "p_code"),
])
def test_a_wrong_input_raises(batch_args, name, bad, match):
    """A wrong dtype, shape, stride, device (mdist on the CPU beside meta
    tensors) or row width raises before any launch."""
    before = lp.pack_words.launches
    with pytest.raises(ValueError, match=match):
        lp.pack_words(*meta(batch_args, **{name: bad(6)}))
    assert lp.pack_words.launches == before


# ------------------------------------------------------------ the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return "cuda"


@pytest.mark.card
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", CASES)
def test_kernel_equals_plain_hand_made_rows(card, case, method):
    args = pack_args(case, method)
    want = lp.pack_words_plain(*args)
    dev_args = to(args, card)
    before = lp.pack_words.launches
    got = lp.pack_words(*dev_args)
    torch.cuda.synchronize()
    assert lp.pack_words.launches == before + 1
    assert_words_equal(got.cpu(), want)
    # Every word is stored or ORed: a second launch leaves them as they
    # were.
    plan = dev_args[5]
    lp._pack_launch(*dev_args[:5], lp.joint_table(plan), plan, got)
    assert_words_equal(got.cpu(), want)


@pytest.mark.card
def test_a_wrong_input_raises_on_the_card(card, batch_args):
    blocks, window, tok, ml, md, plan, total_words = to(batch_args, card)
    before = lp.pack_words.launches
    with pytest.raises(ValueError, match="mdist"):
        lp.pack_words(blocks, window, tok, ml, md.t().contiguous().t(), plan,
                      total_words)
    with pytest.raises(ValueError, match="rows of"):
        lp.pack_words(blocks, window, tok[:, :4096].contiguous(), ml, md,
                      plan, total_words)
    with pytest.raises(ValueError, match="is_token"):
        lp.pack_words(blocks, window, tok.cpu(), ml, md, plan, total_words)
    assert lp.pack_words.launches == before


@pytest.fixture(scope="module")
def headline(card):
    """The lh5.archive cell's request: 2 x 16 MiB of corpus.mixed (the
    headline seeds of chip_smoke.py)."""
    return corpus.make_corpus([(16 << 20, 1000), (16 << 20, 1001)])


def spy_launches(monkeypatch):
    launch = lp._pack_launch
    seen = []

    def spy(*args):
        launch(*args)
        seen.append(args)

    monkeypatch.setattr(lp, "_pack_launch", spy)
    return seen


@pytest.mark.card
def test_kernel_equals_plain_cell_layout(card, headline, monkeypatch):
    """Through the real screen, parse and plan at lh5: the kernel's words
    equal the plain packer's on the same inputs, one launch for the
    group's 1,024 blocks, and the bodies equal the C++ oracle's."""
    from tpz_torch import oracle

    seen = spy_launches(monkeypatch)
    before = lp.pack_words.launches
    bodies = lp.compress_many(headline, "lh5", card)
    assert lp.pack_words.launches == before + 1 and len(seen) == 1
    (blocks, window, tok, ml, md, _, plan, got), = seen
    assert tok.shape == (1024, B)
    assert_words_equal(got, lp.pack_words_plain(
        blocks, window, tok, ml, md, plan, got.numel()))
    del seen, blocks, tok, ml, md, plan, got
    assert bodies == [oracle.lzhuf_encode(d, 13, lp.MAX_CHAIN)
                      for d in headline]


@pytest.mark.card
@pytest.mark.parametrize("method", METHODS)
def test_the_encode_on_the_card_runs_the_kernel(card, method, monkeypatch):
    """lh4-lh7 encodes on the card pack through the kernel, one launch a
    group (three buffers in two groups), and their bodies equal the C++
    oracle's."""
    from tpz_torch import oracle

    datas = [corpus.mixed(300_000, seed=5), corpus.text(70_000, seed=6),
             corpus.random_bytes(100_000, seed=7)]
    monkeypatch.setattr(lp, "MAX_DEVICE_SPAN", 400_000)
    before = lp.pack_words.launches
    bodies = lp.compress_many(datas, method, card)
    assert lp.pack_words.launches == before + 2
    dict_bits = C.LZHUF_METHODS[method][0]
    assert bodies == [oracle.lzhuf_encode(d, dict_bits, lp.MAX_CHAIN)
                      for d in datas]
