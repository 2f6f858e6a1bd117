"""The LZHUF device plan (tpz_torch/kernels/lzhuf_plan_device.py) on the
card, held field for field to the oracle's host planner
(oracle.lzhuf_plan) at the lh5.archive cell's shape: 2 x 16 MiB of
corpus.mixed in one group, 1,024 blocks, histograms from the pipeline's
own _stage1 on the card; and on one lh7 buffer. Then lh4-lh7 encodes on
the card, with the host planner made to raise, byte-equal to the
oracle's encoder. The file imports no JAX, and needs none of
tests/conftest.py (which imports JAX), so that the card runs it without
that file:

    python3 -m pytest --noconftest tests/test_torch_lzhuf_plan_card.py -q
"""

import numpy as np
import pytest
import torch
from test_torch_lzhuf_plan import check_plan

from tpz_torch import constants as C
from tpz_torch import oracle
from tpz_torch.kernels import lzhuf_pipeline as lp
from tpz_torch.utils import corpus


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return "cuda"


@pytest.fixture(scope="module")
def cell_objects():
    """The cell's request: two 16 MiB objects of corpus.mixed."""
    return corpus.make_corpus([(16 << 20, 101), (16 << 20, 102)])


def stage1_hists(datas, method, device):
    """One (c_hist, p_hist) numpy pair a buffer, from the pipeline's
    blocks and _stage1 on `device`."""
    dict_bits, np_ = C.LZHUF_METHODS[method]
    window = 1 << dict_bits
    blocks, span_off, span_len, block_len, nbs = lp.make_blocks(
        datas, window, device)

    def dev(a):
        return torch.from_numpy(a).to(device)

    *_, c_hist, p_hist, _ = lp._stage1(
        blocks, dev(span_off), dev(span_len), dev(block_len), lp.MAX_CHAIN,
        window, np_)
    c, p = c_hist.cpu().numpy(), p_hist.cpu().numpy()
    cut = np.cumsum(nbs)[:-1]
    return list(zip(np.split(c, cut), np.split(p, cut)))


@pytest.mark.card
def test_plan_at_the_cell_shape(card, cell_objects):
    bufs = stage1_hists(cell_objects, "lh5", card)
    assert [c.shape[0] for c, _ in bufs] == [512, 512]
    plan = check_plan(bufs, "lh5", card)
    assert plan.c_len.device.type == "cuda"


@pytest.mark.card
def test_plan_of_one_lh7_buffer(card):
    data = corpus.mixed(1 << 20, seed=103)
    check_plan(stage1_hists([data], "lh7", card), "lh7", card)


@pytest.mark.card
@pytest.mark.parametrize("method", ["lh4", "lh5", "lh6", "lh7"])
def test_encode_on_the_card_equals_the_oracle(card, cell_objects, method,
                                              monkeypatch):
    def host_plan(*args, **kwargs):
        raise AssertionError("the encode called the host planner")

    monkeypatch.setattr(oracle, "lzhuf_plan", host_plan)
    datas = (list(cell_objects) if method == "lh5"
             else [cell_objects[0][:3 << 20], corpus.text(70_001, seed=104)])
    bits = C.LZHUF_METHODS[method][0]
    before = lp.device_plans
    bodies = lp.compress_many(datas, method, device=card)
    assert lp.device_plans == before + 1
    for k, (d, body) in enumerate(zip(datas, bodies)):
        assert body == oracle.lzhuf_encode(d, bits, 16), f"buffer {k}"
